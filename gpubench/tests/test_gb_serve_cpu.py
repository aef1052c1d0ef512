"""A whole serving run of a tiny cell on the CPU: the closed loop through
``LLMServer``, the window's metrics, the comparison with the reference,
and the faults the comparison has to catch."""

from __future__ import annotations

import time

import pytest
import torch

from gpubench import check, run

SECONDS = 2.0


def _run(root, cell, **kw):
    c = run.load_cell(cell, root)
    res = run.run_cell(c, 2**31 + 12345, SECONDS, False,
                       torch.device("cpu"), time.perf_counter(), **kw)
    return c, res


@pytest.mark.parametrize("cell", ["tiny.serve", "tiny_moe.serve"])
def test_serve_cell_is_correct_and_reports(tiny_root, cell):
    c, res = _run(tiny_root, cell)
    out = res["out"]
    assert check.verdict(out["checks"]), out["checks"]
    names = {m["name"] for m in c.end_to_end}
    assert {"output_tokens_per_s", "tpot_p90_ms", "setup_s"} <= names
    for name in names:
        assert res["metrics"][name]["value"] > 0, name
    assert out["attempted"] > 0 and out["failed"] == 0
    # the readers that need no trace read the window's steps
    for name in ("serve.outside_step_ms", "engine.decode_rows_mean",
                 "mfu.serve"):
        assert run.reader(c, name).read(out["records"]) > 0, name
    for name in ("paged_decode_roofline", "flash_fwd_roofline",
                 "idle_share.serve"):
        assert run.reader(c, name).read(out["records"]) is None, name


def _over(checks, name):
    """The check ``name`` is over its limit."""
    return checks[name]["value"] > checks[name]["limit"]


def test_control_fails(tiny_root):
    """The program with its int8 weights (the dense cell's control) and
    the reference in fp8 (the mixture's) come out as not correct, by the
    mean gap that the cells compare."""
    for cell, name in (("tiny.serve", "mean_logit_gap"),
                       ("tiny_moe.serve", "control_mean_logit_gap")):
        c = run.load_cell(cell, tiny_root)
        _, res = _run(tiny_root, cell, control=c.workload["control"])
        checks = res["out"]["checks"]
        assert not check.verdict(checks), cell
        assert _over(checks, name), (cell, checks)


def _alter_tokens(monkeypatch):
    """A token altered where the decode burst produces it."""
    import ray_tpu_torch.llm.engine as eng

    inner = eng.decode_burst

    def burst(*a, **kw):
        toks, k, v = inner(*a, **kw)
        return (toks + 1) % a[0]["embed"].shape[0], k, v

    monkeypatch.setattr(eng, "decode_burst", burst)


def _state_unchanged(monkeypatch):
    """A decode burst that leaves the KV cache as it found it."""
    import ray_tpu_torch.llm.engine as eng

    inner = eng.decode_burst

    def burst(params, cache_k, cache_v, *a, **kw):
        toks, _, _ = inner(params, cache_k.clone(), cache_v.clone(), *a,
                           **kw)
        return toks, cache_k, cache_v

    monkeypatch.setattr(eng, "decode_burst", burst)


@pytest.mark.parametrize("fault", [_alter_tokens, _state_unchanged])
@pytest.mark.parametrize("cell", ["tiny.serve", "tiny_moe.serve"])
def test_faults_fail(tiny_root, monkeypatch, fault, cell):
    fault(monkeypatch)
    _, res = _run(tiny_root, cell)
    checks = res["out"]["checks"]
    assert not check.verdict(checks)
    # the statistic the cells compare catches it, not only a side check
    assert _over(checks, "mean_logit_gap"), checks
