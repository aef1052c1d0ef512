"""The four-rank multi-device plane on the CPU: the rank-to-card binding
of ``init_torch_distributed``, and the rank bodies of ``chip_smoke.py``'s
``parallel4`` phase (which runs them over NCCL on four cards) run here
over 4 gloo ranks at a tiny size, each against the same work unsharded.

The binding is shown with ``torch.cuda``'s device calls and
``init_process_group`` patched: four threads play four ranks of one
gang, rendezvousing over a real TCP store. The bodies run in 4 spawned
processes (``chip_smoke.p4_run``, one gang a group of jobs); the expected
values come from numpy (collectives), from the same function without a
mesh, and from ``ray_tpu``'s sharded forward and step under the same
``MeshSpec`` on four of ``cpu_mesh8``'s devices (the layouts and the
train body). Tolerances are the gloo tests' own (``chip_smoke.P4_*``).
"""

import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402

from ray_tpu_torch.train import init_torch_distributed  # noqa: E402
from ray_tpu_torch.train import worker_group as wg  # noqa: E402

# six xdist workers share the machine's cores
torch.set_num_threads(2)


# --- the binding -----------------------------------------------------------

def _gang(monkeypatch, world, cards, hosts):
    """``world`` threads calling init_torch_distributed on a patched card
    machine with ``cards`` cards, rank r on host ``hosts[r]``: per rank,
    the card it set and init_process_group's arguments, or the error."""
    made, bound, errors = {}, {}, {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: bound.__setitem__(_rank(), d))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: made.__setitem__(_rank(), (a, kw)))
    monkeypatch.setattr(wg, "socket", types.SimpleNamespace(
        gethostname=lambda: hosts[_rank()]))
    address = f"127.0.0.1:{cs.p4_free_port()}"

    def run(rank):
        ctx = types.SimpleNamespace(coordinator_address=address,
                                    world_size=world, rank=rank)
        try:
            init_torch_distributed(ctx, timeout_s=30)
        except Exception as e:
            errors[rank] = e

    threads = [threading.Thread(target=run, args=(r,), name=f"rank{r}")
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    return made, bound, errors


def _rank():
    return int(threading.current_thread().name[len("rank"):])


@pytest.mark.parametrize("hosts,cards", [
    (("a",) * 4, 4), (("a", "a", "b", "b"), 2), (("a", "b", "a", "b"), 8)],
    ids=["one_host", "two_hosts", "interleaved"])
def test_each_rank_takes_its_local_rank_s_card(monkeypatch, hosts, cards):
    made, bound, errors = _gang(monkeypatch, 4, cards, hosts)
    assert not errors
    # a rank's card is its index among its host's ranks
    want = {r: hosts[:r].count(hosts[r]) for r in range(4)}
    assert bound == want
    for r, (args, kw) in made.items():
        assert args == ("nccl",)
        assert kw["rank"] == r and kw["world_size"] == 4
        assert kw["device_id"] == torch.device("cuda", want[r])


def test_more_ranks_than_cards_on_a_host_raises(monkeypatch):
    made, bound, errors = _gang(monkeypatch, 4, 2, ("a",) * 4)
    assert sorted(errors) == [0, 1, 2, 3] and not made and not bound
    for e in errors.values():
        assert isinstance(e, RuntimeError)
        assert "4 ranks" in str(e) and "2 CUDA cards" in str(e)


def test_an_inherited_local_rank_does_not_choose_the_card(monkeypatch):
    """The store's host names are the only source of the local rank: two
    ranks of one host that inherit one LOCAL_RANK still take two cards."""
    monkeypatch.setenv("LOCAL_RANK", "1")
    _, bound, errors = _gang(monkeypatch, 2, 2, ("a", "a"))
    assert not errors and bound == {0: 0, 1: 1}


def test_local_placement_counts_in_rank_order():
    hosts = ["x", "y", "x", "x", "y"]
    assert [wg.local_placement(hosts, r) for r in range(5)] == [
        (0, 3), (0, 2), (1, 3), (2, 3), (1, 2)]


def test_gloo_binds_no_card(monkeypatch):
    seen = []
    monkeypatch.setattr(torch.cuda, "set_device", seen.append)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: seen.append((a, kw)))
    ctx = types.SimpleNamespace(coordinator_address="127.0.0.1:1",
                                world_size=2, rank=1)
    assert init_torch_distributed(ctx, device="cpu") is True
    (args, kw), = seen
    assert args == ("gloo",) and kw["init_method"] == "tcp://127.0.0.1:1"
    assert "device_id" not in kw


# --- the parallel4 bodies over 4 gloo ranks ---------------------------------

def _run(jobs):
    out = {}
    for name, got in cs.p4_run(cs.P4_WORLD, "cpu", jobs, cs.P4_TIMEOUTS):
        out.setdefault(name, []).append(got)
    return out


@pytest.fixture(scope="module")
def small():
    return _run([("collectives", {}),
                 ("bandwidth", {"sizes": (1 << 12, 1 << 16),
                                "iters": (2, 2)}),
                 ("moe", {}), ("pipeline", {})])


@pytest.fixture(scope="module")
def layouts():
    return _run([("layout", {"spec": s}) for s in cs.P4_LAYOUTS])


TRAIN_CFG = {"remat": True}


@pytest.fixture(scope="module")
def trained():
    return _run([("train", {"spec": s, "cfg_name": "tiny",
                            "cfg_overrides": TRAIN_CFG, "B": 4, "S": 32})
                 for s in cs.P4_TRAIN_LAYOUTS])


def test_every_rank_joins_on_its_own_group(small):
    (ranks,) = small["init"]
    assert ranks == [{"made": True, "backend": "gloo", "world": 4,
                      "device": "cpu"}] * 4


def test_collectives_over_four_ranks_equal_numpy(small):
    (got,) = small["collectives"]
    want = cs.p4_collectives_expected()
    # 3 axes x 13 symbolic ops and 10 eager ops over dp=4, 2 dtypes, 2
    # kinds of input
    assert {len(w) for w in want.values()} == {(3 * 13 + 10) * 4}
    for r, res in enumerate(got):
        for key, w in want[r].items():
            g = np.asarray(res[key], np.float64)
            if key.endswith("|int"):
                np.testing.assert_array_equal(g, w, err_msg=key)
            else:
                tol = cs.P4_F32 if "|float32|" in key else cs.P4_BF16
                np.testing.assert_allclose(g, w, err_msg=key, **tol)
    assert cs.p4_collectives_errors(got, want) == (49 * 4 * 4, [])


def test_bandwidth_rows_cover_every_op_and_size(small):
    (got,) = small["bandwidth"]
    for rows in got:
        assert [(r["op"], r["bytes"]) for r in rows] == [
            (op, size) for size in (1 << 12, 1 << 16)
            for op in ("allreduce", "allgather", "reducescatter")]
        for r in rows:
            assert r["nccl_busbw_gbs"] > 0 and r["port_busbw_gbs"] > 0


@pytest.mark.parametrize("i", range(len(cs.P4_LAYOUTS)),
                         ids=[cs._p4_spec_name(s) for s in cs.P4_LAYOUTS])
def test_layout_equals_the_unsharded_model(layouts, i):
    """Logits at 2e-4; 2 AdamW steps' losses and grad norms at 1e-5, and
    the params at 1e-5 wherever the first gradient is above the rounding
    floor (Adam's step bound below it)."""
    got = layouts["layout"][i]
    want = cs.p4_layout(torch, "cpu")
    for r in got:
        np.testing.assert_allclose(r["logits"], want["logits"],
                                   **cs.P4_LOGITS)
        np.testing.assert_allclose(r["metrics"], want["metrics"],
                                   **cs.P4_F32)
    ok, errs = cs.p4_layout_errors(got, want)
    assert ok, errs
    assert errs["params"] <= 1e-5
    assert errs["params_at_grad_floor"] <= 4


def test_moe_at_ep4_equals_unsharded(small):
    (got,) = small["moe"]
    want = cs.p4_moe(torch, "cpu", sharded=False)
    for r in got:
        np.testing.assert_allclose(r["out"], want["out"], **cs.P4_GRAD)
        np.testing.assert_allclose(r["out"], want["oracle"], **cs.P4_GRAD)
        np.testing.assert_allclose(r["aux"], want["aux"], rtol=1e-5)
        assert r["w_gate"] == "(Shard(dim=0),)"


def test_pipeline_over_four_stages_equals_serial(small):
    (got,) = small["pipeline"]
    want = cs.p4_pipeline(torch, "cpu", sharded=False)
    for r in got:
        np.testing.assert_allclose(r["out"], want["out"], **cs.P4_F32)
        for k in ("w", "b"):
            np.testing.assert_allclose(r["grad"][k], want["grad"][k],
                                       **cs.P4_GRAD)


@pytest.mark.parametrize("i", range(len(cs.P4_TRAIN_LAYOUTS)),
                         ids=[cs._p4_spec_name(s)
                              for s in cs.P4_TRAIN_LAYOUTS])
def test_train_first_loss_is_the_one_device_mean(trained, i):
    """The 8B body at tiny's size (f32, remat): every rank's first loss,
    first grad norm and loss after one update equal the same step on one
    device a sequence at a time, through the check the phase makes (at
    1e-5 here, f32), the loss falls, and 4 steps were taken."""
    got = trained["train"][i]
    cfg = cs.p4_llama_cfg("tiny", **TRAIN_CFG)
    ref = cs.p4_one_device_step(torch, "cpu", cfg, 4, 32)
    np.testing.assert_allclose(ref["loss"][0],
                               np.mean(ref["sequence_losses"]), rtol=1e-6)
    ok, errs = cs.p4_train_errors(
        got, ref, {"loss": 1e-5, "grad_norm": 1e-5, "loss2": 1e-5})
    assert ok, errs
    for r in got:
        assert r["spec"] == cs.P4_TRAIN_LAYOUTS[i] and r["step"] == 4
        np.testing.assert_allclose(r["loss"][0], ref["loss"][0], rtol=1e-5)


# --- the same layouts in ray_tpu, on four of cpu_mesh8's devices ------------
# (jax is imported here only: the bodies above also run where it is not)

def _j_mesh(spec, cpu_mesh8):
    import ray_tpu.parallel as jpar

    return jpar.build_mesh(jpar.MeshSpec(**spec), cpu_mesh8[:cs.P4_WORLD])


def _j_params(cfg, seed):
    """The port's seeded params as the reference's numpy tree."""
    from ray_tpu_torch.models import init_params, params_to_numpy

    return params_to_numpy(init_params(cfg, seed=seed, device="cpu"))


def _j_steps(cfg, params, optimizer, batches, mesh):
    """ray_tpu's sharded trainer over ``batches``: its (loss, grad norm)
    a step and its params after them."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import lm_loss, param_logical_axes
    from ray_tpu.train import make_train_step

    init_fn, step_fn, place = make_train_step(
        lambda p, b: lm_loss(p, b, cfg, mesh=mesh), optimizer, mesh,
        param_logical_axes(cfg))
    state = init_fn(jax.tree.map(jnp.asarray, params))
    metrics = []
    for b in batches:
        state, m = step_fn(state, place({k: jnp.asarray(v, jnp.int32)
                                         for k, v in b.items()}))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, jax.tree.map(np.asarray, state.params)


@pytest.mark.parametrize("i", range(len(cs.P4_LAYOUTS)),
                         ids=[cs._p4_spec_name(s) for s in cs.P4_LAYOUTS])
def test_layout_equals_ray_tpus_sharded_layout(layouts, cpu_mesh8, i):
    """Each four-rank layout against ray_tpu's sharded forward and step
    under the same MeshSpec: logits at 2e-4, 2 AdamW steps' losses and
    grad norms at 1e-5, params at 1e-5 above the first gradient's rounding
    floor (Adam's step bound below it)."""
    import jax
    import jax.numpy as jnp
    import optax

    from ray_tpu.models import LLAMA_CONFIGS as J_CONFIGS
    from ray_tpu.models import forward, lm_loss, param_logical_axes
    from ray_tpu.parallel import shard_pytree

    from ray_tpu_torch.models import LLAMA_CONFIGS

    cfg = J_CONFIGS["tiny"]
    params = _j_params(LLAMA_CONFIGS["tiny"], 0)
    tokens, batches = cs.p4_tiny_data(torch)
    mesh = _j_mesh(cs.P4_LAYOUTS[i], cpu_mesh8)
    placed = jax.device_put(params, shard_pytree(
        params, param_logical_axes(cfg), mesh))
    logits = jax.jit(lambda p, t: forward(p, t, cfg, mesh=mesh))(
        placed, jnp.asarray(tokens, jnp.int32))
    metrics, after = _j_steps(cfg, params, optax.adamw(1e-3), batches, mesh)
    grad1 = jax.grad(lambda p: lm_loss(p, {k: jnp.asarray(v, jnp.int32)
                                           for k, v in batches[0].items()},
                                       cfg))(jax.tree.map(jnp.asarray,
                                                          params))
    want = {"logits": np.asarray(logits), "metrics": metrics,
            "params": after, "grad1": jax.tree.map(np.asarray, grad1)}
    ok, errs = cs.p4_layout_errors(layouts["layout"][i], want)
    assert ok, errs
    assert errs["params"] <= 1e-5


@pytest.mark.parametrize("i", range(len(cs.P4_TRAIN_LAYOUTS)),
                         ids=[cs._p4_spec_name(s)
                              for s in cs.P4_TRAIN_LAYOUTS])
def test_train_equals_ray_tpus_sharded_step(trained, cpu_mesh8, i):
    """The 8B body at tiny's size (f32, remat) against ray_tpu's sharded
    step under the same MeshSpec, params, batch and adamw(3e-4,
    weight_decay=0.1): all 4 steps' losses and grad norms at 1e-5."""
    import dataclasses

    import optax

    from ray_tpu.models import LLAMA_CONFIGS as J_CONFIGS

    cfg = cs.p4_llama_cfg("tiny", **TRAIN_CFG)
    tokens = cs.p4_train_tokens(torch, cfg.vocab, 4, 32).numpy()
    metrics, _ = _j_steps(
        dataclasses.replace(J_CONFIGS["tiny"], **TRAIN_CFG),
        _j_params(cfg, 7), optax.adamw(3e-4, weight_decay=0.1),
        [{"tokens": tokens}] * 4, _j_mesh(cs.P4_TRAIN_LAYOUTS[i], cpu_mesh8))
    for r in trained["train"][i]:
        np.testing.assert_allclose(r["loss"], [m[0] for m in metrics],
                                   **cs.P4_F32)
        np.testing.assert_allclose(r["grad_norm"], [m[1] for m in metrics],
                                   **cs.P4_F32)
