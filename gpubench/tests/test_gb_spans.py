"""The readers of the program's spans (``gpubench/spans.py``): on synthetic
records, and on a tiny serving run on the CPU with the program's tracer on
as a driver that records spans turns it on (from the loop's start; the
spans drained into ``records["spans"]`` after the window)."""

from __future__ import annotations

import time

import pytest
import torch

from gpubench import run, spans
from ray_tpu_torch.util import tracing
from ray_tpu_torch.util.tracing import Span

HOST_METRICS = ("serve.pump_ms", "engine.decode_host_ms",
                "engine.prefill_pad_share")
SLICE_METRICS = ("idle_share.serve.bookkeeping", "idle_share.serve.dispatch",
                 "op.mlp_device_share", "op.mlp_device_share.batch")


def _span(name, t0, t1, sid, parent=None, root=None, **attrs):
    return Span(name, t0, t1, sid, parent, root or sid, attrs)


def _records(host, device=(), gaps=((0.0, 0.1),), busy=0.5, window=1.0):
    return {"window": (0.0, 10.0), "steps": [],
            "trace": {"window_s": window, "busy_s": busy,
                      "gaps": list(gaps), "kernels": {}},
            "spans": {"host": list(host), "device": list(device)}}


def test_a_gap_splits_by_the_innermost_span():
    """A gap half under engine.decode.emit and half under
    runner.decode_burst splits half and half; engine.step's self time
    is bookkeeping, a sync span neither."""
    host = [_span("engine.step", 0.0, 1.0, 1),
            _span("engine.decode", 0.1, 0.9, 2, 1, 1, steps=8),
            _span("runner.decode_burst", 0.1, 0.5, 3, 2, 1),
            _span("op.mlp", 0.2, 0.3, 4, 3, 1),
            _span("engine.decode.sync", 0.5, 0.6, 5, 2, 1),
            _span("engine.decode.emit", 0.6, 0.9, 6, 2, 1)]
    # innermost: [0, .05] engine.step; [.25, .3] op.mlp, [.3, .35] the
    # runner; [.45, .5] the runner, [.5, .55] the sync; [.8, .9] emit
    rec = _records(host, gaps=[(0.0, 0.05), (0.25, 0.35), (0.45, 0.55),
                               (0.8, 0.9)])
    idle = spans.innermost_idle(host, rec["trace"]["gaps"])
    assert idle["engine.step"] == pytest.approx(0.05)
    assert idle["op.mlp"] == pytest.approx(0.05)
    assert idle["runner.decode_burst"] == pytest.approx(0.1)
    assert idle["engine.decode.sync"] == pytest.approx(0.05)
    assert idle["engine.decode.emit"] == pytest.approx(0.1)
    assert spans.idle_share_bookkeeping(rec) == pytest.approx(15.0)
    assert spans.idle_share_dispatch(rec) == pytest.approx(15.0)


def test_half_emit_half_runner_splits_evenly():
    host = [_span("engine.decode", 0.0, 1.0, 1, steps=4),
            _span("runner.decode_burst", 0.0, 0.5, 2, 1, 1),
            _span("engine.decode.emit", 0.5, 1.0, 3, 1, 1)]
    rec = _records(host, gaps=[(0.4, 0.6)], window=1.0)
    assert spans.idle_share_bookkeeping(rec) == pytest.approx(10.0)
    assert spans.idle_share_dispatch(rec) == pytest.approx(10.0)


def test_idle_under_no_span_is_neither():
    host = [_span("engine.step", 0.5, 1.0, 1)]
    rec = _records(host, gaps=[(0.0, 0.2)])
    assert spans.idle_share_bookkeeping(rec) == 0.0
    assert spans.idle_share_dispatch(rec) == 0.0


def test_a_device_interval_counts_its_busy_part():
    """An op.mlp device interval that straddles a gap counts only the
    part the card was busy; overlapping intervals count once; the part
    outside the slice not at all."""
    gaps = [(0.0, 0.1), (0.3, 0.4), (0.9, 1.0)]
    dev = [_span("op.mlp", 0.2, 0.5, 1),       # 0.2 busy, 0.1 idle
           _span("op.mlp", 0.45, 0.55, 2),     # overlaps the first
           _span("op.mlp", 0.95, 1.3, 3),      # idle inside, out beyond
           _span("engine.step", 0.0, 1.0, 4)]  # not an op.mlp span
    rec = _records([_span("engine.step", 0.0, 1.0, 4)], dev, gaps,
                   busy=0.7, window=1.0)
    # busy inside op.mlp: [0.2, 0.55] less [0.3, 0.4] = 0.25
    assert spans.mlp_device_share(rec) == pytest.approx(100 * 0.25 / 0.7)


def test_host_readers_on_synthetic_spans():
    host = [_span("serve.pump.hop", 0.0, 0.001, 1),
            _span("serve.pump.fanout", 0.5, 0.503, 2),
            _span("serve.pump.hop", 0.503, 0.504, 3),
            _span("engine.decode", 0.1, 0.4, 4, steps=8),
            _span("engine.decode.sync", 0.3, 0.38, 5, 4, 4),
            _span("engine.prefill", 0.02, 0.08, 6, tokens=1200,
                  padded=2048),
            _span("engine.prefill", 0.52, 0.6, 7, tokens=3000,
                  padded=4096)]
    rec = _records(host)
    assert spans.pump_ms(rec) == pytest.approx(1.0 + 3.0)
    assert spans.decode_host_ms(rec) == pytest.approx((300 - 80) / 8)
    assert spans.prefill_pad_share(rec) == pytest.approx(
        100 * (848 + 1096) / (2048 + 4096))
    # a span that ended outside the window is not read
    rec["window"] = (0.55, 10.0)
    assert spans.prefill_pad_share(rec) == pytest.approx(
        100 * 1096 / 4096)
    assert spans.pump_ms(rec) is None


@pytest.mark.parametrize("records", [
    {"window": (0.0, 1.0), "steps": [], "trace": None},
    {"window": (0.0, 1.0), "steps": [], "trace": None,
     "spans": {"host": [], "device": []}}])
def test_readers_read_nothing_without_spans(records):
    for read in (spans.pump_ms, spans.decode_host_ms,
                 spans.prefill_pad_share, spans.idle_share_bookkeeping,
                 spans.idle_share_dispatch, spans.mlp_device_share):
        assert read(records) is None


@pytest.fixture
def traced_driver(monkeypatch):
    """The serving driver with the program's tracer on from the loop's
    start (the step recorder's creation) and its spans drained into the
    records after the run."""
    inner = run.driver

    def driver(cell):
        mod = inner(cell)

        class Recorder(mod.StepRecorder):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                tracing.enable()

        def run_cell(ctx, _run=mod.run):
            try:
                out = _run(ctx)
            finally:
                tracing.disable()
            out["records"]["spans"] = tracing.drain()
            return out

        mod.StepRecorder, mod.run = Recorder, run_cell
        return mod

    monkeypatch.setattr(run, "driver", driver)
    yield
    tracing.disable()
    tracing.drain()


@pytest.mark.parametrize("cell", ["tiny.serve", "tiny_moe.serve"])
def test_serve_cell_reads_its_spans(tiny_root, traced_driver, cell):
    from ray_tpu_torch.llm.runner import prefill_bucket

    c = run.load_cell(cell, tiny_root)
    res = run.run_cell(c, 2**31 + 777, 2.0, True, torch.device("cpu"),
                       time.perf_counter())
    records = res["out"]["records"]
    for name in HOST_METRICS:
        value = run.reader(c, name).read(records)
        assert value is not None and value >= 0, name
    assert run.reader(c, "serve.pump_ms").read(records) > 0
    assert run.reader(c, "engine.decode_host_ms").read(records) > 0
    # no traced slice on the CPU
    for name in SLICE_METRICS:
        assert run.reader(c, name).read(records) is None, name
    # the padding the spans read is the one the step records imply
    max_seq = c.workload["engine"]["max_seq_len"]
    plens = [plen for s in records["steps"] for _rid, plen, j in s["out"]
             if j == 0]
    buckets = [prefill_bucket(p, max_seq) for p in plens]
    whole = dict(records, window=(float("-inf"), float("inf")))
    assert spans.prefill_pad_share(whole) == pytest.approx(
        100 * (sum(buckets) - sum(plens)) / sum(buckets))
