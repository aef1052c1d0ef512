"""The port's span plane (``ray_tpu_torch/util/tracing.py``) on the CPU:
the off path's cost, the records of the tracer when it is on, and the span
tree of the serving path (``LLMServer``'s pump, ``LLMEngine.step`` and the
runner's MLP)."""

import asyncio
import json
import threading
import tracemalloc

import pytest
import torch

from ray_tpu_torch.llm import (EngineConfig, LLMEngine, LLMServer,
                               SamplingParams)
from ray_tpu_torch.llm.runner import prefill_bucket
from ray_tpu_torch.models.llama import LLAMA_CONFIGS, init_params
from ray_tpu_torch.util import tracing

# six xdist workers share the machine's cores
torch.set_num_threads(2)

CFG = LLAMA_CONFIGS["tiny"]
ECFG = dict(max_num_seqs=4, page_size=8, num_pages=64, max_seq_len=128,
            decode_burst=4)
GREEDY = SamplingParams(temperature=0.0, max_tokens=9)


@pytest.fixture
def tracer(monkeypatch):
    """A fresh tracer for the test, off when it ends."""
    monkeypatch.setattr(tracing, "_TRACER", tracing._Tracer())
    yield tracing
    tracing.disable()


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, seed=0, device="cpu")


def _prompts():
    return [[(7 * i + j) % CFG.vocab + 1 for j in range(n)]
            for i, n in enumerate((5, 19, 33, 12, 40))]


def _raise(*_a, **_k):
    raise AssertionError("called on the off path")


def test_off_path_is_one_shared_noop(tracer, monkeypatch):
    """Tracer off and no profiler: every span is the same no-op context,
    and no span, stamp or record reads the clock, opens a
    record_function range or leaves an allocation behind."""
    monkeypatch.setattr(tracing, "record_function", _raise)
    monkeypatch.setattr(tracing, "_now", _raise)
    assert tracing.span("a") is tracing.span("b", device=True, n=3)

    def spans(n):
        for _ in range(n):
            with tracing.span("engine.step"):
                with tracing.span("op.mlp", device=True):
                    pass
            tracing.record("serve.pump.hop", tracing.stamp())

    spans(100)     # warm any lazily made object
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        spans(10000)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.size_diff > 0 and d.traceback[0].filename
             == tracing.__file__]
    assert not grown, grown
    assert tracing.stamp() is None
    assert tracing.drain() == {"host": [], "device": []}


def test_off_path_under_a_profiler_is_a_record_function_range(tracer):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("port.profiled"):
            torch.ones(4).sum()
    assert any(e.name == "port.profiled" for e in prof.events())
    assert tracing.drain() == {"host": [], "device": []}


def test_on_records_nesting_parents_and_roots(tracer):
    tracing.enable()
    with tracing.span("outer", k=1):
        with tracing.span("mid"):
            with tracing.span("inner", device=True):
                pass
        with tracing.span("mid2"):
            pass
    with tracing.span("next"):
        pass
    got = tracing.drain()
    assert got["device"] == []        # device tracing is off
    by = {s.name: s for s in got["host"]}
    assert [s.name for s in got["host"]] == ["inner", "mid", "mid2",
                                             "outer", "next"]
    outer = by["outer"]
    assert outer.parent is None and outer.root == outer.id
    assert outer.attrs == {"k": 1}
    assert by["mid"].parent == outer.id and by["mid2"].parent == outer.id
    assert by["inner"].parent == by["mid"].id
    assert {by[n].root for n in ("mid", "inner", "mid2")} == {outer.id}
    assert by["next"].root == by["next"].id != outer.id
    for s in got["host"]:
        assert s.t0 <= s.t1
    assert outer.t0 <= by["mid"].t0 <= by["inner"].t0
    assert by["inner"].t1 <= by["mid"].t1 <= by["mid2"].t0
    assert by["mid2"].t1 <= outer.t1 <= by["next"].t0
    assert tracing.drain() == {"host": [], "device": []}


def test_buffer_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(tracing, "_TRACER", tracing._Tracer(capacity=5))
    tracing.enable()
    try:
        for i in range(12):
            with tracing.span(f"s{i}"):
                pass
    finally:
        tracing.disable()
    # what the tracer recorded while on stays for drain
    assert [s.name for s in tracing.drain()["host"]] == [
        f"s{i}" for i in range(7, 12)]


def test_record_spans_two_threads(tracer):
    """An interval stamped on one thread and recorded on another, with
    each thread's spans nested on that thread alone."""
    tracing.enable()
    t0 = tracing.stamp()
    seen = {}

    def worker():
        tracing.record("hop", t0, n=2)
        with tracing.span("work"):
            seen["t"] = tracing.stamp()

    with tracing.span("main"):
        th = threading.Thread(target=worker)
        th.start()
        th.join(timeout=30)
    assert not th.is_alive()
    by = {s.name: s for s in tracing.drain()["host"]}
    assert by["hop"].t0 == t0 < by["hop"].t1 <= by["work"].t0
    assert by["hop"].parent is None and by["hop"].attrs == {"n": 2}
    # the worker's span has no parent: "main" is open on another thread
    assert by["work"].parent is None and by["work"].root == by["work"].id
    assert by["work"].t0 <= seen["t"] <= by["work"].t1


def test_engine_step_span_tree(tracer, params):
    """Each step is a tree rooted at engine.step: admission, the prefill
    (prep, the runner, the sync) and the decode burst (prep, the runner,
    the sync, the emission), with op.mlp once a layer a forward under
    each runner call; every child lies inside its parent."""
    eng = LLMEngine(params, CFG, EngineConfig(**ECFG), device="cpu")
    tracing.enable()
    eng.generate(_prompts(), GREEDY)
    tracing.disable()
    host = tracing.drain()["host"]
    by_id = {s.id: s for s in host}
    kids = {}
    for s in host:
        if s.parent is not None:
            parent = by_id[s.parent]
            assert parent.t0 <= s.t0 <= s.t1 <= parent.t1, (s, parent)
            assert s.root == parent.root
            kids.setdefault(parent.id, []).append(s)
    steps = [s for s in host if s.name == "engine.step"]
    assert len(steps) >= 5
    assert {s.root for s in host} == {s.id for s in steps}
    want = {"engine.prefill": ["engine.prefill.prep", "runner.prefill",
                               "engine.prefill.sync"],
            "engine.decode": ["engine.decode.prep", "runner.decode_burst",
                              "engine.decode.sync", "engine.decode.emit"]}
    decode_steps = prefills = 0
    for step in steps:
        names = [s.name for s in kids[step.id]]
        assert names[0] == "engine.admit"
        assert set(names[1:]) <= set(want) and len(set(names)) == len(names)
        for phase in kids[step.id][1:]:
            children = kids[phase.id]
            assert [c.name for c in children] == want[phase.name]
            forwards = phase.attrs.get("steps", 1)
            mlps = kids[children[1].id]
            assert [m.name for m in mlps] == ["op.mlp"] * (
                CFG.n_layers * forwards)
            decode_steps += phase.attrs.get("steps", 0)
            prefills += phase.name == "engine.prefill"
    assert decode_steps == eng.stats()["decode_steps"]
    assert prefills == len(_prompts())


def test_prefill_padding_attributes(tracer, params):
    eng = LLMEngine(params, CFG, EngineConfig(**ECFG), device="cpu")
    tracing.enable()
    eng.generate(_prompts(), GREEDY)
    tracing.disable()
    pre = [s for s in tracing.drain()["host"] if s.name == "engine.prefill"]
    assert sorted(s.attrs["tokens"] for s in pre) == sorted(
        len(p) for p in _prompts())
    for s in pre:
        L = s.attrs["tokens"]
        assert s.attrs["padded"] - L == prefill_bucket(
            L, ECFG["max_seq_len"]) - L


def test_chunked_prefill_attributes(tracer, params):
    eng = LLMEngine(params, CFG, EngineConfig(**ECFG, prefill_chunk=16),
                    device="cpu")
    tracing.enable()
    eng.generate(_prompts(), GREEDY)
    tracing.disable()
    pre = [s for s in tracing.drain()["host"] if s.name == "engine.prefill"]
    assert {s.attrs["padded"] for s in pre} == {16}
    assert sum(s.attrs["tokens"] for s in pre) == sum(
        len(p) for p in _prompts())


def test_greedy_outputs_equal_with_tracing_on_and_off(tracer, params):
    def run():
        eng = LLMEngine(params, CFG, EngineConfig(**ECFG), device="cpu")
        return eng.generate(_prompts(), GREEDY)

    off = run()
    tracing.enable()
    on = run()
    tracing.disable()
    assert on == off
    assert tracing.drain()["host"]


def test_server_pump_hop_and_fanout(tracer):
    """The pump's hop ends as its step starts, and its fan-out runs from
    the step's return to the next submit."""
    server = LLMServer("tiny", device="cpu", engine_config=ECFG)

    async def serve():
        async def one(p):
            stream = await server.completions({
                "prompt_ids": p, "max_tokens": 9, "temperature": 0.0,
                "stream": True})
            return [json.loads(c[len("data: "):])["token"]
                    async for c in stream]

        out = await asyncio.gather(*(one(p) for p in _prompts()))
        await server._pump_task
        return out

    tracing.enable()
    streams = asyncio.run(serve())
    tracing.disable()
    assert all(len(s) == 9 for s in streams)
    host = tracing.drain()["host"]
    steps = sorted((s for s in host if s.name == "engine.step"),
                   key=lambda s: s.t0)
    hops = sorted((s for s in host if s.name == "serve.pump.hop"),
                  key=lambda s: s.t0)
    fans = sorted((s for s in host if s.name == "serve.pump.fanout"),
                  key=lambda s: s.t0)
    assert len(hops) == len(steps) and len(fans) == len(steps) - 1
    for hop, step in zip(hops, steps):
        assert hop.t1 <= step.t0 and hop.parent is None
    for fan, (a, b) in zip(fans, zip(steps, steps[1:])):
        assert a.t1 <= fan.t0 <= fan.t1 <= b.t0


def _graph_anywhere(monkeypatch):
    """Let the engine's graph path onto the CPU, where ``DecodeGraph`` runs
    its step without capture."""
    monkeypatch.setattr(LLMEngine, "_graph_eligible",
                        lambda self, greedy, paged: greedy and paged)


@pytest.mark.parametrize("graphed", [0, 1])
def test_decode_span_says_whether_the_burst_was_graphed(tracer, params,
                                                        monkeypatch,
                                                        graphed):
    if graphed:
        _graph_anywhere(monkeypatch)
    eng = LLMEngine(params, CFG, EngineConfig(**ECFG), device="cpu")
    tracing.enable()
    eng.generate(_prompts(), GREEDY)
    tracing.disable()
    dec = [s for s in tracing.drain()["host"] if s.name == "engine.decode"]
    assert dec and {s.attrs["graphed"] for s in dec} == {graphed}
    st = eng.stats()
    assert st["decode_graph_steps"] == graphed * st["decode_steps"]
    assert sum(s.attrs["steps"] for s in dec) == st["decode_steps"]


def test_device_spans_off_suspends_and_restores(tracer):
    """Inside ``device_spans_off`` a device span records its host span
    only; the tracer's state is as it was after the block, also when the
    block raises."""
    for on, device in ((True, False), (False, False)):
        tracer._TRACER.on, tracer._TRACER.device = on, device
        with tracing.device_spans_off():
            assert not tracer._TRACER.device
        assert (tracer._TRACER.on, tracer._TRACER.device) == (on, device)
    tracing.enable()
    # device tracing as enable(device=True) leaves it, without a card
    tracer._TRACER.device = True
    with pytest.raises(KeyError):
        with tracing.device_spans_off():
            with tracing.span("inside", device=True):
                pass
            raise KeyError
    assert tracer._TRACER.on and tracer._TRACER.device
    assert not tracer._TRACER.pending
    assert [s.name for s in tracing.drain()["host"]] == ["inside"]


def test_annotate_sets_the_innermost_open_span(tracer):
    tracing.annotate(x=1)                   # off: nothing to set
    tracing.enable()
    tracing.annotate(x=2)                   # no span open
    with tracing.span("outer", a=1):
        with tracing.span("inner"):
            pass
        tracing.annotate(b=2)
    tracing.disable()
    by = {s.name: s for s in tracing.drain()["host"]}
    assert by["outer"].attrs == {"a": 1, "b": 2}
    assert by["inner"].attrs == {}


@pytest.mark.cuda
def test_graph_capture_under_device_tracing_on_card(tracer):
    """On the card, with device tracing on: the capture records no device
    span (no op.mlp events baked into the graph), leaves the tracer as it
    was, and the graphed bursts' engine.decode spans say graphed=1; the
    eager prefills' op.mlp device spans are still recorded."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")
    cuda_params = init_params(CFG, seed=0, device="cuda")
    eng = LLMEngine(cuda_params, CFG, EngineConfig(**ECFG), device="cuda")
    tracing.enable(device=True)
    state = (tracer._TRACER.on, tracer._TRACER.device, tracer._TRACER.anchor)
    eng.generate(_prompts(), GREEDY)
    assert (tracer._TRACER.on, tracer._TRACER.device,
            tracer._TRACER.anchor) == state
    tracing.disable()
    st = eng.stats()
    assert st["decode_graph_captures"] == 1
    assert st["decode_graph_steps"] == st["decode_steps"] > 0
    rec = tracing.drain()
    host, device = rec["host"], rec["device"]
    dec = [s for s in host if s.name == "engine.decode"]
    assert dec and all(s.attrs["graphed"] == 1 for s in dec)
    # device spans: one op.mlp a layer a prefill, none from the capture
    # (its warm-up step and its capture each ran the layer loop once)
    by_id = {s.id: s for s in host}
    assert len(device) == CFG.n_layers * st["prefills"]
    for d in device:
        assert d.name == "op.mlp"
        assert by_id[d.parent].name == "runner.prefill", d
