"""ray_tpu_torch's LLMServer against ray_tpu's (CPU, f32).

Both servers load one pickle of ``ray_tpu``'s numpy weights and run in this
process: concurrent greedy completions, streamed chunks, errors, LoRA
routing, the metrics' count deltas, the prefix-cache summary, ``stats`` and
the speculation counters must be equal; token ids exactly (f32 on the CPU,
greedy). The port's pooled pair runs in-process through its hooks (chunked
handoff, a failpoint that raises once or always, a corrupt payload), and
both servers serve under ``ray_tpu.serve`` with the port's hooks filled by
``ray_tpu``'s own functions. The hooks live here, never in the port.
"""

import asyncio
import json
import pickle
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
from ray_tpu.llm.lora import init_lora_adapter as j_init_lora
from ray_tpu.llm.serve import LLMServer as JLLMServer
from ray_tpu.llm.spec_decode import SpecDecoder as JSpecDecoder
from ray_tpu.models import LLAMA_CONFIGS as J_CONFIGS
from ray_tpu.models import init_params as j_init
from ray_tpu.util import hbm as j_hbm
from ray_tpu.util import metrics as j_metrics

from ray_tpu_torch._private.config import global_config
from ray_tpu_torch.llm import (EngineConfig, LLMEngine, LLMServer,
                               SamplingParams, ServeHooks, SpecDecoder,
                               build_llm_deployment)
from ray_tpu_torch.llm.cache import make_summary, truncate_keys
from ray_tpu_torch.models import LLAMA_CONFIGS, lora_from_jax
from ray_tpu_torch.util import hbm, metrics

# six xdist workers share the machine's cores
torch.set_num_threads(2)

CFG = LLAMA_CONFIGS["tiny"]
JCFG = J_CONFIGS["tiny"]
ECFG = dict(max_num_seqs=4, page_size=4, num_pages=64, max_seq_len=64)
PAYLOADS = [
    {"prompt_ids": [5, 17, 99, 3], "temperature": 0.0, "max_tokens": 9},
    {"prompt_ids": [7, 8, 9], "temperature": 0.0, "max_tokens": 5},
    {"prompt_ids": list(range(20, 40)), "temperature": 0.0,
     "max_tokens": 12},
]
# the greedy stream of PAYLOADS[0] holds 244 at its 4th token
STOP = {"prompt_ids": [5, 17, 99, 3], "temperature": 0.0, "max_tokens": 9,
        "stop_token_ids": [244]}
LORA_RANK = 4


@pytest.fixture(scope="module")
def params_path(tmp_path_factory):
    """ray_tpu's tiny weights (PRNGKey(0)) as a pickle of numpy arrays."""
    path = tmp_path_factory.mktemp("serve") / "tiny.pkl"
    tree = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), JCFG))
    with open(path, "wb") as f:
        pickle.dump(tree, f)
    return str(path)


def _servers(params_path, **ecfg):
    e = {**ECFG, **ecfg}
    return (LLMServer("tiny", params_path=params_path, engine_config=e,
                      device="cpu"),
            JLLMServer("tiny", params_path=params_path, engine_config=e))


@pytest.fixture(scope="module")
def servers(params_path):
    return _servers(params_path)


def _gather(server, payloads):
    async def go():
        return await asyncio.gather(
            *[server.completions(dict(p)) for p in payloads])

    return asyncio.run(go())


def _stream(server, payload):
    async def go():
        gen = await server.completions({**payload, "stream": True})
        return [chunk async for chunk in gen]

    return asyncio.run(go())


def _counts(snapshot):
    """The metrics whose values do not depend on time: histogram counts,
    counters."""
    return {k: v for k, v in snapshot.items()
            if "__stat__=count" in k or k.split("{")[0].endswith("_total")}


def _delta(before, after):
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v != before.get(k, 0.0)}


def _metric_deltas(fn):
    """fn() run once, and the count deltas it left in the port's and in
    ray_tpu's process-local metrics."""
    b_port = _counts(metrics.snapshot_local("llm_"))
    b_ref = _counts(j_metrics.snapshot_local("llm_"))
    out = fn()
    return (out, _delta(b_port, _counts(metrics.snapshot_local("llm_"))),
            _delta(b_ref, _counts(j_metrics.snapshot_local("llm_"))))


def test_concurrent_greedy_completions_equal_ray_tpu_s(servers):
    """Four concurrent payloads (one stopping at a stop token): the same
    token ids, finish reasons and metric count deltas (exact)."""
    port, ref = servers
    payloads = PAYLOADS + [STOP]
    (got, want), d_port, d_ref = _metric_deltas(
        lambda: (_gather(port, payloads), _gather(ref, payloads)))
    assert got == want
    assert [b["choices"][0]["finish_reason"] for b in got] == [
        "length", "length", "length", "stop"]
    assert got[3]["choices"][0]["token_ids"][-1] == 244
    assert len(got[3]["choices"][0]["token_ids"]) == 4
    assert d_port == d_ref
    key = "llm_ttft_seconds{__stat__=count,model=tiny,pool=mono}"
    assert d_port[key] == 4
    assert d_port["llm_generation_tokens_total{model=tiny,pool=mono}"] == (
        9 + 5 + 12 + 4)


def test_metric_count_deltas_equal_ray_tpu_s(servers):
    """Each server's own run leaves the same count deltas in its
    package's metrics."""
    port, ref = servers
    _, d_port, _ = _metric_deltas(lambda: _gather(port, PAYLOADS))
    _, _, d_ref = _metric_deltas(lambda: _gather(ref, PAYLOADS))
    assert d_port == d_ref
    assert d_port["llm_prompt_tokens_total{model=tiny,pool=mono}"] == 27


def test_streamed_chunks_equal_ray_tpu_s(servers):
    port, ref = servers
    for payload in (PAYLOADS[2], STOP):
        got = _stream(port, payload)
        assert got == _stream(ref, payload)
        chunks = [json.loads(c[len("data: "):]) for c in got]
        assert all(c.startswith("data: ") and c.endswith("\n\n")
                   for c in got)
        assert [c["token"] for c in chunks] == _gather(
            port, [payload])[0]["choices"][0]["token_ids"]
        assert chunks[-1]["finished"] is True


def test_the_same_value_errors(servers):
    port, ref = servers
    for payload in ({"temperature": 0.0}, {"prompt": "hi"},
                    {"prompt_ids": [1, 2], "model": "nope"},
                    {"prompt_ids": [1, 2], "model": 3}):
        errs = []
        for server in (port, ref):
            with pytest.raises(ValueError) as e:
                asyncio.run(server.completions(payload))
            errs.append(str(e.value))
        assert errs[0] == errs[1], payload
    # the server's own name and "base" ride the base weights
    for name in ("tiny", "base", ""):
        assert _gather(port, [{**PAYLOADS[1], "model": name}]) == _gather(
            port, [PAYLOADS[1]])
    for server in (port, ref):
        with pytest.raises(ValueError, match="requires a tokenizer"):
            asyncio.run(server({"messages": [{"role": "user"}]}))


def test_tokenizer_and_hf_init_errors(params_path):
    with pytest.raises(ValueError, match="prompt_ids only"):
        LLMServer("tiny", tokenizer="some/dir", device="cpu")
    with pytest.raises(ValueError, match="unknown model"):
        LLMServer("no-such-model", device="cpu")
    with pytest.raises(ValueError, match="HF-checkpoint loading only"):
        LLMServer("tiny", quantize="int8", device="cpu")
    with pytest.raises(ValueError, match="unknown init"):
        LLMServer("tiny", init="zeros", device="cpu")
    with pytest.raises(ValueError, match="deployment"):
        build_llm_deployment("tiny", device="cpu")


def _jax_adapter(seed):
    a = j_init_lora(jax.random.PRNGKey(seed), JCFG, LORA_RANK,
                    dtype=JCFG.dtype)
    for i, name in enumerate(("b_q", "b_v")):
        a[name] = jax.random.normal(jax.random.PRNGKey(seed + 100 + i),
                                    a[name].shape, jnp.float32) * 0.3
    return jax.tree.map(np.asarray, a)


def test_lora_model_routing_equals_ray_tpu_s(params_path):
    """Requests naming a loaded adapter wear it, the base name rides the
    base weights, in both servers alike."""
    port, ref = _servers(params_path, lora_rank=LORA_RANK, max_loras=2)
    for name, seed in (("a", 3), ("b", 5)):
        adapter = _jax_adapter(seed)
        ref.engine.add_lora(name, adapter)
        port.engine.add_lora(name, lora_from_jax(adapter, device="cpu"))
    payloads = [{**PAYLOADS[0], "model": "a"}, {**PAYLOADS[0], "model": "b"},
                {**PAYLOADS[0], "model": "tiny"}, PAYLOADS[2]]
    got = _gather(port, payloads)
    assert got == _gather(ref, payloads)
    toks = [b["choices"][0]["token_ids"] for b in got]
    assert toks[0] != toks[2] and toks[1] != toks[2] and toks[0] != toks[1]
    for server in (port, ref):
        with pytest.raises(ValueError, match=r"loaded LoRA adapter \(\['a', "
                           r"'b'\]\)"):
            asyncio.run(server.completions({**PAYLOADS[0], "model": "c"}))


def test_prefix_cache_summary_and_stats_equal_ray_tpu_s(params_path):
    port, ref = _servers(params_path, page_size=4,
                         enable_prefix_caching=True)
    assert port.prefix_cache_summary() == ref.prefix_cache_summary() == {
        "page_size": 4, "digests": set()}
    shared = {"prompt_ids": list(range(1, 14)), "temperature": 0.0,
              "max_tokens": 4}
    for _ in range(2):          # the second run hits the prefix cache
        assert _gather(port, [shared, PAYLOADS[0]]) == _gather(
            ref, [shared, PAYLOADS[0]])
    summary = port.prefix_cache_summary()
    assert summary == ref.prefix_cache_summary()
    assert len(summary["digests"]) >= 3
    got, want = asyncio.run(port.stats()), asyncio.run(ref.stats())
    assert {k: got[k] for k in want} == want
    assert want["pool"] == "mono"
    # a step holding the engine lock: the last summary goes out
    with port._engine_lock:
        assert port.prefix_cache_summary() is summary
    assert truncate_keys([b"x" * 32]) == [b"x" * 8]
    assert make_summary([b"y" * 32], 4) == {"page_size": 4,
                                            "digests": {b"y" * 8}}


def test_speculation_counters_equal_ray_tpu_s(params_path):
    """speculation= (drafter seed 1, the reject regime): the drafter's
    weights carried from ray_tpu's PRNGKey(1), the same tokens and drafted
    and accepted deltas; the verify histogram counts the engine's verify
    steps."""
    from ray_tpu_torch.models import params_from_jax

    spec = {"draft_config": "tiny", "num_draft_tokens": 3, "draft_seed": 1}
    e = dict(ECFG)
    port = LLMServer("tiny", params_path=params_path, engine_config=e,
                     device="cpu", speculation=spec)
    ref = JLLMServer("tiny", params_path=params_path, engine_config=e,
                     speculation=spec)
    assert port.engine.spec is not None
    # the port's seeded init differs from ray_tpu's: carry the drafter
    drafter = params_from_jax(jax.tree.map(
        np.asarray, j_init(jax.random.PRNGKey(1), JCFG)), device="cpu")
    port.engine.enable_speculation(spec, draft_params=drafter)
    (got, want), d_port, d_ref = _metric_deltas(
        lambda: (_gather(port, PAYLOADS), _gather(ref, PAYLOADS)))
    assert got == want
    assert d_port == d_ref
    assert d_port["llm_spec_draft_tokens_total{model=tiny,pool=mono}"] > 0
    verify = "llm_spec_verify_seconds{__stat__=count,model=tiny,pool=mono}"
    st = asyncio.run(port.stats())
    assert st["spec"] == asyncio.run(ref.stats())["spec"]
    assert st["spec"]["rounds"] > 0
    assert d_port[verify] == st["verify_steps"] > 0
    assert port.engine.spec.verify_times == []


def test_verify_draft_equals_ray_tpu_s(servers, monkeypatch):
    """One drafted window verified by each server against its own
    engine's KV snapshot (put/get identity: the reference's get is
    replaced in this process) gives the same emission."""
    port, ref = servers
    monkeypatch.setattr(ray_tpu, "get", lambda ref_, timeout=None: ref_)
    prompt = PAYLOADS[0]["prompt_ids"]
    cont = _gather(port, [PAYLOADS[0]])[0]["choices"][0]["token_ids"]
    outs = []
    for server, sp in ((port, SamplingParams), (ref, None)):
        if sp is None:
            from ray_tpu.llm.sampling import SamplingParams as sp
        eng = server.engine
        rid = eng.add_request(list(prompt), sp(temperature=0.0,
                                               max_tokens=20))
        while eng.requests[rid].ctx_len <= 0:
            eng.step(skip_decode=True)
        snap = eng.snapshot_kv_request(rid)
        eng.abort_request(rid)
        eng.requests.pop(rid)
        kv = (snap.pop("k"), snap.pop("v"))
        for draft in ([cont[1], cont[2], 0], [255, 255]):
            outs.append(asyncio.run(server.verify_draft(
                {"handoff": dict(snap), "kv_ref": kv, "draft": draft})))
    assert outs[:2] == outs[2:]
    assert outs[0][:2] == cont[1:3] and len(outs[0]) == 3
    assert not port.engine.has_unfinished()


def test_spec_decoder_take_verify_times_and_reset():
    """take_verify_times drains, reset forgets every warmed slot, as
    ray_tpu's SpecDecoder."""
    from ray_tpu.llm import EngineConfig as JEngineConfig

    spec = {"draft_config": "tiny", "num_draft_tokens": 2}
    port = SpecDecoder(CFG, EngineConfig(**ECFG), spec, device="cpu")
    ref = JSpecDecoder(JCFG, JEngineConfig(**ECFG), spec)
    for d in (port, ref):
        d.verify_times.extend([0.5, 0.25])
        d.ready.update({0, 2})
        assert d.take_verify_times() == [0.5, 0.25]
        assert d.take_verify_times() == []
        d.reset()
        assert d.ready == set()


# --- the pooled pair in one process, through the hooks -----------------------

class _Route:
    """The decode pool as the prefill server's handle sees it: route()
    calls the decode server directly (a coroutine to await and the
    server as the "replica")."""

    def __init__(self, server):
        self.server = server
        self.refreshes = 0

    def route(self, payload, request_id=None, tenant_id=None):
        return self.server.decode_from_kv(payload), self.server

    def _refresh(self, force=False):
        self.refreshes += 1


class _FailTimes:
    def __init__(self, n):
        self.n = n

    async def __call__(self, name, detail=None):
        if name == "serve.kv_handoff" and self.n > 0:
            self.n -= 1
            raise ConnectionError("decode replica lost")


def _pool(params_path, afire=None, put=None):
    """A prefill server and a decode server, configured as the replicas
    of one pooled deployment; the put hook records each chunk."""
    e = dict(ECFG, page_size=4)
    shipped = []

    def _put(value):
        shipped.append(value)
        return value if put is None else put(value)

    decode = LLMServer("tiny", params_path=params_path, engine_config=e,
                       device="cpu")
    route = _Route(decode)
    hooks = ServeHooks(put=_put, handle=lambda dep, method, pool: route,
                       **({"afire": afire} if afire else {}))
    prefill = LLMServer("tiny", params_path=params_path, engine_config=e,
                        device="cpu", hooks=hooks)
    prefill.configure_pool("prefill", "llm")
    decode.configure_pool("decode", "llm")
    return prefill, decode, route, shipped


def _handoff_counts():
    snap = metrics.snapshot_local("serve_kv_handoff")
    return {k.split("{")[0]: v for k, v in snap.items()
            if "le=" not in k and "__stat__=sum" not in k}


def test_pooled_pair_gives_the_mono_tokens_in_chunks(servers, params_path,
                                                     monkeypatch):
    """Handoffs of 2-page chunks: the mono server's tokens, every request
    injected (no decode-side prefill), and the bytes counted."""
    port, _ = servers
    # a page of tiny's f32 cache: k and v, 2 layers of 4 x 2 x 16 floats
    page = 2 * 2 * 4 * 2 * 16 * 4
    monkeypatch.setattr(global_config(), "serve_kv_handoff_chunk_bytes",
                        2 * page)
    prefill, decode, route, shipped = _pool(params_path)
    before = _handoff_counts()
    got = _gather(prefill, PAYLOADS)
    assert got == _gather(port, PAYLOADS)
    st = asyncio.run(decode.stats())
    assert st["injected"] == 3 and st["prefills"] == 0
    assert st["pool"] == "decode"
    pst = asyncio.run(prefill.stats())
    assert pst["decode_steps"] == 0 and pst["prefills"] == 3
    # ctx 4, 3 and 20 positions in 4-token pages: 1, 1 and 5 pages. The
    # three requests ship from their own executor hops, so their puts
    # interleave in any order; a request's own puts keep theirs. A chunk
    # is a page slice of its request's exported k, so its storage names
    # the request: (first page, pages) per request, in put order
    by_request = {}
    for k, _v in shipped:
        by_request.setdefault(k.untyped_storage().data_ptr(), []).append(
            (k.storage_offset() // k.stride(1), k.shape[1]))
    assert sorted(by_request.values(), key=len) == [
        [(0, 1)], [(0, 1)], [(0, 2), (2, 2), (4, 1)]]
    after = _handoff_counts()
    assert after["serve_kv_handoff_bytes_total"] - before.get(
        "serve_kv_handoff_bytes_total", 0) == 7 * page
    assert after["serve_kv_handoff_seconds"] - before.get(
        "serve_kv_handoff_seconds", 0) == 3
    assert after.get("serve_kv_handoff_retries_total", 0) == before.get(
        "serve_kv_handoff_retries_total", 0)
    assert route.refreshes == 0
    # streamed through the pair: the prefill-side token replayed first
    assert _stream(prefill, PAYLOADS[2]) == _stream(port, PAYLOADS[2])
    # done at its first token: nothing to hand off
    one = {**PAYLOADS[1], "max_tokens": 1}
    assert _gather(prefill, [one]) == _gather(port, [one])
    assert _stream(prefill, one) == _stream(port, one)


def test_pooled_handoff_fault_is_retried_once_and_counted(servers,
                                                          params_path):
    port, _ = servers
    prefill, decode, route, _ = _pool(params_path, afire=_FailTimes(1))
    before = _handoff_counts().get("serve_kv_handoff_retries_total", 0)
    assert _gather(prefill, [PAYLOADS[0]]) == _gather(port, [PAYLOADS[0]])
    assert _handoff_counts()["serve_kv_handoff_retries_total"] - before == 1
    assert route.refreshes == 1
    assert asyncio.run(decode.stats())["injected"] == 1


def test_pooled_handoff_exhaustion_raises_the_attributed_error(params_path):
    prefill, decode, route, _ = _pool(params_path, afire=_FailTimes(99))
    with pytest.raises(RuntimeError, match=r"KV handoff for request req-0 "
                       r"failed after 3 attempts against the decode pool "
                       r"of deployment 'llm'; last error: ConnectionError"):
        asyncio.run(prefill.completions(dict(PAYLOADS[0])))
    assert route.refreshes == 3
    assert not decode.engine.requests


def test_pooled_corrupt_payload_recomputes(servers, params_path):
    """Chunks that cannot land (integer pages) make the decode server
    recompute the prefill: the same tokens."""
    port, _ = servers
    prefill, decode, _, _ = _pool(
        params_path, put=lambda kv: tuple(t.to(torch.int32) for t in kv))
    assert _gather(prefill, PAYLOADS[:2]) == _gather(port, PAYLOADS[:2])
    st = asyncio.run(decode.stats())
    assert st["injected"] == 0 and st["prefills"] == 2


def test_a_prefill_role_without_a_handle_raises(params_path):
    server = LLMServer("tiny", params_path=params_path, engine_config=ECFG,
                       device="cpu")
    with pytest.raises(ValueError, match="ServeHooks"):
        server.configure_pool("prefill", "llm")
    server.configure_pool("decode", "llm")      # no handle needed
    assert server._verify_handle is None


def test_fleet_verify_through_the_hooks_corroborates(params_path,
                                                     monkeypatch):
    """A decode server in fleet-verify mode sends each drafted window to
    the prefill server's verify_draft (a loop in another thread): every
    remote round agrees, and the tokens are the mono server's."""
    import threading

    monkeypatch.setattr(global_config(), "llm_spec_fleet_verify", True)
    monkeypatch.setattr(global_config(), "llm_spec_fleet_verify_timeout_s",
                        60.0)
    spec = {"draft_config": "tiny", "num_draft_tokens": 3, "draft_seed": 1}
    verifier = LLMServer("tiny", params_path=params_path, engine_config=ECFG,
                         device="cpu")
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    class _Verify:
        def route(self, payload, request_id=None, tenant_id=None):
            return asyncio.run_coroutine_threadsafe(
                verifier.verify_draft(payload), loop), None

    def _get(ref, timeout=None):
        return ref.result(timeout) if hasattr(ref, "result") else ref

    try:
        decode = LLMServer(
            "tiny", params_path=params_path, engine_config=ECFG,
            device="cpu", speculation=spec,
            hooks=ServeHooks(get=_get, handle=lambda d, m, pool: _Verify()))
        decode.configure_pool("decode", "llm")
        mono = LLMServer("tiny", params_path=params_path, engine_config=ECFG,
                         device="cpu", speculation=spec)
        want = _gather(mono, [PAYLOADS[0]])
        assert _gather(decode, [PAYLOADS[0]]) == want
        st = asyncio.run(decode.stats())["spec"]
        assert st["remote_rounds"] == st["rounds"] > 0
        assert st["remote_agree"] == st["remote_rounds"]
    finally:
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10)
        loop.close()
    assert not thread.is_alive()


# --- the HF door and the host-plane pieces --------------------------------

def test_server_from_a_ray_tpu_hf_directory(tmp_path):
    """An HF directory written by ray_tpu's save_hf_checkpoint is a model
    source, bf16 and host-int8: the server's tokens are those of an
    engine on the port's own load of it."""
    from ray_tpu.models.hf_interop import save_hf_checkpoint as j_save

    from ray_tpu_torch.models import load_hf_checkpoint

    j_save(j_init(jax.random.PRNGKey(7), JCFG), JCFG, str(tmp_path))
    for quantize in (None, "int8"):
        server = LLMServer(str(tmp_path), engine_config=ECFG, device="cpu",
                           quantize=quantize)
        params, cfg = load_hf_checkpoint(str(tmp_path), quantize=quantize,
                                         device="cpu")
        engine = LLMEngine(params, cfg, EngineConfig(**ECFG), device="cpu")
        want = engine.generate([PAYLOADS[0]["prompt_ids"]], SamplingParams(
            temperature=0.0, max_tokens=9))[0]
        got = _gather(server, [PAYLOADS[0]])[0]["choices"][0]["token_ids"]
        assert got == want, quantize
    named = LLMServer("tiny", init="hf", params_path=str(tmp_path),
                      engine_config=ECFG, device="cpu")
    assert _gather(named, [PAYLOADS[0]])[0]["choices"][0]["token_ids"] == got


class _StubDevice:
    platform = "gpu"

    def __init__(self, i, stats):
        self.id = i
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_publish_hbm_gauges_on_a_stub_device_equals_ray_tpu_s():
    devices = [_StubDevice(0, {"bytes_in_use": 100, "bytes_limit": 1000,
                               "peak_bytes_in_use": 400,
                               "largest_free_block_bytes": 450}),
               _StubDevice(1, None)]
    got = hbm.publish_hbm_gauges("ab12", devices=devices)
    assert got == j_hbm.publish_hbm_gauges("ab12", devices=devices)
    assert got[0]["fragmentation"] == 0.5
    port, ref = metrics.snapshot_local("hbm_"), j_metrics.snapshot_local(
        "hbm_")
    assert port == {k: ref[k] for k in port}
    assert port["hbm_bytes_limit{device=0,node=ab12,platform=gpu}"] == 1000
    assert len(port) == 4


def test_metrics_snapshot_keys_equal_ray_tpu_s():
    """The same calls on both packages' metrics give the same
    snapshot_local keys and values."""
    out = []
    for m in (metrics, j_metrics):
        c = m.Counter("tmetric_c_total", tag_keys=("a",)).set_default_tags(
            {"a": "x"})
        c.inc()
        c.inc(2.5, tags={"t": "y"})
        m.Gauge("tmetric_g").set(7.0, tags={"b": "1"})
        h = m.Histogram("tmetric_h", boundaries=m.LATENCY_BUCKETS,
                        tag_keys=("a",)).set_default_tags({"a": "x"})
        for v in (0.0004, 0.003, 20.0):
            h.observe(v)
        # re-created with the same name and layout: one series
        m.Counter("tmetric_c_total").inc(1.0, tags={"a": "x"})
        with pytest.raises(ValueError):
            c.inc(-1)
        out.append(m.snapshot_local("tmetric_"))
    assert out[0] == out[1]
    assert out[0]["tmetric_c_total{a=x}"] == 2.0
    assert out[0]["tmetric_h{__stat__=count,a=x}"] == 3
    assert out[0]["tmetric_h{a=x,le=0.005}"] == 2
    assert metrics.LATENCY_BUCKETS == j_metrics.LATENCY_BUCKETS


def test_config_flags_have_the_reference_defaults(monkeypatch):
    from ray_tpu._private.config import Config

    from ray_tpu_torch._private.config import DeviceConfig

    ref, port = Config(), DeviceConfig.from_env()
    for name in ("serve_kv_handoff_chunk_bytes", "llm_spec_fleet_verify",
                 "llm_spec_fleet_verify_timeout_s"):
        assert getattr(port, name) == getattr(ref, name), name
    monkeypatch.setenv("RAY_TPU_TORCH_SERVE_KV_HANDOFF_CHUNK_BYTES", "4096")
    monkeypatch.setenv("RAY_TPU_TORCH_LLM_SPEC_FLEET_VERIFY", "1")
    monkeypatch.setenv("RAY_TPU_TORCH_LLM_SPEC_FLEET_VERIFY_TIMEOUT_S", "0.5")
    env = DeviceConfig.from_env()
    assert (env.serve_kv_handoff_chunk_bytes, env.llm_spec_fleet_verify,
            env.llm_spec_fleet_verify_timeout_s) == (4096, True, 0.5)


# --- under ray_tpu's serve -----------------------------------------------

def _ray_tpu_hooks():
    """ServeHooks filled with ray_tpu's host plane: every field is a
    module-level name of ray_tpu, which cloudpickle carries to a replica
    by reference."""
    from ray_tpu._private import failpoints
    from ray_tpu.serve import replica
    from ray_tpu.serve.handle import DeploymentHandle

    return ServeHooks(current_request_id=replica.current_request_id,
                      current_tenant_id=replica.current_tenant_id,
                      put=ray_tpu.put, get=ray_tpu.get,
                      handle=DeploymentHandle, afire=failpoints.afire,
                      metrics=j_metrics)


def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/llm", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.read().decode()


def _serve_cluster(monkeypatch):
    # replica processes import torch: keep them to 2 threads each
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    ray_tpu.init(num_cpus=4)


def _shutdown():
    from ray_tpu import serve

    try:
        serve.shutdown()
    finally:
        ray_tpu.shutdown()


def test_port_server_under_ray_tpu_serve_over_handle_and_http(
        servers, params_path, monkeypatch):
    """serve.run of the port's deployment: a handle call, an HTTP POST and
    a streamed POST give the in-process port server's tokens."""
    port, _ = servers
    want = _gather(port, [PAYLOADS[0]])[0]["choices"][0]["token_ids"]
    _serve_cluster(monkeypatch)
    try:
        from ray_tpu import serve

        handle = serve.run(build_llm_deployment(
            "tiny", deployment=serve.deployment, name="llm",
            params_path=params_path, engine_config=ECFG, device="cpu",
            hooks=_ray_tpu_hooks()))
        out = ray_tpu.get(handle.options(method_name="completions").remote(
            dict(PAYLOADS[0])), timeout=120)
        assert out["choices"][0]["token_ids"] == want
        assert out["choices"][0]["finish_reason"] == "length"
        http = serve.start()
        data = json.loads(_post(http, PAYLOADS[0]))
        assert data["result"]["choices"][0]["token_ids"] == want
        raw = _post(http, {**PAYLOADS[0], "stream": True})
        chunks = [json.loads(line[len("data: "):])
                  for line in raw.strip().split("\n\n")]
        assert [c["token"] for c in chunks] == want
        assert chunks[-1]["finished"] is True
    finally:
        _shutdown()


def test_port_pools_under_ray_tpu_serve_give_the_mono_tokens(
        servers, params_path, monkeypatch):
    """pools={"prefill": 1, "decode": 1}: the KV ships through ray_tpu's
    object store in page chunks (host torch tensors, bf16 bit-equal after
    a put/get) and the decode replica injects without a prefill."""
    port, _ = servers
    want = [b["choices"][0]["token_ids"] for b in _gather(port, PAYLOADS)]
    # two-page chunks, read by the replicas from their environment
    monkeypatch.setenv("RAY_TPU_TORCH_SERVE_KV_HANDOFF_CHUNK_BYTES",
                       str(2 * 2 * 2 * 4 * 2 * 16 * 4))
    _serve_cluster(monkeypatch)
    try:
        from ray_tpu import serve

        kv = torch.randn(2, 3, 4, 2, 16).to(torch.bfloat16)
        back = ray_tpu.get(ray_tpu.put((kv[:, 1:3], kv[:, :1])), timeout=60)
        assert torch.equal(back[0].view(torch.int16),
                           kv[:, 1:3].view(torch.int16))
        assert back[1].dtype == torch.bfloat16
        handle = serve.run(build_llm_deployment(
            "tiny", deployment=serve.deployment, name="llm_kv",
            pools={"prefill": 1, "decode": 1}, params_path=params_path,
            engine_config=ECFG, device="cpu", hooks=_ray_tpu_hooks()))
        completions = handle.options(method_name="completions")
        got = [ray_tpu.get(completions.remote(dict(p)), timeout=120)
               ["choices"][0]["token_ids"] for p in PAYLOADS]
        assert got == want
        decode = serve.get_deployment_handle("llm_kv", pool="decode")
        st = ray_tpu.get(decode.options(method_name="stats").remote(),
                         timeout=60)
        assert st["pool"] == "decode"
        assert st["injected"] == 3 and st["prefills"] == 0, st
    finally:
        _shutdown()
