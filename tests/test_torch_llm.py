"""ray_tpu_torch's serving path against ray_tpu's on the same weights (CPU).

Runner functions are compared on one cache state (logits, written pages,
decode tokens on both decode-attention paths); the engines are compared
by their greedy token streams on ``tiny`` in f32, which must be
identical. Sampling is compared by distribution: the two frameworks'
generators cannot give the same draws.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import EngineConfig as JEngineConfig
from ray_tpu.llm import LLMEngine as JLLMEngine
from ray_tpu.llm import PageAllocator as JPageAllocator
from ray_tpu.llm import SamplingParams as JSamplingParams
from ray_tpu.llm import runner as jrunner
from ray_tpu.llm.cache import PrefixCache as JPrefixCache
from ray_tpu.llm.sampling import sample_from_logits as j_sample
from ray_tpu.models import LLAMA_CONFIGS as J_CONFIGS
from ray_tpu.models import init_params as j_init
from ray_tpu.ops import rope_frequencies as j_rope
from ray_tpu.serve.kv_router import chained_page_keys as j_page_keys

from ray_tpu_torch.llm import (EngineConfig, LLMEngine, PageAllocator,
                               PrefixCache, SamplingParams,
                               chained_page_keys, runner,
                               sample_from_logits)
from ray_tpu_torch.models import LLAMA_CONFIGS, params_from_jax
from ray_tpu_torch.ops import rope_frequencies

# six xdist workers share the machine's cores
torch.set_num_threads(2)

CFG = LLAMA_CONFIGS["tiny"]
JCFG = J_CONFIGS["tiny"]
GREEDY = dict(temperature=0.0)


@pytest.fixture(scope="module")
def weights():
    jp = j_init(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


# --- paging and prefix keys -------------------------------------------------

@pytest.mark.parametrize("page_size", [1, 4, 16])
def test_chained_page_keys_byte_identical(page_size):
    rng = np.random.default_rng(page_size)
    for n in (0, 3, 16, 47, 64):
        toks = rng.integers(0, 2 ** 40, n).tolist()
        want = j_page_keys(toks, page_size)
        assert chained_page_keys(toks, page_size) == want
        assert PrefixCache.page_keys(toks, page_size) == want
        assert JPrefixCache.page_keys(toks, page_size) == want


def test_page_allocator_matches_jax():
    rng = np.random.default_rng(0)
    a, b = PageAllocator(12, 4), JPageAllocator(12, 4)
    held = []
    for _ in range(60):
        if held and rng.random() < 0.4:
            pages = held.pop(int(rng.integers(len(held))))
            a.free(pages)
            b.free(pages)
        else:
            n = int(rng.integers(0, 14))
            assert a.can_allocate(n) == b.can_allocate(n)
            assert a.pages_needed(n) == b.pages_needed(n)
            k = a.pages_needed(n)
            if a.can_allocate(n):
                got = a.allocate(k)
                assert got == b.allocate(k)
                assert 0 not in got
                held.append(got)
        assert a.free_pages == b.free_pages
    with pytest.raises(ValueError):
        a.free([0])


# --- runner functions on one cache state ------------------------------------

NUM_PAGES, PAGE = 24, 4


def _caches(seed):
    rng = np.random.default_rng(seed)
    shape = (CFG.n_layers, NUM_PAGES, PAGE, CFG.n_kv_heads, CFG.head_dim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _tables():
    cos, sin = rope_frequencies(CFG.head_dim, CFG.max_seq, CFG.rope_theta)
    return (cos, sin), j_rope(JCFG.head_dim, JCFG.max_seq, JCFG.rope_theta)


def _assert_pages(got_k, got_v, want_k, want_v):
    # page 0 is the dump page: padded lanes land there in either order
    np.testing.assert_allclose(got_k.numpy()[:, 1:], np.asarray(want_k)[:, 1:],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_v.numpy()[:, 1:], np.asarray(want_v)[:, 1:],
                               atol=1e-5, rtol=1e-5)


def test_prefill_logits_and_pages_match_jax(weights):
    jp, tp = weights
    ck, cv = _caches(1)
    toks = np.random.default_rng(2).integers(0, CFG.vocab, (2, 16)).astype(
        np.int32)
    lens = np.asarray([13, 7], np.int32)
    bt = np.asarray([[3, 7, 1, 9], [11, 2, 0, 0]], np.int32)
    (cos, sin), (jc, js) = _tables()
    want, wk, wv = jrunner.prefill(
        jp, jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(toks),
        jnp.asarray(lens), jnp.asarray(bt), jc, js, cfg=JCFG)
    tk, tv = torch.from_numpy(ck), torch.from_numpy(cv)
    got, gk, gv = runner.prefill(
        tp, tk, tv, torch.from_numpy(toks), torch.from_numpy(lens),
        torch.from_numpy(bt), cos, sin, cfg=CFG)
    assert gk is tk and gv is tv                     # updated in place
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    _assert_pages(gk, gv, wk, wv)


@pytest.mark.parametrize("start,n", [(0, 8), (8, 5), (4, 3)])
def test_prefill_chunk_logits_and_pages_match_jax(weights, start, n):
    jp, tp = weights
    ck, cv = _caches(3)
    C = 8
    toks = np.zeros((1, C), np.int32)
    toks[0, :n] = np.random.default_rng(start).integers(0, CFG.vocab, n)
    bt = np.asarray([[5, 8, 13, 2]], np.int32)
    (cos, sin), (jc, js) = _tables()
    want, wk, wv = jrunner.prefill_chunk(
        jp, jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(toks),
        jnp.int32(start), jnp.int32(n), jnp.asarray(bt), jc, js, cfg=JCFG)
    got, gk, gv = runner.prefill_chunk(
        tp, torch.from_numpy(ck), torch.from_numpy(cv),
        torch.from_numpy(toks), start, n, torch.from_numpy(bt), cos, sin,
        cfg=CFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    _assert_pages(gk, gv, wk, wv)


@pytest.mark.parametrize("paged", [True, False])
def test_decode_burst_tokens_and_pages_match_jax(weights, paged):
    jp, tp = weights
    ck, cv = _caches(4)
    B, K = 3, 3
    toks = np.asarray([17, 200, 0], np.int32)
    pos = np.asarray([5, 9, 0], np.int32)
    active = np.asarray([True, True, False])
    bt = np.asarray([[4, 6, 0, 0], [10, 12, 14, 0], [0, 0, 0, 0]], np.int32)
    temp = np.zeros(B, np.float32)
    top_k = np.zeros(B, np.int32)
    top_p = np.ones(B, np.float32)
    (cos, sin), (jc, js) = _tables()
    want, wk, wv = jrunner.decode_burst(
        jp, jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(toks),
        jnp.asarray(pos), jnp.asarray(bt), jnp.asarray(active), jc, js, 0,
        jnp.asarray(temp), jnp.asarray(top_k), jnp.asarray(top_p),
        cfg=JCFG, n_steps=K, paged_kernel=paged, greedy=True)
    got, gk, gv = runner.decode_burst(
        tp, torch.from_numpy(ck), torch.from_numpy(cv),
        torch.from_numpy(toks), torch.from_numpy(pos), torch.from_numpy(bt),
        torch.from_numpy(active), cos, sin, 0, torch.from_numpy(temp),
        torch.from_numpy(top_k), torch.from_numpy(top_p), cfg=CFG,
        n_steps=K, paged_kernel=paged, greedy=True)
    assert got.shape == (K, B)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _assert_pages(gk, gv, wk, wv)


def test_decode_paths_agree_on_sampled_burst(weights):
    """Both decode-attention paths feed the same logits to the sampler:
    with one seed they draw the same tokens."""
    _, tp = weights
    ck, cv = _caches(5)
    B, K = 2, 4
    args = (torch.tensor([3, 9]), torch.tensor([6, 2], dtype=torch.int32),
            torch.tensor([[7, 9, 0, 0], [1, 0, 0, 0]], dtype=torch.int32),
            torch.tensor([True, True]))
    cos, sin = _tables()[0]
    samp = (torch.full((B,), 0.9), torch.tensor([0, 5], dtype=torch.int32),
            torch.tensor([1.0, 0.8]))
    outs = [runner.decode_burst(
        tp, torch.from_numpy(ck), torch.from_numpy(cv), *args, cos, sin, 11,
        *samp, cfg=CFG, n_steps=K, paged_kernel=paged)[0]
        for paged in (True, False)]
    assert torch.equal(outs[0], outs[1])


# --- the captured decode step (runner.DecodeGraph) ---------------------------

MOE_CFG = dataclasses.replace(CFG, n_experts=4, top_k=2)


@pytest.fixture(scope="module")
def step_params():
    """Tiny dense and tiny MoE params, seeded."""
    from ray_tpu_torch.models.llama import init_params

    return {False: init_params(CFG, seed=5, device="cpu"),
            True: init_params(MOE_CFG, seed=6, device="cpu")}


@pytest.mark.parametrize("moe", [False, True])
@pytest.mark.parametrize("K", [1, 3, 8])
def test_decode_graph_step_equals_decode_burst(step_params, K, moe):
    """The graph's step run without capture on the CPU: static buffers, a
    device step index, K steps over a scratch of width 8 (the burst
    width) and of width K; tokens equal decode_burst's, with an inactive
    row, over two bursts on one set of buffers. The pages after the
    scatter are bit-equal at width K. At width 8 they agree to rounding:
    the plain version on the CPU reduces over the scratch's whole width,
    and a wider scratch orders its sums otherwise (the card's kernel
    reads only the steps so far, and the card test holds the bits)."""
    cfg = MOE_CFG if moe else CFG
    params = step_params[moe]
    cos, sin = _tables()[0]
    bt = torch.tensor([[4, 6, 0, 0, 0, 0], [10, 12, 14, 16, 0, 0],
                       [0, 0, 0, 0, 0, 0], [3, 5, 7, 0, 0, 0]],
                      dtype=torch.int32)
    active = torch.tensor([True, True, False, True])
    samp = (torch.zeros(4), torch.zeros(4, dtype=torch.int32),
            torch.ones(4))
    for width in sorted({K, 8}):
        rng = np.random.default_rng(K)
        ck, cv = (torch.from_numpy(a) for a in _caches(7 + K))
        ck2, cv2 = ck.clone(), cv.clone()
        graph = runner.DecodeGraph(cfg, 4, width, bt.shape[1], ck.dtype,
                                   "cpu")
        for burst in range(2):
            toks = torch.from_numpy(rng.integers(0, cfg.vocab, 4)).to(
                torch.int32)
            pos = torch.tensor([1, 5, 0, 2], dtype=torch.int32) + 8 * burst
            want, _, _ = runner.decode_burst(
                params, ck, cv, toks, pos, bt, active, cos, sin, 0, *samp,
                cfg=cfg, n_steps=K, paged_kernel=True, greedy=True)
            got = graph.run(params, ck2, cv2, toks, pos, bt, active, cos,
                            sin, K)
            assert got.shape == (K, 4)
            assert torch.equal(got, want)
            if width == K:
                assert torch.equal(ck2, ck) and torch.equal(cv2, cv)
            else:
                torch.testing.assert_close(ck2, ck, atol=1e-5, rtol=1e-5)
                torch.testing.assert_close(cv2, cv, atol=1e-5, rtol=1e-5)
        assert graph.graph is None and graph.captures == 0


def _rule_engine(params, case):
    eng = LLMEngine(params, CFG, EngineConfig(
        max_num_seqs=2, page_size=4, num_pages=32, max_seq_len=64,
        lora_rank=4 if case == "lora" else 0), device="cpu")
    if case != "cpu":
        # the rule itself, as it reads on a card
        eng.device = torch.device("cuda")
    return eng


@pytest.mark.parametrize("case,greedy,paged,want", [
    ("cpu", True, True, False), ("sampled", False, True, False),
    ("lora", True, True, False), ("gather", True, False, False),
    ("card", True, True, True)])
def test_decode_graph_eligibility(step_params, case, greedy, paged, want):
    """Only a greedy burst on the paged kernel, on a CUDA card and with
    no LoRA pool, replays the graph; a CPU engine runs every burst
    eagerly and never builds one."""
    eng = _rule_engine(step_params[False], case)
    assert eng._graph_eligible(greedy, paged) is want
    if case == "cpu":
        eng.generate([[5, 17, 99, 3], [8, 8, 2]],
                     SamplingParams(max_tokens=6, **GREEDY))
        st = eng.stats()
        assert st["decode_steps"] > 0 and st["decode_graph_steps"] == 0
        assert st["decode_graph_captures"] == 0 and eng._graph is None


@pytest.mark.parametrize("moe", [False, True])
def test_engine_graph_path_equals_eager_on_cpu(step_params, moe,
                                               monkeypatch):
    """The engine's graph path, let onto the CPU (where the step runs
    without capture), against the eager engine: the same streams and
    pages, with preemptions, a stop token that ends a row
    inside a burst, and every decode step on the graph path."""
    cfg = MOE_CFG if moe else CFG
    params = step_params[moe]
    ecfg = EngineConfig(max_num_seqs=3, page_size=4, num_pages=9,
                        max_seq_len=32, decode_burst=4)
    prompts = [[1, 2, 3, 4, 5, 6, 7], [11, 12, 13], [21, 22, 23, 24, 25]]

    def run(graphed, stop=()):
        eng = LLMEngine(params, cfg, ecfg, device="cpu")
        if graphed:
            monkeypatch.setattr(eng, "_graph_eligible",
                                lambda greedy, paged: greedy and paged)
        out = eng.generate(prompts, SamplingParams(
            max_tokens=16, stop_token_ids=stop, **GREEDY))
        return out, eng

    first, _ = run(False)
    # a stop token that the first stream meets mid-burst
    stop = (first[0][5],)
    want, eager = run(False, stop)
    got, eng = run(True, stop)
    assert got == want
    assert len(got[0]) < 16
    st = eng.stats()
    assert st["preemptions"] > 0
    assert st["decode_graph_steps"] == st["decode_steps"] > 0
    assert eager.stats()["decode_graph_steps"] == 0
    # the graph's scratch is 4 wide, an eager burst's K wide: the CPU's
    # plain attention rounds its sums by the width (see above)
    _assert_pages(eng.cache.k, eng.cache.v, eager.cache.k, eager.cache.v)


# --- sampling ---------------------------------------------------------------

def _kept_probs(logits, temperature, top_k, top_p):
    """The reference sampler's distribution in numpy: top-k, temperature,
    then the nucleus cut, inside the TOP_K_CAP window."""
    order = np.argsort(-logits, kind="stable")
    vals = logits[order]
    if top_k > 0:
        vals = np.where(np.arange(len(vals)) < top_k, vals, -np.inf)
    scaled = vals / max(temperature, 1e-6)
    p = np.exp(scaled - scaled.max())
    p /= p.sum()
    keep = (np.cumsum(p) - p) < top_p
    p = np.where(keep, p, 0.0)
    out = np.zeros_like(logits, dtype=np.float64)
    out[order] = p / p.sum()
    return out


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 4, 1.0), (1.3, 0, 0.6), (0.9, 6, 0.8)])
def test_sampler_distribution_matches_jax(temperature, top_k, top_p):
    V, N = 24, 6000
    logits = np.random.default_rng(0).standard_normal(V).astype(
        np.float32) * 1.5
    batch = np.broadcast_to(logits, (N, V)).copy()
    want = _kept_probs(logits, temperature, top_k, top_p)
    args = (np.full(N, temperature, np.float32), np.full(N, top_k, np.int32),
            np.full(N, top_p, np.float32))
    got = sample_from_logits(torch.from_numpy(batch), 5,
                             *[torch.from_numpy(a) for a in args]).numpy()
    jgot = np.asarray(j_sample(jnp.asarray(batch), 5,
                               *[jnp.asarray(a) for a in args]))
    for draws in (got, jgot):
        assert set(np.unique(draws)) <= set(np.flatnonzero(want))
        freq = np.bincount(draws, minlength=V) / N
        np.testing.assert_allclose(freq, want, atol=0.03)


def test_sampler_greedy_rows_and_seeding():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((6, 300)).astype(np.float32)
    temp = np.asarray([0, 0.8, 0, 1.0, 0, 2.0], np.float32)
    top_k = np.asarray([0, 0, 3, 0, 0, 10], np.int32)
    top_p = np.asarray([1, 1, 1, 0.5, 0.9, 1], np.float32)
    targs = [torch.from_numpy(a) for a in (logits, temp, top_k, top_p)]
    a = sample_from_logits(targs[0], 3, *targs[1:])
    j = np.asarray(j_sample(*[jnp.asarray(x) for x in
                              (logits, np.int32(3), temp, top_k, top_p)]))
    greedy = temp == 0
    np.testing.assert_array_equal(a.numpy()[greedy], j[greedy])
    np.testing.assert_array_equal(a.numpy()[greedy],
                                  logits.argmax(-1)[greedy])
    assert torch.equal(a, sample_from_logits(targs[0], 3, *targs[1:]))
    draws = {tuple(sample_from_logits(targs[0], s, *targs[1:]).tolist())
             for s in range(8)}
    assert len(draws) > 1


# --- engines: greedy token streams identical to ray_tpu's --------------------

# name -> (engine config, [(arrival step, prompt)], max_tokens)
SCENARIOS = {
    "batch_page_boundaries": (
        dict(max_num_seqs=4, page_size=4, num_pages=64, max_seq_len=64),
        [(0, [5, 17, 99]), (0, [3, 42, 7, 1, 88, 23, 11]), (0, [2, 9]),
         (0, [1, 2, 3, 4]), (0, [250, 8, 8, 8, 8, 8, 8, 8, 31])], 9),
    "staggered_arrivals": (
        dict(max_num_seqs=2, page_size=4, num_pages=64, max_seq_len=64,
             decode_burst=3),
        [(0, [5, 17, 99, 3]), (3, [42, 7]), (5, [9, 9, 1])], 8),
    "chunked_prefill": (
        dict(max_num_seqs=2, page_size=4, num_pages=64, max_seq_len=64,
             prefill_chunk=4, decode_burst=2),
        [(0, [4, 8, 15, 16, 23]),
         (2, [5, 17, 99, 3, 42, 7, 1, 88, 23, 11, 2, 9, 31])], 8),
    "prefix_caching": (
        dict(max_num_seqs=2, page_size=4, num_pages=64, max_seq_len=64,
             enable_prefix_caching=True),
        [(0, [7, 1, 4, 2, 8, 5, 7, 1, 9, 3]),
         (6, [7, 1, 4, 2, 8, 5, 7, 1, 11]),
         (6, [7, 1, 4, 2, 6])], 6),
    "preemption": (
        # 8 usable pages: one sequence fits, three must take turns
        dict(max_num_seqs=3, page_size=4, num_pages=9, max_seq_len=32),
        [(0, [1, 2, 3, 4, 5, 6, 7]), (0, [11, 12, 13]),
         (0, [21, 22, 23, 24, 25])], 16),
}

_JAX_STREAMS = {}


def _drive(engine, arrivals, params):
    pending = sorted(enumerate(arrivals), key=lambda a: a[1][0])
    ids = [None] * len(arrivals)
    step = 0
    while pending or engine.has_unfinished():
        while pending and pending[0][1][0] <= step:
            i, (_, prompt) = pending.pop(0)
            ids[i] = engine.add_request(prompt, params)
        engine.step()
        step += 1
    return [engine.requests[r].output for r in ids]


def _jax_streams(weights, name):
    if name not in _JAX_STREAMS:
        ecfg, arrivals, n = SCENARIOS[name]
        eng = JLLMEngine(weights[0], JCFG, JEngineConfig(**ecfg))
        _JAX_STREAMS[name] = _drive(
            eng, arrivals, JSamplingParams(max_tokens=n, **GREEDY))
    return _JAX_STREAMS[name]


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_greedy_streams_identical_to_jax(weights, name, paged):
    ecfg, arrivals, n = SCENARIOS[name]
    want = _jax_streams(weights, name)
    eng = LLMEngine(weights[1], CFG, EngineConfig(**ecfg), device="cpu")
    eng._paged_kernel = paged
    got = _drive(eng, arrivals, SamplingParams(max_tokens=n, **GREEDY))
    assert got == want
    assert all(len(o) == n for o in got)
    stats = eng.stats()
    assert stats["free_pages"] == stats["total_pages"] - (
        len(eng.prefix_cache) if eng.prefix_cache else 0)
    assert stats["paged_decode_steps"] == (
        stats["decode_steps"] if paged else 0)
    if name == "preemption":
        assert stats["preemptions"] > 0
    if name == "chunked_prefill":
        assert stats["prefill_chunks"] == 2 + 4 and stats["prefills"] == 0
    if name == "prefix_caching":
        assert len(eng.prefix_cache) > 0
        assert max(s.cached_tokens for s in eng.requests.values()) >= 4


def test_top_k_one_is_greedy(weights):
    prompts = [[5, 17, 99, 3], [8, 8, 2]]
    want = _drive(JLLMEngine(weights[0], JCFG, JEngineConfig(
        max_num_seqs=2, page_size=4, num_pages=32, max_seq_len=64)),
        [(0, p) for p in prompts],
        JSamplingParams(max_tokens=6, **GREEDY))
    eng = LLMEngine(weights[1], CFG, EngineConfig(
        max_num_seqs=2, page_size=4, num_pages=32, max_seq_len=64),
        device="cpu")
    got = eng.generate(prompts, SamplingParams(temperature=0.7, top_k=1,
                                               max_tokens=6))
    assert got == want


def test_engine_sampled_requests_finish_and_stop_tokens(weights):
    eng = LLMEngine(weights[1], CFG, EngineConfig(
        max_num_seqs=4, page_size=4, num_pages=64, max_seq_len=64),
        device="cpu")
    outs = eng.generate([[5, 17, 99]] * 3, SamplingParams(
        temperature=1.5, max_tokens=12))
    assert all(len(o) == 12 for o in outs)
    assert not (outs[0] == outs[1] == outs[2])
    ref = eng.generate([[5, 17, 99, 3]], SamplingParams(
        max_tokens=10, **GREEDY))[0]
    rid = eng.add_request([5, 17, 99, 3], SamplingParams(
        max_tokens=10, stop_token_ids=(ref[4],), **GREEDY))
    while eng.has_unfinished():
        eng.step()
    st = eng.requests[rid]
    assert st.finish_reason == "stop"
    assert st.output == ref[:ref.index(ref[4]) + 1]


def test_engine_abort_frees_pages(weights):
    eng = LLMEngine(weights[1], CFG, EngineConfig(
        max_num_seqs=2, page_size=4, num_pages=32, max_seq_len=32),
        device="cpu")
    free0 = eng.allocator.free_pages
    a = eng.add_request([1, 2, 3, 4, 5], SamplingParams(max_tokens=20,
                                                        **GREEDY))
    b = eng.add_request([6, 7], SamplingParams(max_tokens=20, **GREEDY))
    eng.step()
    eng.abort_request(a)
    eng.abort_request(b)
    assert eng.requests[a].finish_reason == "aborted"
    assert not eng.has_unfinished()
    assert eng.allocator.free_pages == free0


def test_engine_refuses_what_is_not_ported(weights):
    """Nothing is refused as not ported any more: an MoE engine serves
    the reference's greedy streams. The reference's own guards raise
    ValueError on both packages."""
    import dataclasses

    base = dict(max_num_seqs=2, page_size=4, num_pages=32, max_seq_len=32)
    jmoe = dataclasses.replace(JCFG, n_experts=4)
    jp = j_init(jax.random.PRNGKey(3), jmoe)
    prompts = [[5, 17, 99, 3], [8, 1, 2]]
    got = LLMEngine(params_from_jax(jax.tree.map(np.asarray, jp),
                                    device="cpu"),
                    dataclasses.replace(CFG, n_experts=4),
                    EngineConfig(**base), device="cpu").generate(
        prompts, SamplingParams(max_tokens=6, **GREEDY))
    want = JLLMEngine(jp, jmoe, JEngineConfig(**base)).generate(
        prompts, JSamplingParams(max_tokens=6, **GREEDY))
    assert got == want
    spec = {"draft_config": "tiny", "num_draft_tokens": 2}
    for bad in (dict(lora_rank=4, enable_prefix_caching=True),
                dict(lora_rank=4, prefill_chunk=8),
                dict(lora_rank=4, speculation=spec),
                dict(speculation={"draft_config": "no-such-model"}),
                dict(speculation={"num_draft_tokens": 2})):
        with pytest.raises(ValueError):
            LLMEngine(weights[1], CFG, EngineConfig(**base, **bad),
                      device="cpu")
        with pytest.raises(ValueError):
            JLLMEngine(weights[0], JCFG, JEngineConfig(**base, **bad))
    eng = LLMEngine(weights[1], CFG, EngineConfig(**base), device="cpu")
    with pytest.raises(ValueError):
        eng.add_request([1, 2], model_id="adapter")
    with pytest.raises(ValueError):
        eng.add_request([])


def test_engine_int8_weights_identical_to_jax(weights):
    """w8a16 weights (quant.quantize_params) through every projection,
    the embedding and the lm_head: same greedy streams as ray_tpu."""
    from ray_tpu.ops.quant import quantize_params as j_quantize

    jq = j_quantize(jax.tree.map(np.asarray, weights[0]))
    ecfg = dict(max_num_seqs=2, page_size=4, num_pages=32, max_seq_len=32)
    arrivals = [(0, [5, 17, 99, 3]), (0, [8, 8, 2, 40, 41, 42])]
    want = _drive(JLLMEngine(jax.tree.map(jnp.asarray, jq), JCFG,
                             JEngineConfig(**ecfg)),
                  arrivals, JSamplingParams(max_tokens=7, **GREEDY))
    tq = params_from_jax(jq, device="cpu")
    assert tq["layers"]["wq"]["q"].dtype == torch.int8
    got = _drive(LLMEngine(tq, CFG, EngineConfig(**ecfg), device="cpu"),
                 arrivals, SamplingParams(max_tokens=7, **GREEDY))
    assert got == want


def test_serving_params_that_require_grad_builds_no_graph(weights):
    """Params as a trainer leaves them (requires_grad set): the serving
    entry points run under inference_mode, so prefill and decode build no
    graph, and the engine's greedy streams are those of plain params."""
    tp = weights[1]
    graded = jax.tree.map(lambda t: t.detach().clone().requires_grad_(), tp)
    prompts = [[5, 17, 99, 3], [8, 8, 2, 41, 7]]
    ecfg = EngineConfig(max_num_seqs=2, page_size=4, num_pages=32,
                        max_seq_len=64)
    sp = SamplingParams(max_tokens=6, **GREEDY)
    want = LLMEngine(tp, CFG, ecfg, device="cpu").generate(prompts, sp)
    assert LLMEngine(graded, CFG, ecfg, device="cpu").generate(
        prompts, sp) == want
    ck, cv = _caches(1)
    (cos, sin), _ = _tables()
    logits, _, _ = runner.prefill(
        graded, torch.from_numpy(ck), torch.from_numpy(cv),
        torch.tensor([[5, 17, 99, 3]], dtype=torch.int32),
        torch.tensor([4], dtype=torch.int32),
        torch.tensor([[1, 2]], dtype=torch.int32), cos, sin, cfg=CFG)
    assert logits.grad_fn is None and not logits.requires_grad
