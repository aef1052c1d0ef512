"""ray_tpu_torch's multi-LoRA serving against ray_tpu's (CPU, f32).

``lora_delta``, the pool's lifecycle and selections, the runner's
``lora`` argument on prefill and on both decode paths, and the engines'
greedy streams with adapters are held against ``ray_tpu``. Adapters are
made by ``ray_tpu.llm.lora.init_lora_adapter`` with a non-zero B drawn
here, and carried across by ``models.convert.lora_from_jax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import EngineConfig as JEngineConfig
from ray_tpu.llm import LLMEngine as JLLMEngine
from ray_tpu.llm import SamplingParams as JSamplingParams
from ray_tpu.llm import runner as jrunner
from ray_tpu.llm.lora import LoRAPool as JLoRAPool
from ray_tpu.llm.lora import init_lora_adapter as j_init_lora
from ray_tpu.llm.lora import lora_delta as j_lora_delta
from ray_tpu.models import LLAMA_CONFIGS as J_CONFIGS
from ray_tpu.models import init_params as j_init
from ray_tpu.ops import rope_frequencies as j_rope

from ray_tpu_torch.llm import (EngineConfig, LLMEngine, LoRAPool,
                               SamplingParams, init_lora_adapter,
                               lora_delta, runner)
from ray_tpu_torch.models import LLAMA_CONFIGS, lora_from_jax, params_from_jax
from ray_tpu_torch.ops import rope_frequencies

# six xdist workers share the machine's cores
torch.set_num_threads(2)

CFG = LLAMA_CONFIGS["tiny"]
JCFG = J_CONFIGS["tiny"]
RANK = 4
ECFG = dict(max_num_seqs=4, page_size=4, num_pages=64, max_seq_len=64,
            lora_rank=RANK)


@pytest.fixture(scope="module")
def weights():
    jp = j_init(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _jax_adapter(seed, scale=1.0):
    """A ray_tpu adapter (numpy leaves) whose B is non-zero, so it acts."""
    a = j_init_lora(jax.random.PRNGKey(seed), JCFG, RANK, scale=scale,
                    dtype=JCFG.dtype)
    for i, name in enumerate(("b_q", "b_v")):
        a[name] = jax.random.normal(jax.random.PRNGKey(seed + 100 + i),
                                    a[name].shape, jnp.float32) * 0.3
    return jax.tree.map(np.asarray, a)


ADAPTERS = {"tuned": (3, 1.0), "other": (5, 0.5)}


@pytest.fixture(scope="module")
def adapters():
    return {name: _jax_adapter(seed, scale)
            for name, (seed, scale) in ADAPTERS.items()}


def _pools(adapters):
    jpool = JLoRAPool(JCFG, RANK, 3, dtype=JCFG.dtype)
    tpool = LoRAPool(CFG, RANK, 3, dtype=CFG.dtype, device="cpu")
    for name, a in adapters.items():
        assert jpool.add(name, a) == tpool.add(name, lora_from_jax(
            a, device="cpu"))
    return jpool, tpool


def _assert_selection_equal(jsel, tsel):
    assert set(jsel) == set(tsel)
    for name in jsel:
        np.testing.assert_array_equal(tsel[name].numpy(),
                                      np.asarray(jsel[name]))


# --- the delta, the adapter and the pool -------------------------------------

def test_lora_delta_matches_jax():
    rng = np.random.default_rng(0)
    B, S, d, r = 3, 5, CFG.dim, RANK
    h = rng.standard_normal((B, S, d)).astype(np.float32)
    for heads in (CFG.n_heads, CFG.n_kv_heads):
        a = rng.standard_normal((B, d, r)).astype(np.float32)
        b = rng.standard_normal((B, r, heads * CFG.head_dim)).astype(
            np.float32)
        scale = np.asarray([1.0, 0.0, 0.5], np.float32)
        want = j_lora_delta(*[jnp.asarray(x) for x in (h, a, b, scale)],
                            heads, CFG.head_dim)
        got = lora_delta(*[torch.from_numpy(x) for x in (h, a, b, scale)],
                         heads, CFG.head_dim)
        assert got.shape == (B, S, heads, CFG.head_dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
        assert not got[1].any()                      # scale 0: exactly 0


def test_init_lora_adapter_and_converter():
    a = init_lora_adapter(CFG, RANK, seed=2, scale=0.5, dtype=torch.float32,
                          device="cpu")
    j = j_init_lora(jax.random.PRNGKey(2), JCFG, RANK, scale=0.5,
                    dtype=JCFG.dtype)
    for name in ("a_q", "b_q", "a_v", "b_v"):
        assert tuple(a[name].shape) == j[name].shape
    assert not a["b_q"].any() and not a["b_v"].any()  # a fresh no-op
    assert a["scale"] == 0.5
    # A ~ N(0, 1/r): the same law as the reference's draw
    assert abs(float(a["a_q"].std()) - RANK ** -0.5) < 0.02
    b = init_lora_adapter(CFG, RANK, seed=2, dtype=torch.float32,
                          device="cpu")
    assert torch.equal(a["a_v"], b["a_v"])           # seeded
    # bf16 leaves cross exactly, the scale becomes a float
    jb = jax.tree.map(np.asarray, j_init_lora(
        jax.random.PRNGKey(1), JCFG, RANK, scale=2.0, dtype=jnp.bfloat16))
    tb = lora_from_jax(jb, device="cpu")
    assert tb["a_q"].dtype == torch.bfloat16 and tb["scale"] == 2.0
    np.testing.assert_array_equal(tb["a_q"].float().numpy(),
                                  jb["a_q"].astype(np.float32))


def test_lora_pool_lifecycle_matches_jax(adapters):
    a = adapters["tuned"]
    jpool = JLoRAPool(JCFG, RANK, 2, dtype=JCFG.dtype)
    tpool = LoRAPool(CFG, RANK, 2, dtype=CFG.dtype, device="cpu")
    ta = lora_from_jax(a, device="cpu")

    def both(fn_j, fn_t):
        outs = []
        for fn in (fn_j, fn_t):
            try:
                outs.append(fn())
            except (ValueError, RuntimeError, KeyError) as e:
                outs.append(type(e))
        assert outs[0] == outs[1]
        return outs[1]

    assert both(lambda: jpool.add("x", a), lambda: tpool.add("x", ta)) == 1
    assert both(lambda: jpool.add("y", a), lambda: tpool.add("y", ta)) == 2
    assert both(lambda: jpool.add("z", a),
                lambda: tpool.add("z", ta)) is RuntimeError     # full
    assert both(lambda: jpool.add("x", a),
                lambda: tpool.add("x", ta)) is ValueError       # loaded
    both(lambda: jpool.remove("x"), lambda: tpool.remove("x"))
    assert both(lambda: jpool.remove("x"),
                lambda: tpool.remove("x")) is KeyError
    assert both(lambda: jpool.add("z", a), lambda: tpool.add("z", ta)) == 1
    assert "z" in tpool and "x" not in tpool and len(tpool) == 2
    assert both(lambda: jpool.slot_of("nope"),
                lambda: tpool.slot_of("nope")) is KeyError
    assert tpool.slot_of(None) == 0
    _assert_selection_equal(jpool.select([0, 2, 1, 0]),
                            tpool.select([0, 2, 1, 0]))
    bad = {**ta, "b_q": ta["b_q"][:, :2]}
    fresh = LoRAPool(CFG, RANK, 2, dtype=CFG.dtype, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        fresh.add("w", bad)
    assert fresh.add("w", ta) == 1       # a refused add takes no slot
    with pytest.raises(ValueError):
        LoRAPool(CFG, RANK, 0, device="cpu")


def test_lora_pool_selection_cache_follows_the_pool(adapters):
    """The pool is updated in place and a selection is a cached copy:
    remove and add must clear the cache, or a later batch would keep
    wearing the old adapter."""
    tpool = LoRAPool(CFG, RANK, 2, dtype=CFG.dtype, device="cpu")
    tpool.add("a", lora_from_jax(adapters["tuned"], device="cpu"))
    ids = [0, tpool.slot_of("a")]
    first = tpool.select(ids)
    assert tpool.select(ids) is first                 # cached
    assert first["scale"].tolist() == [0.0, 1.0]
    tpool.remove("a")
    assert tpool.select(ids)["scale"].tolist() == [0.0, 0.0]
    tpool.add("b", lora_from_jax(adapters["other"], device="cpu"))
    assert tpool.slot_of("b") == ids[1]               # the slot is reused
    now = tpool.select(ids)
    assert now["scale"].tolist() == [0.0, 0.5]
    np.testing.assert_array_equal(now["b_v"][1].numpy(),
                                  adapters["other"]["b_v"])
    assert not now["a_q"][0].any()                    # slot 0 stays zero


# --- runner functions with a selection ---------------------------------------

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
    np.testing.assert_allclose(got_k.numpy()[:, 1:], np.asarray(want_k)[:, 1:],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_v.numpy()[:, 1:], np.asarray(want_v)[:, 1:],
                               atol=1e-5, rtol=1e-5)


def test_prefill_with_lora_matches_jax(weights, adapters):
    """Row 0 wears "tuned", row 1 the zero adapter: logits within 1e-4,
    pages within 1e-5, and the zero-adapter row's logits are bit-equal to
    a prefill without adapters."""
    jp, tp = weights
    jpool, tpool = _pools(adapters)
    ids = [tpool.slot_of("tuned"), 0]
    jsel, tsel = jpool.select(ids), tpool.select(ids)
    _assert_selection_equal(jsel, tsel)
    ck, cv = _caches(1)
    toks = np.random.default_rng(2).integers(0, CFG.vocab, (2, 16)).astype(
        np.int32)
    lens = np.asarray([13, 7], np.int32)
    bt = np.asarray([[3, 7, 1, 9], [11, 2, 0, 0]], np.int32)
    (cos, sin), (jc, js) = _tables()
    want, wk, wv = jrunner.prefill(
        jp, jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(toks),
        jnp.asarray(lens), jnp.asarray(bt), jc, js, jsel, cfg=JCFG)
    args = (torch.from_numpy(toks), torch.from_numpy(lens),
            torch.from_numpy(bt), cos, sin)
    got, gk, gv = runner.prefill(tp, torch.from_numpy(ck),
                                 torch.from_numpy(cv), *args, tsel, cfg=CFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    _assert_pages(gk, gv, wk, wv)
    base, _, _ = runner.prefill(tp, torch.from_numpy(ck.copy()),
                                torch.from_numpy(cv.copy()), *args, None,
                                cfg=CFG)
    assert torch.equal(got[1], base[1])
    assert not torch.allclose(got[0], base[0], atol=1e-3)


@pytest.mark.parametrize("paged", [True, False])
def test_decode_burst_with_lora_matches_jax(weights, adapters, paged):
    jp, tp = weights
    jpool, tpool = _pools(adapters)
    ids = [tpool.slot_of("tuned"), 0, tpool.slot_of("other")]
    jsel, tsel = jpool.select(ids), tpool.select(ids)
    ck, cv = _caches(4)
    B, K = 3, 3
    toks = np.asarray([17, 200, 31], np.int32)
    pos = np.asarray([5, 9, 2], np.int32)
    active = np.asarray([True, True, True])
    bt = np.asarray([[4, 6, 0, 0], [10, 12, 14, 0], [8, 0, 0, 0]], np.int32)
    temp = np.zeros(B, np.float32)
    top_k = np.zeros(B, np.int32)
    top_p = np.ones(B, np.float32)
    (cos, sin), (jc, js) = _tables()
    want, wk, wv = jrunner.decode_burst(
        jp, jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(toks),
        jnp.asarray(pos), jnp.asarray(bt), jnp.asarray(active), jc, js, 0,
        jnp.asarray(temp), jnp.asarray(top_k), jnp.asarray(top_p), jsel,
        cfg=JCFG, n_steps=K, paged_kernel=paged, greedy=True)
    got, gk, gv = runner.decode_burst(
        tp, torch.from_numpy(ck), torch.from_numpy(cv),
        torch.from_numpy(toks), torch.from_numpy(pos), torch.from_numpy(bt),
        torch.from_numpy(active), cos, sin, 0, torch.from_numpy(temp),
        torch.from_numpy(top_k), torch.from_numpy(top_p), tsel, cfg=CFG,
        n_steps=K, paged_kernel=paged, greedy=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _assert_pages(gk, gv, wk, wv)


# --- engines ----------------------------------------------------------------

PROMPT_A = [5, 17, 99, 3]
PROMPT_B = [7, 7, 2, 11, 13]


def _drive(engine, requests, params):
    rids = [engine.add_request(list(p), params, model_id=m)
            for p, m in requests]
    out = {r: [] for r in rids}
    while engine.has_unfinished():
        for o in engine.step():
            out[o.request_id].append(o.token)
    return [out[r] for r in rids]


def _jax_run(weights, adapters, requests, n=8):
    eng = JLLMEngine(weights[0], JCFG, JEngineConfig(**ECFG))
    for name, a in adapters.items():
        eng.add_lora(name, a)
    return _drive(eng, requests, JSamplingParams(temperature=0.0,
                                                 max_tokens=n))


def _port_run(weights, adapters, requests, n=8, paged=True):
    eng = LLMEngine(weights[1], CFG, EngineConfig(**ECFG), device="cpu")
    eng._paged_kernel = paged
    for name, a in adapters.items():
        eng.add_lora(name, lora_from_jax(a, device="cpu"))
    return _drive(eng, requests, SamplingParams(temperature=0.0,
                                                max_tokens=n)), eng


def test_lora_zero_adapter_is_base_model(weights):
    """Requests without a model_id and a fresh adapter (B = 0) both give
    the base model's stream exactly: the port's plain engine's and
    ray_tpu's."""
    prompt = [5, 17, 99, 3, 42, 7, 1]
    sp = SamplingParams(temperature=0.0, max_tokens=8)
    want = LLMEngine(weights[1], CFG, EngineConfig(**{**ECFG, "lora_rank": 0}),
                     device="cpu").generate([prompt], sp)[0]
    jwant = JLLMEngine(weights[0], JCFG, JEngineConfig(
        **{**ECFG, "lora_rank": 0})).generate(
            [prompt], JSamplingParams(temperature=0.0, max_tokens=8))[0]
    assert want == jwant
    eng = LLMEngine(weights[1], CFG, EngineConfig(**ECFG), device="cpu")
    eng.add_lora("fresh", seed=1)
    assert eng.generate([prompt], sp)[0] == want
    assert _drive(eng, [(prompt, "fresh"), (prompt, None)], sp) == [want,
                                                                    want]


@pytest.mark.parametrize("paged", [True, False])
def test_lora_engine_streams_identical_to_jax(weights, adapters, paged):
    """Solo and mixed batches: each stream equals ray_tpu's, an adapter
    changes its stream, and a mixed batch keeps every stream equal to its
    solo run (per-slot isolation)."""
    mixed_reqs = [(PROMPT_A, None), (PROMPT_A, "tuned"), (PROMPT_B, "other"),
                  (PROMPT_B, None)]
    solo = {}
    for p, m in mixed_reqs:
        got, _ = _port_run(weights, adapters, [(p, m)], paged=paged)
        assert got == _jax_run(weights, adapters, [(p, m)])
        solo[tuple(p), m] = got[0]
    assert solo[tuple(PROMPT_A), "tuned"] != solo[tuple(PROMPT_A), None]
    assert solo[tuple(PROMPT_B), "other"] != solo[tuple(PROMPT_B), None]
    mixed, eng = _port_run(weights, adapters, mixed_reqs, paged=paged)
    assert mixed == _jax_run(weights, adapters, mixed_reqs)
    assert mixed == [solo[tuple(p), m] for p, m in mixed_reqs]
    stats = eng.stats()
    assert stats["paged_decode_steps"] == (
        stats["decode_steps"] if paged else 0)


def test_lora_engine_refusals_match_jax(weights, adapters):
    eng = LLMEngine(weights[1], CFG, EngineConfig(**ECFG), device="cpu")
    jeng = JLLMEngine(weights[0], JCFG, JEngineConfig(**ECFG))
    with pytest.raises(KeyError):
        eng.add_request(PROMPT_B, model_id="nope")
    with pytest.raises(KeyError):
        jeng.add_request(PROMPT_B, model_id="nope")
    eng.add_lora("tuned", lora_from_jax(adapters["tuned"], device="cpu"))
    rid = eng.add_request(PROMPT_A, SamplingParams(max_tokens=4),
                          model_id="tuned")
    with pytest.raises(RuntimeError, match="in use"):
        eng.remove_lora("tuned")
    eng.abort_request(rid)
    eng.remove_lora("tuned")
    with pytest.raises(KeyError):
        eng.add_request(PROMPT_A, model_id="tuned")
    plain = LLMEngine(weights[1], CFG, EngineConfig(
        **{**ECFG, "lora_rank": 0}), device="cpu")
    for call in (lambda: plain.add_lora("x"), lambda: plain.remove_lora("x"),
                 lambda: plain.add_request(PROMPT_A, model_id="x")):
        with pytest.raises(ValueError):
            call()
