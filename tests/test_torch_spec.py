"""ray_tpu_torch's speculative decoding against ray_tpu's (CPU, f32).

``accept_prefix`` and ``SpecConfig.parse`` give the same results and
errors; ``verify_step`` the same argmax and pages; the drafter the same
drafts. Engines with a drafter give greedy streams identical to
``ray_tpu``'s and to the port's own engine without one, in the agree
regime (drafter = target) and the reject regime (another drafter), with
the same spec counters. The pooled verify (``snapshot_kv_request`` ->
``remote_verify``) equals the monolithic round. Weights come from
``ray_tpu``'s init through ``params_from_jax``.
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
from ray_tpu.llm.spec_decode import SpecConfig as JSpecConfig
from ray_tpu.llm.spec_decode import SpecDecoder as JSpecDecoder
from ray_tpu.llm.spec_decode import accept_prefix as j_accept_prefix
from ray_tpu.models import LLAMA_CONFIGS as J_CONFIGS
from ray_tpu.models import init_params as j_init
from ray_tpu.ops import rope_frequencies as j_rope

from ray_tpu_torch.llm import (EngineConfig, LLMEngine, SamplingParams,
                               SpecConfig, SpecDecoder, accept_prefix,
                               remote_verify, runner)
from ray_tpu_torch.models import LLAMA_CONFIGS, params_from_jax
from ray_tpu_torch.ops import rope_frequencies

# six xdist workers share the machine's cores
torch.set_num_threads(2)

CFG = LLAMA_CONFIGS["tiny"]
JCFG = J_CONFIGS["tiny"]
ECFG = dict(max_num_seqs=4, page_size=4, num_pages=64, max_seq_len=64)
PROMPTS = [[5, 17, 99, 3, 42], [7, 8, 9], [20, 21, 22, 23, 24, 25, 26]]
# drafter seed 0 is the target itself (every draft agrees); seed 1 is
# another model (drafts nearly always reject)
SEEDS = {"agree": 0, "reject": 1}


@pytest.fixture(scope="module")
def weights():
    """{seed: (jax params, port params)} for the target (0) and the
    reject-regime drafter (1)."""
    out = {}
    for seed in (0, 1):
        jp = j_init(jax.random.PRNGKey(seed), JCFG)
        out[seed] = (jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                         device="cpu"))
    return out


def _spec(regime, k=3):
    return {"draft_config": "tiny", "num_draft_tokens": k,
            "draft_seed": SEEDS[regime]}


def _port_engine(weights, regime=None, k=3, **ecfg):
    eng = LLMEngine(weights[0][1], CFG, EngineConfig(**{**ECFG, **ecfg}),
                    device="cpu")
    if regime is not None:
        eng.enable_speculation(_spec(regime, k),
                               draft_params=weights[SEEDS[regime]][1])
    return eng


def _jax_engine(weights, regime=None, k=3, **ecfg):
    spec = None if regime is None else _spec(regime, k)
    return JLLMEngine(weights[0][0], JCFG, JEngineConfig(
        speculation=spec, **{**ECFG, **ecfg}))


def _greedy(n):
    return SamplingParams(temperature=0.0, max_tokens=n)


def _oracle(weights, prompts, n, **ecfg):
    return _port_engine(weights, **ecfg).generate(prompts, _greedy(n))


# --- accept-prefix and config parsing ---------------------------------------

def test_accept_prefix_matches_jax():
    cases = [([1, 2, 3], [1, 2, 3, 9]), ([1, 2, 3], [1, 2, 7, 9]),
             ([1, 2, 3], [5, 2, 3, 9]), ([], [4])]
    rng = np.random.default_rng(0)
    for _ in range(40):
        k = int(rng.integers(0, 6))
        tgt = rng.integers(0, 3, k + 1).tolist()
        cases.append((rng.integers(0, 3, k).tolist(), tgt))
    for draft, target in cases:
        assert accept_prefix(draft, target) == j_accept_prefix(draft,
                                                               target)
    assert accept_prefix([1, 2, 3], [1, 2, 7, 9]) == [1, 2, 7]
    assert accept_prefix([], [4]) == [4]


@pytest.mark.parametrize("obj", [
    {"num_draft_tokens": 2},
    {"draft_config": "tiny", "bogus": 1},
    "tiny",
    7,
    {"draft_config": "tiny"},
    {"draft_config": "tiny", "num_draft_tokens": 5},
    {"draft_config": "1b", "num_draft_tokens": "4", "draft_seed": 3},
])
def test_spec_config_parse_matches_jax(obj):
    def outcome(cls):
        try:
            sc = cls.parse(obj)
        except (ValueError, TypeError) as e:
            return type(e)
        return (sc.draft_config, sc.num_draft_tokens, sc.draft_seed)

    assert outcome(SpecConfig) == outcome(JSpecConfig)
    sc = SpecConfig(draft_config="tiny")
    assert SpecConfig.parse(sc) is sc


def test_spec_decoder_refuses_what_the_reference_refuses(weights):
    ecfg = EngineConfig(**ECFG)
    for bad, err in (({"draft_config": "no-such-model"}, ValueError),
                     ({"draft_config": 3}, TypeError),
                     ({"draft_config": "tiny", "num_draft_tokens": 0},
                      ValueError)):
        with pytest.raises(err):
            SpecDecoder(CFG, ecfg, bad, device="cpu")
        with pytest.raises(err):
            JSpecDecoder(JCFG, JEngineConfig(**ECFG), bad)
    # a drafter whose vocab cannot cover the target's
    with pytest.raises(ValueError, match="vocab"):
        SpecDecoder(LLAMA_CONFIGS["1b"], ecfg, {"draft_config": "tiny"},
                    device="cpu")
    # a drafter shorter than the engine's sequences
    with pytest.raises(ValueError, match="max_seq"):
        SpecDecoder(CFG, EngineConfig(**{**ECFG, "max_seq_len": 512}),
                    {"draft_config": "tiny"}, device="cpu")
    # draft params on another device than the engine
    meta = jax.tree.map(lambda t: t.to("meta"), weights[0][1])
    with pytest.raises(ValueError, match="live on meta"):
        SpecDecoder(CFG, ecfg, {"draft_config": "tiny"}, draft_params=meta,
                    device="cpu")


# --- verify_step on one cache state -----------------------------------------

NUM_PAGES, PAGE = 24, 4


def _caches(seed):
    rng = np.random.default_rng(seed)
    shape = (CFG.n_layers, NUM_PAGES, PAGE, CFG.n_kv_heads, CFG.head_dim)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _tables():
    cos, sin = rope_frequencies(CFG.head_dim, CFG.max_seq, CFG.rope_theta)
    return (cos, sin), j_rope(JCFG.head_dim, JCFG.max_seq, JCFG.rope_theta)


@pytest.mark.parametrize("greedy", [True, False])
def test_verify_step_matches_jax(weights, greedy):
    """Rows: a full 4-token window straddling a page boundary, a 2-token
    window padded with -1, a 1-token (undrafted) window and an empty row.
    The random cache holds stale rows above every query position (a
    rejected window's leftovers), which must never score."""
    jp, tp = weights[0]
    ck, cv = _caches(7)
    rng = np.random.default_rng(8)
    B, S = 4, 4
    toks = rng.integers(0, CFG.vocab, (B, S)).astype(np.int32)
    pos = np.asarray([[6, 7, 8, 9], [9, 10, -1, -1], [3, -1, -1, -1],
                      [-1, -1, -1, -1]], np.int32)
    bt = np.asarray([[3, 7, 1, 9], [11, 2, 5, 0], [4, 0, 0, 0],
                     [0, 0, 0, 0]], np.int32)
    temp = np.zeros(B, np.float32)        # greedy rows either way
    top_k = np.zeros(B, np.int32)
    top_p = np.ones(B, np.float32)
    (cos, sin), (jc, js) = _tables()
    want, wsamp, wk, wv = jrunner.verify_step(
        jp, jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(toks),
        jnp.asarray(pos), jnp.asarray(bt), jc, js, 0, jnp.asarray(temp),
        jnp.asarray(top_k), jnp.asarray(top_p), cfg=JCFG, greedy=greedy)
    tk, tv = torch.from_numpy(ck), torch.from_numpy(cv)
    got, samp, gk, gv = runner.verify_step(
        tp, tk, tv, torch.from_numpy(toks), torch.from_numpy(pos),
        torch.from_numpy(bt), cos, sin, 0, torch.from_numpy(temp),
        torch.from_numpy(top_k), torch.from_numpy(top_p), cfg=CFG,
        greedy=greedy)
    assert gk is tk and gv is tv                     # updated in place
    assert got.shape == (B, S)
    valid = pos >= 0
    np.testing.assert_array_equal(got.numpy()[valid], np.asarray(want)[valid])
    np.testing.assert_array_equal(samp.numpy()[:3], np.asarray(wsamp)[:3])
    # page 0 is the dump page: padded lanes land there in either order
    np.testing.assert_allclose(gk.numpy()[:, 1:], np.asarray(wk)[:, 1:],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(gv.numpy()[:, 1:], np.asarray(wv)[:, 1:],
                               atol=1e-5, rtol=1e-5)


def test_verify_window_equals_decode_steps(weights):
    """A greedy window's argmax is the greedy decode continuation: verify
    [t0, d1, d2] where d1, d2 are the decode burst's own tokens."""
    tp = weights[0][1]
    ck, cv = _caches(9)
    (cos, sin), _ = _tables()
    bt = torch.tensor([[5, 8, 13, 2]], dtype=torch.int32)
    zf, zi, of = torch.zeros(1), torch.zeros(1, dtype=torch.int32), \
        torch.ones(1)
    toks, _, _ = runner.decode_burst(
        tp, torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()),
        torch.tensor([31]), torch.tensor([6], dtype=torch.int32), bt,
        torch.tensor([True]), cos, sin, 0, zf, zi, of, cfg=CFG, n_steps=3,
        greedy=True)
    window = torch.tensor([[31, int(toks[0, 0]), int(toks[1, 0])]])
    tgt, _, _, _ = runner.verify_step(
        tp, torch.from_numpy(ck), torch.from_numpy(cv), window,
        torch.tensor([[6, 7, 8]], dtype=torch.int32), bt, cos, sin, 0, zf,
        zi, of, cfg=CFG, greedy=True)
    assert tgt[0].tolist() == toks[:, 0].tolist()


# --- the drafter -----------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3])
def test_spec_decoder_drafts_match_jax(weights, k):
    """Warm-up prefill of two slots, then one draft round, on both."""
    spec = {"draft_config": "tiny", "num_draft_tokens": k}
    jd = JSpecDecoder(JCFG, JEngineConfig(**ECFG), spec,
                      draft_params=weights[1][0])
    td = SpecDecoder(CFG, EngineConfig(**ECFG), spec,
                     draft_params=weights[1][1], device="cpu")
    bt = np.zeros((ECFG["max_num_seqs"], 4), np.int32)
    bt[0], bt[2] = [3, 4, 5, 6], [9, 10, 11, 12]
    seqs = {0: [5, 17, 99, 3, 42, 8], 2: [20, 21, 22, 23, 24, 25, 26, 27,
                                          28]}
    items = []
    for slot, seq in seqs.items():
        p = len(seq) - 1                 # the last token is not in the KV
        jd.prefill(seq[:p], bt[slot:slot + 1])
        td.prefill(seq[:p], bt[slot:slot + 1])
        items.append((slot, seq[p - 1], seq[p], p))
    want = jd.draft(items, jnp.asarray(bt))
    got = td.draft(items, torch.from_numpy(bt))
    assert got == want
    assert all(len(d) == k for d in got.values())


# --- engines: greedy streams identical to ray_tpu's and to the oracle -------

_JAX_RUNS = {}


def _run_both(weights, key, regime, k, prompts, n, ecfg):
    """(port streams, port spec stats), after checking them against the
    cached ray_tpu run of the same case."""
    if key not in _JAX_RUNS:
        eng = _jax_engine(weights, regime, k, **ecfg)
        out = eng.generate(prompts, JSamplingParams(temperature=0.0,
                                                    max_tokens=n))
        _JAX_RUNS[key] = (out, eng.spec.stats())
    want, want_stats = _JAX_RUNS[key]
    eng = _port_engine(weights, regime, k, **ecfg)
    got = eng.generate(prompts, _greedy(n))
    assert got == want
    stats = eng.stats()
    assert stats["spec"] == want_stats
    assert stats["free_pages"] == stats["total_pages"] - (
        len(eng.prefix_cache) if eng.prefix_cache else 0)
    return got, stats


@pytest.mark.parametrize("k", [1, 2, 3, 5])
@pytest.mark.parametrize("regime", ["agree", "reject"])
def test_spec_engine_streams_identical_to_jax_and_oracle(weights, regime,
                                                         k):
    got, stats = _run_both(weights, (regime, k), regime, k, PROMPTS, 16, {})
    assert got == _oracle(weights, PROMPTS, 16)
    st = stats["spec"]
    assert st["draft_tokens"] > 0 and st["rounds"] > 0
    assert stats["verify_steps"] > 0
    assert stats["draft_prefills"] >= len(PROMPTS)
    if regime == "agree":
        assert st["acceptance_ratio"] == 1.0
        assert st["rounds"] < 16 * len(PROMPTS)
    else:
        assert st["acceptance_ratio"] < 0.5


def test_spec_page_boundaries_and_prefix_cache(weights):
    """Windows straddling page boundaries over pages shared through the
    prefix cache: the drafter mirrors the target's block tables."""
    shared = list(range(1, 14))
    prompts = [shared + [50], shared + [60]]
    ecfg = dict(max_num_seqs=2, enable_prefix_caching=True)
    got, _ = _run_both(weights, "prefix", "agree", 3, prompts, 16, ecfg)
    assert got == _oracle(weights, prompts, 16, **ecfg)


def test_spec_survives_preemption_pressure(weights):
    """A pool tight enough to force recompute preemption mid-spec: the
    drop resets the drafter's state and the streams still match."""
    ecfg = dict(max_num_seqs=3, page_size=4, num_pages=18, max_seq_len=48)
    prompts = [[1, 2, 3, 4, 5, 6, 7], [11, 12, 13], [21, 22, 23, 24, 25]]
    got, stats = _run_both(weights, "preempt", "reject", 3, prompts, 20,
                           ecfg)
    assert got == _oracle(weights, prompts, 20, **ecfg)
    assert stats["preemptions"] > 0


def test_drafting_stops_near_budget_and_seq_end(weights):
    got, stats = _run_both(weights, "budget1", "agree", 3, [PROMPTS[0]], 1,
                           {})
    assert got == _oracle(weights, [PROMPTS[0]], 1)
    assert stats["spec"]["rounds"] == 0            # nothing was draftable
    # into the max_seq_len wall: the tail falls back to 1 token a round
    got, _ = _run_both(weights, "wall", "agree", 3, [PROMPTS[0]], 40,
                       dict(max_seq_len=24))
    assert got == _oracle(weights, [PROMPTS[0]], 40, max_seq_len=24)


def test_mixed_drafted_undrafted_batch(weights):
    """A sampled request rides the verify window undrafted beside a
    drafted greedy one: the greedy stream equals ray_tpu's and the
    oracle's, and the sampled one runs to its budget."""
    def drive(eng, sp_greedy, sp_sampled):
        g = eng.add_request(list(PROMPTS[0]), sp_greedy)
        s = eng.add_request([9, 9, 9], sp_sampled)
        col = {g: [], s: []}
        while eng.has_unfinished():
            for o in eng.step():
                col[o.request_id].append(o.token)
        return col[g], col[s], eng.spec.stats()

    jg, _, jst = drive(_jax_engine(weights, "agree"),
                       JSamplingParams(temperature=0.0, max_tokens=10),
                       JSamplingParams(temperature=0.8, max_tokens=10))
    g, s, st = drive(_port_engine(weights, "agree"), _greedy(10),
                     SamplingParams(temperature=0.8, max_tokens=10))
    assert g == jg == _oracle(weights, [PROMPTS[0]], 10)[0]
    assert len(s) == 10 and all(0 <= t < CFG.vocab for t in s)
    assert st == jst and st["draft_tokens"] > 0


def test_disable_speculation_returns_to_plain_decode(weights):
    eng = _port_engine(weights, "agree")
    eng.disable_speculation()
    assert eng.generate(PROMPTS, _greedy(8)) == _oracle(weights, PROMPTS, 8)
    assert "spec" not in eng.stats() and eng.stats()["verify_steps"] == 0


# --- pooled verify: snapshot -> remote_verify --------------------------------

def _prefilled(weights, prompt, max_tokens=30):
    eng = _port_engine(weights, "agree")
    rid = eng.add_request(list(prompt), _greedy(max_tokens))
    while eng.requests[rid].ctx_len <= 0:
        eng.step(skip_decode=True)
    return eng, rid


def _drafts(weights):
    cont = _oracle(weights, [PROMPTS[0]], 6)[0]
    return [cont[1:4], [cont[1], 0, 0], [255, 255, 255], []]


def test_pooled_verify_matches_monolithic(weights):
    """snapshot_kv_request -> remote_verify on a second engine returns
    the monolithic verify_request's emission (full accept, partial,
    immediate reject, empty draft), and so does ray_tpu's monolithic
    round; a ray_tpu snapshot (numpy f32) verifies on the port alike."""
    for draft in _drafts(weights):
        engA, rid = _prefilled(weights, PROMPTS[0])
        snap = engA.snapshot_kv_request(rid)
        mono = engA.verify_request(rid, list(draft))
        engB = _port_engine(weights)
        assert remote_verify(engB, snap, list(draft)) == mono, draft
        assert not engB.has_unfinished()
        jeng = _jax_engine(weights, "agree")
        jrid = jeng.add_request(list(PROMPTS[0]), JSamplingParams(
            temperature=0.0, max_tokens=30))
        while jeng.requests[jrid].ctx_len <= 0:
            jeng.step(skip_decode=True)
        jsnap = jeng.snapshot_kv_request(jrid)
        assert jeng.verify_request(jrid, list(draft)) == mono, draft
        assert remote_verify(_port_engine(weights), jsnap,
                             list(draft)) == mono, draft


def test_pooled_verify_corrupt_payload_recompute(weights):
    """A mangled payload falls back to local recompute and still gives
    the monolithic emission."""
    for draft in _drafts(weights)[:3]:
        engA, rid = _prefilled(weights, PROMPTS[0])
        snap = engA.snapshot_kv_request(rid)
        mono = engA.verify_request(rid, list(draft))
        for corrupt in ({"k": None}, {"k": np.zeros((1, 2, 3), np.float32)},
                        {"page_size": 7}):
            engB = _port_engine(weights)
            bad = {**snap, **corrupt}
            assert remote_verify(engB, bad, list(draft)) == mono, corrupt
            assert not engB.has_unfinished()
            assert engB.stats()["prefills"] == 1      # recomputed


def test_snapshot_is_non_destructive(weights):
    eng, rid = _prefilled(weights, PROMPTS[0], max_tokens=8)
    snap = eng.snapshot_kv_request(rid)
    assert snap["ctx_len"] == eng.requests[rid].ctx_len
    assert not eng.requests[rid].finished
    got = list(eng.requests[rid].output)
    while eng.has_unfinished():
        got.extend(o.token for o in eng.step())
    assert got == _oracle(weights, [PROMPTS[0]], 8)[0]


def test_fleet_verify_hook_races_local(weights):
    """The remote-verify hook gets (snapshot, draft) per drafted round;
    its result always agrees, and a failing hook never changes output."""
    want = _oracle(weights, [PROMPTS[0]], 12)
    verifier = _port_engine(weights)
    calls = []

    def hook(payload, draft):
        calls.append(len(draft))
        return remote_verify(verifier, payload, draft)

    eng = _port_engine(weights, "agree")
    eng._spec_remote_verify = hook
    assert eng.generate([list(PROMPTS[0])], _greedy(12)) == want
    assert calls and all(n == 3 for n in calls)
    assert eng.spec.remote_rounds_total == len(calls)
    assert eng.spec.remote_agree_total == eng.spec.remote_rounds_total

    def bad_hook(payload, draft):
        raise RuntimeError("verifier down")

    eng2 = _port_engine(weights, "agree")
    eng2._spec_remote_verify = bad_hook
    assert eng2.generate([list(PROMPTS[0])], _greedy(12)) == want


def test_verify_request_refuses_what_the_reference_refuses(weights):
    eng, rid = _prefilled(weights, PROMPTS[0])
    with pytest.raises(ValueError):
        eng.verify_request("nope", [1])
    sampled = eng.add_request([3, 4], SamplingParams(temperature=0.9,
                                                     max_tokens=4))
    while eng.requests[sampled].ctx_len <= 0:
        eng.step(skip_decode=True)
    with pytest.raises(ValueError, match="greedy"):
        eng.verify_request(sampled, [1])
    eng.abort_request(rid)
    with pytest.raises(ValueError, match="not verifiable"):
        eng.verify_request(rid, [1])
