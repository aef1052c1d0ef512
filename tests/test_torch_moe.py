"""ray_tpu_torch's MoE Llama against ray_tpu's on the same inputs (CPU).

``ops/moe.py`` (top-k, dispatch with capacity drops, the routed MLP and
the exact serving mixture), the MoE model (``forward`` with its aux
loss, ``lm_loss`` and its gradients), the serving paths (the engine's
greedy streams: plain, chunked, paged and gather decode, speculative,
with a LoRA, exported then injected) and three AdamW steps. Inputs are
made with numpy or by ray_tpu's init and carried over with
``params_from_jax``; the port runs with ``device="cpu"``. Comparisons are
in f32 unless a test says otherwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from ray_tpu.llm import EngineConfig as JEngineConfig
from ray_tpu.llm import LLMEngine as JLLMEngine
from ray_tpu.llm import SamplingParams as JSamplingParams
from ray_tpu.llm import runner as jrunner
from ray_tpu.models import LLAMA_CONFIGS as J_CONFIGS
from ray_tpu.models import forward as j_forward
from ray_tpu.models import init_params as j_init
from ray_tpu.models import lm_loss as j_lm_loss
from ray_tpu.models import param_logical_axes
from ray_tpu.ops import moe as jmoe
from ray_tpu.ops import quant as jq
from ray_tpu.ops import rope_frequencies as j_rope
from ray_tpu.parallel import MeshSpec, build_mesh
from ray_tpu.train import make_train_step as j_make_train_step

from ray_tpu_torch.llm import EngineConfig, LLMEngine, SamplingParams, runner
from ray_tpu_torch.models import (LLAMA_CONFIGS, forward, init_params,
                                  lm_loss, params_from_jax, params_to_numpy,
                                  unstack_layers)
from ray_tpu_torch.ops import moe
from ray_tpu_torch.ops import rope_frequencies
from ray_tpu_torch.ops.quant import init_params_quantized, quantize_params
from ray_tpu_torch.train import adamw, make_train_step

# six xdist workers share the machine's cores
torch.set_num_threads(2)

CFG = dataclasses.replace(LLAMA_CONFIGS["tiny"], n_experts=4, top_k=2)
JCFG = dataclasses.replace(J_CONFIGS["tiny"], n_experts=4, top_k=2)
F32 = dict(atol=1e-5, rtol=1e-5)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, node in enumerate(tree):
            yield from _leaves(node, prefix + (i,))
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def weights():
    jp = j_init(jax.random.PRNGKey(1), JCFG)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _expert_weights(seed, T=32, D=8, M=16, E=4):
    """(x (2, T/2, D), router (D, E), w_gate, w_up (E, D, M), w_down
    (E, M, D)) as f32 numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, T // 2, D)).astype(np.float32),
            (rng.standard_normal((D, E)) * 0.5).astype(np.float32),
            (rng.standard_normal((E, D, M)) * 0.2).astype(np.float32),
            (rng.standard_normal((E, D, M)) * 0.2).astype(np.float32),
            (rng.standard_normal((E, M, D)) * 0.2).astype(np.float32))


def _gates(seed, T=32, E=4):
    logits = np.random.default_rng(seed).standard_normal((T, E))
    return np.array(jax.nn.softmax(jnp.asarray(logits, jnp.float32)))


# --- ops/moe.py --------------------------------------------------------------

def test_one_hot_gives_zero_rows_out_of_range():
    """jax.nn.one_hot's zero row for an index of -1 or at or past n,
    where torch.nn.functional.one_hot raises."""
    idx = np.asarray([[-1, 0, 3], [4, 7, 2]], np.int32)
    want = np.asarray(jax.nn.one_hot(idx, 4, dtype=jnp.float32))
    got = moe._one_hot(torch.from_numpy(idx), 4, torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0].sum() == 0 and got[1, 0].sum() == 0
    with pytest.raises(RuntimeError):
        torch.nn.functional.one_hot(torch.from_numpy(idx).long(), 4)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_mask_matches_jax_with_ties(k):
    """Iterative argmax: the same experts as the reference, ties to the
    lowest index (rows 0-2 are built from ties)."""
    probs = _gates(0, T=16, E=6)
    probs[0] = 1 / 6
    probs[1] = [0.3, 0.1, 0.3, 0.1, 0.1, 0.1]
    probs[2] = [0.1, 0.2, 0.2, 0.2, 0.2, 0.1]
    want = np.asarray(jmoe._top_k_mask(jnp.asarray(probs), k))
    got = moe._top_k_mask(torch.from_numpy(probs), k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.sum(-1) == k).all()


@pytest.mark.parametrize("capacity", [1, 8, 16, 64])
def test_moe_dispatch_matches_jax(capacity):
    """Same masks and buffer positions (dispatch bit-equal), combine and
    aux to 1e-6; capacity 1 and 8 drop tokens (32 tokens, top-2 of 4)."""
    gates = _gates(capacity)
    want = [np.asarray(a) for a in jmoe.moe_dispatch(
        jnp.asarray(gates), top_k=2, capacity=capacity)]
    got = [a.numpy() for a in moe.moe_dispatch(
        torch.from_numpy(gates), top_k=2, capacity=capacity)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got[2], want[2], atol=1e-6, rtol=1e-6)
    dispatch, combine = got[0], got[1]
    assert dispatch.sum(axis=(0, 2)).max() <= capacity
    admitted = dispatch.sum(axis=(1, 2))
    dropped = 2 - admitted
    if capacity < 16:
        assert dropped.sum() > 0
    # combine weights are zero exactly where dispatch dropped, and a
    # token admitted nowhere has no combine weight
    assert np.abs(combine * (1.0 - dispatch)).max() == 0.0
    assert np.abs(combine.sum(axis=(1, 2)) * (admitted == 0)).max() == 0.0


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, 8.0])
def test_moe_mlp_matches_jax_f32(capacity_factor):
    """The routed MLP and its aux loss at 1e-5 relative, with drops at
    capacity factors 0.5 and 1.25."""
    args = _expert_weights(int(capacity_factor * 4))
    want_out, want_aux = jmoe.moe_mlp(*map(jnp.asarray, args), top_k=2,
                                      capacity_factor=capacity_factor)
    out, aux = moe.moe_mlp(*map(torch.from_numpy, args), top_k=2,
                           capacity_factor=capacity_factor,
                           csl=lambda a, axes: a)
    assert out.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **F32)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-5)


def test_moe_mlp_with_ample_capacity_equals_the_dense_mixture():
    args = [torch.from_numpy(a) for a in _expert_weights(3)]
    out, _ = moe.moe_mlp(*args, top_k=2, capacity_factor=8.0)
    np.testing.assert_allclose(out.numpy(),
                               moe.moe_mlp_dense(*args, top_k=2).numpy(),
                               **F32)


def _bf16(a):
    return a.astype(ml_dtypes.bfloat16)


def _to_torch_bf16(a):
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def test_moe_mlp_bf16_matches_jax():
    """bf16 x and experts (f32 router): out and aux within the
    reference's bf16 tolerance, 2e-2."""
    x, rw, wg, wu, wd = _expert_weights(5)
    xs = [_bf16(x), rw, _bf16(wg), _bf16(wu), _bf16(wd)]
    want_out, want_aux = jmoe.moe_mlp(*map(jnp.asarray, xs), top_k=2,
                                      capacity_factor=1.25)
    tx = [_to_torch_bf16(xs[0]), torch.from_numpy(rw)] + [
        _to_torch_bf16(a) for a in xs[2:]]
    out, aux = moe.moe_mlp(*tx, top_k=2, capacity_factor=1.25)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want_out, np.float32),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moe_mlp_dense_matches_jax(dtype):
    """The exact mixture in f32 from the stored weights: 1e-5 relative in
    f32; with bf16 x and experts, the same f32 math, cast to bf16 at the
    end, within 2e-2."""
    x, rw, wg, wu, wd = _expert_weights(6)
    if dtype == "bf16":
        jx = [_bf16(x), rw, _bf16(wg), _bf16(wu), _bf16(wd)]
        tx = [_to_torch_bf16(jx[0]), torch.from_numpy(rw)] + [
            _to_torch_bf16(a) for a in jx[2:]]
        tol = dict(atol=2e-2, rtol=2e-2)
    else:
        jx, tx, tol = [x, rw, wg, wu, wd], None, F32
        tx = [torch.from_numpy(a) for a in jx]
    want = np.asarray(jmoe.moe_mlp_dense(*map(jnp.asarray, jx), top_k=2),
                      np.float32)
    got = moe.moe_mlp_dense(*tx, top_k=2)
    assert got.dtype == tx[0].dtype
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    assert moe.moe_mlp_dense is moe.moe_mlp_oracle


# --- the model ---------------------------------------------------------------

def test_moe_init_has_jax_tree_shapes_and_dtypes():
    """The MoE tree at Mixtral-8x7B widths (2 layers, meta device): the
    reference's leaves, shapes and dtypes, the router in f32."""
    jc = dataclasses.replace(J_CONFIGS["8b"], vocab=32000, n_layers=2,
                             n_experts=8, top_k=2)
    tc = dataclasses.replace(LLAMA_CONFIGS["8b"], vocab=32000, n_layers=2,
                             n_experts=8, top_k=2)
    want = jax.eval_shape(lambda k: j_init(k, jc), jax.random.PRNGKey(0))
    got = init_params(tc, device="meta")
    want_l, got_l = list(_leaves(want)), list(_leaves(got))
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, w), (_, g) in zip(want_l, got_l):
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).split(".")[-1] == jnp.dtype(w.dtype).name, path
    assert got["layers"]["router"].dtype == torch.float32
    assert sum(g.numel() for _, g in got_l) == tc.n_params() == jc.n_params()
    small = init_params(CFG, seed=1, device="cpu")
    w = small["layers"]["w_gate"]
    assert w.shape == (2, 4, 64, 128)
    assert abs(float(w.std()) * CFG.dim ** 0.5 - 1.0) < 0.1
    assert not torch.equal(w[0, 0], w[0, 1])


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_moe_forward_logits_and_aux_match_jax(weights, remat):
    """Logits and the summed aux loss at 1e-4, without remat and under
    both remat policies (the aux sum crosses torch.utils.checkpoint)."""
    toks = np.random.default_rng(9).integers(
        0, CFG.vocab, (2, 20)).astype(np.int32)
    want, want_aux = j_forward(weights[0], jnp.asarray(toks), JCFG,
                               return_aux=True)
    cfg = (CFG if remat == "none" else dataclasses.replace(
        CFG, remat=True, remat_policy=remat))
    params = unstack_layers(params_from_jax(
        jax.tree.map(np.asarray, weights[0]), device="cpu"))
    for lp in params["layers"]:
        for v in lp.values():
            v.requires_grad_()
    logits, aux = forward(params, torch.from_numpy(toks), cfg,
                          return_aux=True)
    assert aux.dtype == torch.float32 and aux.requires_grad
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-4)
    # without return_aux, the logits alone
    assert torch.equal(forward(params, torch.from_numpy(toks), cfg).detach(),
                       logits.detach())


def _batch(seed, with_mask, seq=24):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, CFG.vocab, (2, seq)).astype(np.int32)}
    if with_mask:
        mask = np.ones((2, seq), np.int32)
        mask[0, seq // 2:] = 0
        mask[1, :3] = 0
        batch["mask"] = mask
    return batch


@pytest.mark.parametrize("with_mask,capacity_factor",
                         [(False, 2.0), (True, 2.0), (True, 0.5)])
def test_moe_lm_loss_and_grads_match_jax(weights, with_mask,
                                         capacity_factor):
    """lm_loss (z-loss, mask, aux_loss_coef * aux) and the gradient of
    every leaf, the f32 router included, at 1e-4; capacity factor 0.5
    drops tokens."""
    jc = dataclasses.replace(JCFG, capacity_factor=capacity_factor)
    tc = dataclasses.replace(CFG, capacity_factor=capacity_factor)
    batch = _batch(30 + with_mask, with_mask)
    want_loss, want_g = jax.value_and_grad(j_lm_loss)(
        weights[0], {k: jnp.asarray(v) for k, v in batch.items()}, jc)
    params = params_from_jax(jax.tree.map(np.asarray, weights[0]),
                             device="cpu")
    leaves = {p: v.requires_grad_() for p, v in _leaves(params)}
    loss = lm_loss(params, {k: torch.from_numpy(v)
                            for k, v in batch.items()}, tc)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    assert grads[("layers", "router")].dtype == torch.float32
    assert grads[("layers", "router")].abs().max() > 0
    for path, w in _leaves(jax.tree.map(np.asarray, want_g)):
        np.testing.assert_allclose(grads[path].numpy(), w, atol=1e-4,
                                   rtol=1e-4, err_msg=str(path))


def test_moe_all_masked_loss_is_coef_times_aux(weights):
    """With every position masked, the MoE loss is aux_loss_coef * aux
    (the aux term is added after masking), as in the reference."""
    batch = _batch(33, True)
    batch["mask"][:] = 0
    params = params_from_jax(jax.tree.map(np.asarray, weights[0]),
                             device="cpu")
    loss = lm_loss(params, {k: torch.from_numpy(v)
                            for k, v in batch.items()}, CFG)
    want = j_lm_loss(weights[0], {k: jnp.asarray(v)
                                  for k, v in batch.items()}, JCFG)
    _, aux = forward(params, torch.from_numpy(batch["tokens"]), CFG,
                     return_aux=True)
    assert loss.item() > 0
    np.testing.assert_allclose(loss.item(), CFG.aux_loss_coef * aux.item(),
                               rtol=1e-6)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-4)


def test_int8_quantization_of_moe_still_raises(weights):
    """Expert weights are not quantized, in the port as in ray_tpu."""
    for fn, tree, cfg in ((quantize_params, weights[1], CFG),
                          (jq.quantize_params, weights[0], JCFG)):
        with pytest.raises(NotImplementedError):
            fn(tree, cfg)
    with pytest.raises(NotImplementedError):
        init_params_quantized(CFG, device="meta")
    with pytest.raises(NotImplementedError):
        jq.init_params_quantized(jax.random.PRNGKey(0), JCFG)


# --- the runner on one cache state --------------------------------------------

NUM_PAGES, PAGE = 24, 4


def test_moe_prefill_and_decode_match_jax(weights):
    """prefill's logits and the decode burst's tokens on both attention
    paths against ray_tpu's runner, through moe_mlp_dense."""
    jp, tp = weights
    rng = np.random.default_rng(4)
    shape = (CFG.n_layers, NUM_PAGES, PAGE, CFG.n_kv_heads, CFG.head_dim)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    toks = rng.integers(0, CFG.vocab, (2, 16)).astype(np.int32)
    lens = np.asarray([13, 7], np.int32)
    bt = np.asarray([[3, 7, 1, 9], [11, 2, 0, 0]], np.int32)
    cos, sin = rope_frequencies(CFG.head_dim, CFG.max_seq, CFG.rope_theta)
    jc, js = j_rope(JCFG.head_dim, JCFG.max_seq, JCFG.rope_theta)
    want, wk, wv = jrunner.prefill(
        jp, jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(toks),
        jnp.asarray(lens), jnp.asarray(bt), jc, js, cfg=JCFG)
    got, gk, gv = runner.prefill(
        tp, torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()),
        torch.from_numpy(toks), torch.from_numpy(lens),
        torch.from_numpy(bt), cos, sin, cfg=CFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(gk.numpy()[:, 1:], np.asarray(wk)[:, 1:],
                               **F32)
    pos = torch.from_numpy(lens)
    samp = (torch.zeros(2), torch.zeros(2, dtype=torch.int32), torch.ones(2))
    outs = []
    for paged in (True, False):
        out, _, _ = runner.decode_burst(
            tp, gk.clone(), gv.clone(), got.argmax(-1), pos,
            torch.from_numpy(bt), torch.ones(2, dtype=torch.bool), cos, sin,
            0, *samp, cfg=CFG, n_steps=3, paged_kernel=paged, greedy=True)
        outs.append(out)
    assert torch.equal(outs[0], outs[1])


# --- the engine ----------------------------------------------------------------

ECFG = dict(max_num_seqs=2, page_size=4, num_pages=64, max_seq_len=64)
PROMPTS = [[5, 17, 99, 3, 42], [7, 8, 9, 10, 11, 12, 13, 14, 15]]
N = 8


def _port_engine(weights, **ecfg):
    return LLMEngine(weights[1], CFG, EngineConfig(**{**ECFG, **ecfg}),
                     device="cpu")


def _jax_engine(weights, **ecfg):
    return JLLMEngine(weights[0], JCFG, JEngineConfig(**{**ECFG, **ecfg}))


def _greedy(n=N):
    return SamplingParams(temperature=0.0, max_tokens=n)


def _jgreedy(n=N):
    return JSamplingParams(temperature=0.0, max_tokens=n)


@pytest.fixture(scope="module")
def jax_streams(weights):
    return _jax_engine(weights).generate(PROMPTS, _jgreedy())


def test_moe_engine_streams_identical_to_jax(weights, jax_streams):
    """Plain engine: the greedy streams equal ray_tpu's, and each is what
    a fresh whole-prompt prefill of every prefix gives (the reference's
    decode-vs-prefill oracle, tests/test_llm.py)."""
    got = _port_engine(weights).generate(PROMPTS, _greedy())
    assert got == jax_streams
    oracle = _port_engine(weights)
    prefix = list(PROMPTS[0])
    for tok in got[0]:
        assert oracle.generate([prefix], _greedy(1))[0] == [tok]
        prefix.append(tok)


def test_moe_engine_chunked_prefill_identical_to_jax(weights, jax_streams):
    got = _port_engine(weights, prefill_chunk=4).generate(PROMPTS,
                                                          _greedy())
    want = _jax_engine(weights, prefill_chunk=4).generate(PROMPTS,
                                                          _jgreedy())
    assert got == want == jax_streams


def test_moe_engine_paged_and_gather_decode_identical(weights, jax_streams):
    streams = {}
    for paged in (True, False):
        eng = _port_engine(weights)
        eng._paged_kernel = paged
        streams[paged] = eng.generate(PROMPTS, _greedy())
        stats = eng.stats()
        assert stats["paged_decode_steps"] == (
            stats["decode_steps"] if paged else 0)
    assert streams[True] == streams[False] == jax_streams


@pytest.mark.parametrize("regime", ["agree", "reject"])
def test_moe_engine_speculative_identical_to_jax(weights, jax_streams,
                                                 regime):
    """An MoE target with a drafter: itself (agree) or a dense tiny model
    (reject); the streams equal ray_tpu's and the plain engine's."""
    if regime == "agree":
        spec = {"draft_config": CFG, "num_draft_tokens": 3}
        jspec = {"draft_config": JCFG, "num_draft_tokens": 3}
        jdraft = weights[0]
    else:
        spec = jspec = {"draft_config": "tiny", "num_draft_tokens": 3}
        jdraft = j_init(jax.random.PRNGKey(5), J_CONFIGS["tiny"])
    tdraft = params_from_jax(jax.tree.map(np.asarray, jdraft), device="cpu")
    eng = _port_engine(weights)
    eng.enable_speculation(spec, draft_params=tdraft)
    jeng = _jax_engine(weights)
    jeng.enable_speculation(jspec, draft_params=jdraft)
    got = eng.generate(PROMPTS, _greedy())
    assert got == jeng.generate(PROMPTS, _jgreedy()) == jax_streams
    assert eng.stats()["spec"] == jeng.spec.stats()
    assert eng.stats()["verify_steps"] > 0


def test_moe_engine_with_lora_identical_to_jax(weights, jax_streams):
    """A seeded LoRA on q/v of the MoE target, beside a base request."""
    from ray_tpu.llm.lora import init_lora_adapter as j_init_lora

    from ray_tpu_torch.models import lora_from_jax

    a = j_init_lora(jax.random.PRNGKey(3), JCFG, 4, dtype=JCFG.dtype)
    for i, name in enumerate(("b_q", "b_v")):
        a[name] = jax.random.normal(jax.random.PRNGKey(100 + i),
                                    a[name].shape, jnp.float32) * 0.3
    a = jax.tree.map(np.asarray, a)
    reqs = [(PROMPTS[0], "tuned"), (PROMPTS[1], None)]
    outs = []
    for eng, sp, adapter in (
            (_port_engine(weights, lora_rank=4), _greedy(),
             lora_from_jax(a, device="cpu")),
            (_jax_engine(weights, lora_rank=4), _jgreedy(), a)):
        eng.add_lora("tuned", adapter)
        ids = [eng.add_request(list(p), sp, model_id=m) for p, m in reqs]
        while eng.has_unfinished():
            eng.step()
        outs.append([eng.requests[i].output for i in ids])
    assert outs[0] == outs[1]
    assert outs[0][1] == jax_streams[1]
    assert outs[0][0] != jax_streams[0]


def test_moe_engine_export_inject_identical_to_jax(weights, jax_streams):
    """Export after the first token, inject into a second engine, which
    decodes with no prefill and gives the monolithic stream."""
    pre, dec = _port_engine(weights), _port_engine(weights)
    ids = []
    for p in PROMPTS:
        rid = pre.add_request(list(p), _greedy())
        while pre.requests[rid].ctx_len <= 0:
            pre.step(skip_decode=True)
        ids.append(dec.inject_request(pre.export_kv_request(rid), _greedy()))
    while dec.has_unfinished():
        dec.step()
    assert [dec.requests[i].output for i in ids] == jax_streams
    assert dec.stats()["prefills"] == 0 and dec.stats()["injected"] == 2


# --- training -------------------------------------------------------------------

def test_moe_train_steps_match_jax(weights):
    """3 AdamW steps of ray_tpu's trainer and the port's on tiny MoE:
    losses at 1e-5 and params at 1e-5 after each run; the router stays a
    genuine f32 leaf updated in f32 (here every leaf is f32, so the check
    is that it moves and keeps its dtype; the bf16 case runs on the card
    in chip_smoke.py)."""
    mesh = build_mesh(MeshSpec(), [jax.devices("cpu")[0]])
    j_init_fn, j_step, j_place = j_make_train_step(
        lambda p, b: j_lm_loss(p, b, JCFG), optax.adamw(1e-3), mesh,
        param_logical_axes(JCFG))
    init_fn, step_fn, place_batch = make_train_step(
        lambda p, b: lm_loss(p, b, CFG), adamw(1e-3), device="cpu")
    jstate = j_init_fn(weights[0])
    state = init_fn(params_from_jax(jax.tree.map(np.asarray, weights[0]),
                                    device="cpu"))
    router0 = state.params["layers"][0]["router"].detach().clone()
    for i in range(3):
        batch = _batch(40 + i, i == 1)
        jstate, jm = j_step(jstate, j_place(
            {k: jnp.asarray(v) for k, v in batch.items()}))
        state, m = step_fn(state, place_batch(batch))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   **F32)
    got = params_to_numpy(state.params)
    for path, w in _leaves(jax.tree.map(np.asarray, jstate.params)):
        g = got
        for k in path:
            g = g[k]
        np.testing.assert_allclose(g, w, err_msg=str(path), **F32)
    router = state.params["layers"][0]["router"]
    assert router.dtype == torch.float32
    assert not torch.equal(router.detach(), router0)


def test_moe_bf16_router_stays_f32_through_adamw():
    """A bf16 MoE model: the router leaf and its moments stay f32 and
    move by an f32 update beside bf16 experts."""
    cfg = dataclasses.replace(CFG, dtype=torch.bfloat16)
    init_fn, step_fn, place_batch = make_train_step(
        lambda p, b: lm_loss(p, b, cfg), adamw(1e-3), device="cpu")
    state = init_fn(init_params(cfg, seed=2, device="cpu"))
    lp = state.params["layers"][0]
    before = lp["router"].detach().clone()
    state, m = step_fn(state, place_batch(_batch(50, False)))
    assert np.isfinite(m["loss"].item())
    assert lp["router"].dtype == torch.float32
    assert lp["w_gate"].dtype == torch.bfloat16
    assert state.opt_state.mu["layers"][0]["router"].dtype == torch.float32
    after = lp["router"].detach()
    # Adam's first step moves each element by about lr (1e-3, plus decay)
    delta = (after - before).abs()
    assert 0.9e-3 < float(delta.min()) and float(delta.max()) < 1.1e-3
    # and the result is kept in f32, not rounded to bf16
    assert float((after.to(torch.bfloat16).float() != after).float()
                 .mean()) > 0.9
