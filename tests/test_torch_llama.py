"""ray_tpu_torch's Llama model against ray_tpu's on the same weights (CPU).

Weights are made by the JAX init and carried over leaf for leaf with
``params_from_jax``; the port runs with ``device="cpu"`` (attention takes
the flash kernel's plain version there).
"""

import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.models import LLAMA_CONFIGS as J_CONFIGS
from ray_tpu.models import forward as j_forward
from ray_tpu.models import init_params as j_init
from ray_tpu.models import lm_loss as j_lm_loss
from ray_tpu.ops import quant as jq

from ray_tpu_torch.models import (LLAMA_CONFIGS, forward, init_params,
                                  lm_loss, params_from_jax, unstack_layers)
from ray_tpu_torch.ops.quant import init_params_quantized, quantize_params

# the module, which the package's ``attention`` function shadows
tattn = importlib.import_module("ray_tpu_torch.ops.attention")

# six xdist workers share the machine's cores
torch.set_num_threads(2)

TINY = LLAMA_CONFIGS["tiny"]


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
def jax_tiny():
    return jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0),
                                           J_CONFIGS["tiny"]))


def test_configs_match_jax():
    for name, jc in J_CONFIGS.items():
        tc = LLAMA_CONFIGS[name]
        for f in ("vocab", "dim", "n_layers", "n_heads", "n_kv_heads",
                  "mlp_dim", "max_seq", "rope_theta", "norm_eps",
                  "n_experts"):
            assert getattr(tc, f) == getattr(jc, f), (name, f)
        assert tc.head_dim == jc.head_dim
        assert tc.n_params() == jc.n_params()
        assert str(tc.dtype).split(".")[-1] == jnp.dtype(jc.dtype).name


@pytest.mark.parametrize("seq", [1, 9, 20])
def test_forward_logits_match_jax(jax_tiny, seq):
    toks = np.random.default_rng(seq).integers(
        0, TINY.vocab, (2, seq)).astype(np.int32)
    want = np.asarray(j_forward(jax.tree.map(jnp.asarray, jax_tiny),
                                jnp.asarray(toks), J_CONFIGS["tiny"]))
    got = forward(params_from_jax(jax_tiny, device="cpu"),
                  torch.from_numpy(toks), TINY)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_8b_meta_init_has_jax_shapes():
    """Full width and depth without allocating: the meta-device init has
    the JAX init's tree, shapes and dtypes."""
    want = jax.eval_shape(lambda k: j_init(k, J_CONFIGS["8b"]),
                          jax.random.PRNGKey(0))
    got = init_params(LLAMA_CONFIGS["8b"], device="meta")
    want_l, got_l = list(_leaves(want)), list(_leaves(got))
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, w), (_, g) in zip(want_l, got_l):
        assert tuple(g.shape) == tuple(w.shape), path
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, path
        assert g.device.type == "meta"
    n = sum(g.numel() for _, g in got_l)
    assert n == LLAMA_CONFIGS["8b"].n_params()


def test_init_is_seeded_and_scaled():
    a = init_params(TINY, seed=3, device="cpu")
    b = init_params(TINY, seed=3, device="cpu")
    c = init_params(TINY, seed=4, device="cpu")
    for (path, x), (_, y), (_, z) in zip(_leaves(a), _leaves(b),
                                         _leaves(c)):
        assert torch.equal(x, y), path
        if "norm" not in path[-1]:
            assert not torch.equal(x, z), path
    # 1/sqrt(fan_in) scale, as the JAX init
    wq = a["layers"]["wq"]
    assert abs(float(wq.std()) * TINY.dim ** 0.5 - 1.0) < 0.1
    assert torch.equal(a["layers"]["attn_norm"],
                       torch.ones_like(a["layers"]["attn_norm"]))


def test_params_from_jax_bf16_and_quantized_leaves():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 3, 4)).astype(np.float32)
    tree = {"bf16": w.astype(ml_dtypes.bfloat16),
            "f32": w,
            "quant": jq.quantize_weight(w, (0,))}
    got = params_from_jax(tree, device="cpu")
    assert got["bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got["bf16"].float().numpy(),
        tree["bf16"].astype(np.float32))          # exact through f32
    np.testing.assert_array_equal(got["f32"].numpy(), w)
    assert got["quant"]["q"].dtype == torch.int8
    np.testing.assert_array_equal(got["quant"]["q"].numpy(),
                                  tree["quant"]["q"])
    np.testing.assert_array_equal(got["quant"]["s"].numpy(),
                                  tree["quant"]["s"])


def test_moe_config_is_refused():
    """MoE is no longer refused: the port's init makes the reference's
    MoE tree (an f32 router beside the model-dtype experts), and forward
    on the reference's MoE weights gives its logits at 1e-4."""
    moe = TINY.__class__(**{**TINY.__dict__, "n_experts": 4})
    jmoe = J_CONFIGS["tiny"].__class__(
        **{**J_CONFIGS["tiny"].__dict__, "n_experts": 4})
    mine = init_params(moe, seed=0, device="cpu")
    assert mine["layers"]["router"].dtype == torch.float32
    assert mine["layers"]["w_gate"].shape == (2, 4, TINY.dim, TINY.mlp_dim)
    jp = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(1), jmoe))
    toks = np.random.default_rng(5).integers(
        0, TINY.vocab, (2, 12)).astype(np.int32)
    want = np.asarray(j_forward(jax.tree.map(jnp.asarray, jp),
                                jnp.asarray(toks), jmoe))
    got = forward(params_from_jax(jp, device="cpu"), torch.from_numpy(toks),
                  moe)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_quantize_params_matches_jax(jax_tiny):
    want = jq.quantize_params(jax_tiny)                  # numpy path
    got = quantize_params(params_from_jax(jax_tiny, device="cpu"))
    want_l, got_l = list(_leaves(want)), list(_leaves(got))
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, w), (_, g) in zip(want_l, got_l):
        if path[-1] == "q":
            assert g.dtype == torch.int8
            np.testing.assert_array_equal(g.numpy(), w, err_msg=str(path))
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6,
                                       err_msg=str(path))


def test_8b_quantized_meta_init_has_jax_shapes():
    want = jax.eval_shape(
        lambda k: jq.init_params_quantized(k, J_CONFIGS["8b"]),
        jax.random.PRNGKey(0))
    got = init_params_quantized(LLAMA_CONFIGS["8b"], device="meta")
    want_l, got_l = list(_leaves(want)), list(_leaves(got))
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, w), (_, g) in zip(want_l, got_l):
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).split(".")[-1] == jnp.dtype(w.dtype).name, path
    small = init_params_quantized(TINY, seed=1, device="cpu")
    assert small["layers"]["wq"]["q"].dtype == torch.int8
    assert int(small["layers"]["wq"]["q"].abs().max()) > 0


def _lm_batch(seed, with_mask, seq=24):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, TINY.vocab, (2, seq)).astype(np.int32)}
    if with_mask:
        mask = np.ones((2, seq), np.int32)
        mask[0, seq // 2:] = 0
        mask[1, :3] = 0
        batch["mask"] = mask
    return batch


def _grads(params, batch, cfg):
    leaves = {k: v.requires_grad_() for k, v in _leaves(params)}
    loss = lm_loss(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                   cfg)
    return loss, dict(zip(leaves, torch.autograd.grad(loss,
                                                      list(leaves.values()))))


@pytest.mark.parametrize("with_mask", [False, True])
def test_lm_loss_and_grads_match_jax(jax_tiny, with_mask):
    """f32 next-token cross-entropy with z-loss (1e-4) and the shifted
    mask: the value and every gradient against jax.value_and_grad of
    ray_tpu's lm_loss at 1e-5."""
    batch = _lm_batch(20 + with_mask, with_mask)
    jp = jax.tree.map(jnp.asarray, jax_tiny)
    want_loss, want_g = jax.value_and_grad(j_lm_loss)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()},
        J_CONFIGS["tiny"])
    loss, grads = _grads(params_from_jax(jax_tiny, device="cpu"), batch,
                         TINY)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for path, w in _leaves(jax.tree.map(np.asarray, want_g)):
        np.testing.assert_allclose(grads[path].numpy(), w, atol=1e-5,
                                   rtol=1e-5, err_msg=str(path))


def test_lm_loss_all_masked_is_zero_and_moe_refused():
    """An all-masked batch: 0 for a dense model; for MoE (no longer
    refused) aux_loss_coef * aux, the aux term being added after masking,
    equal to the reference's loss at 1e-4."""
    params = init_params(TINY, seed=1, device="cpu")
    batch = _lm_batch(22, True)
    batch["mask"][:] = 0
    loss = lm_loss(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                   TINY)
    assert float(loss) == 0.0
    # a dense model's aux, when asked for, is an f32 zero
    _, aux = forward(params, torch.from_numpy(batch["tokens"]), TINY,
                     return_aux=True)
    assert aux.dtype == torch.float32 and aux.shape == () and float(aux) == 0
    moe = TINY.__class__(**{**TINY.__dict__, "n_experts": 4})
    jmoe = J_CONFIGS["tiny"].__class__(
        **{**J_CONFIGS["tiny"].__dict__, "n_experts": 4})
    jp = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(2), jmoe))
    tp = params_from_jax(jp, device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = lm_loss(tp, tbatch, moe)
    _, aux = forward(tp, tbatch["tokens"], moe, return_aux=True)
    assert float(loss) > 0
    np.testing.assert_allclose(float(loss), moe.aux_loss_coef * float(aux),
                               rtol=1e-6)
    want = j_lm_loss(jax.tree.map(jnp.asarray, jp),
                     {k: jnp.asarray(v) for k, v in batch.items()}, jmoe)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-4)


def _count_attention_calls(monkeypatch):
    """Count calls of the flash forward and of the two backward wrappers
    (on the CPU they run their plain versions, so launches stay 0)."""
    counts = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    for name, attr in (("flash_fwd", "flash_attention"),
                       ("flash_bwd_dq", "flash_bwd_dq"),
                       ("flash_bwd_dkv", "flash_bwd_dkv")):
        real = getattr(tattn, attr)

        def counted(*a, _real=real, _name=name, **kw):
            counts[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(tattn, attr, counted)
    return counts


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_policies_give_the_same_grads(monkeypatch, policy):
    """Per-layer remat ("full": recompute the layer; "dots": keep the
    projections, recompute the rest) gives the grads of no remat, on the
    trainer's per-layer leaves; the recompute runs the flash forward a
    second time in every layer, the backward once."""
    batch = _lm_batch(23, True)
    base = init_params(TINY, seed=2, device="cpu")
    remat_cfg = TINY.__class__(**{**TINY.__dict__, "remat": True,
                                  "remat_policy": policy})
    counts = _count_attention_calls(monkeypatch)
    results = {}
    for cfg in (TINY, remat_cfg):
        for c in counts:
            counts[c] = 0
        params = unstack_layers(base)
        params["layers"] = [{k: v.detach().clone() for k, v in lp.items()}
                            for lp in params["layers"]]
        results[cfg.remat] = _grads(params, batch, cfg)
        L = cfg.n_layers
        assert counts == {"flash_fwd": L * (2 if cfg.remat else 1),
                          "flash_bwd_dq": L, "flash_bwd_dkv": L}
    (loss0, g0), (loss1, g1) = results[False], results[True]
    assert loss0.item() == loss1.item()
    assert g0.keys() == g1.keys()
    for path in g0:
        np.testing.assert_allclose(g1[path].numpy(), g0[path].numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=str(path))
