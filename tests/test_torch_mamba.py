"""ray_tpu_torch's Mamba-2 and Jamba hybrid against ray_tpu's (CPU).

``ops/ssd.py`` (the chunked SSD and its sequential oracle, with shared
and per-head B/C), ``models/mamba.py`` (configs, init, the forward's
logits and the loss's gradients on ``tiny`` and ``jamba_tiny``, finite
gradients where the decay would overflow without the clamp) and three
AdamW steps of the port's trainer against optax. Inputs are made with
numpy or by ray_tpu's init and carried over with ``params_from_jax``;
the port runs with ``device="cpu"``. Comparisons are in f32.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import MAMBA_CONFIGS as J_CONFIGS
from ray_tpu.models import init_mamba as j_init
from ray_tpu.models import mamba as jmamba
from ray_tpu.models import mamba_forward as j_forward
from ray_tpu.models import mamba_lm_loss as j_loss
from ray_tpu.ops import ssd as jssd

from ray_tpu_torch.models import (MAMBA_CONFIGS, MambaConfig, init_mamba,
                                  mamba_forward, mamba_lm_loss,
                                  params_from_jax, params_to_numpy)
from ray_tpu_torch.models import mamba
from ray_tpu_torch.ops import ssd
from ray_tpu_torch.train import adamw, make_train_step

# the module, which the package's ``attention`` function shadows
tattn = importlib.import_module("ray_tpu_torch.ops.attention")

# six xdist workers share the machine's cores
torch.set_num_threads(2)

F32 = dict(atol=1e-5, rtol=1e-5)
# model-level comparisons (several layers of f32 products in another
# order): 1e-4
MODEL = dict(atol=1e-4, rtol=1e-4)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, node in enumerate(tree):
            yield from _leaves(node, prefix + (i,))
    else:
        yield prefix, tree


@pytest.fixture(scope="module", params=["tiny", "jamba_tiny"])
def model(request):
    """(name, jax params as numpy) for each small config."""
    name = request.param
    jp = j_init(jax.random.PRNGKey(0), J_CONFIGS[name])
    return name, jax.tree.map(np.asarray, jp)


# --- configs and init -----------------------------------------------------------

def test_configs_match_jax():
    assert MAMBA_CONFIGS.keys() == J_CONFIGS.keys()
    for name, jc in J_CONFIGS.items():
        tc = MAMBA_CONFIGS[name]
        for f in dataclasses.fields(jc):
            if f.name != "dtype":
                assert getattr(tc, f.name) == getattr(jc, f.name), (name, f)
        for prop in ("inner", "n_heads", "n_attn_layers", "n_mamba_layers"):
            assert getattr(tc, prop) == getattr(jc, prop), (name, prop)
        assert tc.n_params() == jc.n_params()
        assert str(tc.dtype).split(".")[-1] == jnp.dtype(jc.dtype).name


@pytest.mark.parametrize("bad", [dict(n_layers=6, attn_period=4),
                                 dict(dim=66, attn_period=4, n_layers=4),
                                 dict(attn_period=4, n_layers=4,
                                      attn_heads=4, attn_kv_heads=3)])
def test_config_checks_match_jax(bad):
    with pytest.raises(ValueError):
        MambaConfig(**bad)
    with pytest.raises(ValueError):
        jmamba.MambaConfig(**bad)


@pytest.mark.parametrize("name", sorted(J_CONFIGS))
def test_meta_init_has_jax_tree_shapes_and_dtypes(name):
    """Every config at full size without allocating: the reference's
    leaves, shapes and dtypes (dt_bias, A_log and Dp in f32)."""
    want = jax.eval_shape(lambda k: j_init(k, J_CONFIGS[name]),
                          jax.random.PRNGKey(0))
    got = init_mamba(MAMBA_CONFIGS[name], device="meta")
    want_l, got_l = list(_leaves(want)), list(_leaves(got))
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, w), (_, g) in zip(want_l, got_l):
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).split(".")[-1] == jnp.dtype(w.dtype).name, path
    assert sum(g.numel() for _, g in got_l) == MAMBA_CONFIGS[name].n_params()


def test_init_is_seeded_with_the_reference_ranges():
    cfg = MAMBA_CONFIGS["130m"]
    a = init_mamba(cfg, seed=3, device="cpu")
    b = init_mamba(cfg, seed=3, device="cpu")
    c = init_mamba(cfg, seed=4, device="cpu")
    for (path, x), (_, y), (_, z) in zip(_leaves(a), _leaves(b), _leaves(c)):
        assert torch.equal(x, y), path
        if path[-1] not in ("norm", "final_norm", "Dp"):
            assert not torch.equal(x, z), path
    lay = a["layers"]
    for k in ("dt_bias", "A_log", "Dp"):
        assert lay[k].dtype == torch.float32
    dt = torch.nn.functional.softplus(lay["dt_bias"])
    assert cfg.dt_min * 0.999 <= float(dt.min())
    assert float(dt.max()) <= cfg.dt_max * 1.001
    assert 0.0 <= float(lay["A_log"].min())
    assert float(lay["A_log"].max()) < np.log(16.0)
    assert abs(float(lay["w_in"].float().std()) * cfg.dim ** 0.5 - 1) < 0.05


def test_params_from_jax_keeps_f32_leaves_and_attn_layers(model):
    name, jp = model
    tp = params_from_jax(jp, device="cpu")
    for path, w in _leaves(jp):
        g = tp
        for k in path:
            g = g[k]
        assert str(g.dtype).split(".")[-1] == w.dtype.name, path
        np.testing.assert_array_equal(g.numpy(), w, err_msg=str(path))
    assert ("attn_layers" in tp) == bool(MAMBA_CONFIGS[name].attn_period)
    back = params_to_numpy(tp)
    for path, w in _leaves(jp):
        g = back
        for k in path:
            g = g[k]
        np.testing.assert_array_equal(g, w, err_msg=str(path))


# --- ops/ssd.py ----------------------------------------------------------------

def _ssd_inputs(seed, B=2, S=64, H=3, P=8, N=16, shared=False, dt_scale=1.0):
    rng = np.random.default_rng(seed)
    Hbc = 1 if shared else H
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))) * dt_scale
    A = -np.exp(rng.standard_normal(H))
    Bm = rng.standard_normal((B, S, Hbc, N)) * 0.5
    Cm = rng.standard_normal((B, S, Hbc, N)) * 0.5
    D = np.full((H,), 0.5)
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm, D)]


@pytest.mark.parametrize("chunk", [1, 8, 16, 64])
@pytest.mark.parametrize("shared", [False, True])
def test_ssd_chunked_matches_jax(chunk, shared):
    """The port's chunked SSD against ray_tpu's at 1e-5, per-head and
    head-shared B/C, for chunks from pure scan (1) to pure intra (64)."""
    args = _ssd_inputs(chunk, shared=shared)
    want = np.asarray(jssd.ssd_chunked(*map(jnp.asarray, args), chunk))
    got = ssd.ssd_chunked(*map(torch.from_numpy, args), chunk)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("chunk", [8, 16, 64])
@pytest.mark.parametrize("shared", [False, True])
def test_ssd_chunked_matches_the_recurrence(chunk, shared):
    """The chunked form against the port's sequential oracle at 1e-5
    (absolute on outputs of order 1), and the oracle against ray_tpu's."""
    args = _ssd_inputs(10 + chunk, shared=shared)
    targs = list(map(torch.from_numpy, args))
    if shared:
        # the oracle takes per-head B/C: the materialised repeat
        H = args[0].shape[2]
        targs[3] = targs[3].expand(-1, -1, H, -1).contiguous()
        targs[4] = targs[4].expand(-1, -1, H, -1).contiguous()
    ref = ssd.ssd_reference(*targs)
    got = ssd.ssd_chunked(*map(torch.from_numpy, args), chunk)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **F32)
    jref = np.asarray(jssd.ssd_reference(*[jnp.asarray(t.numpy())
                                           for t in targs]))
    np.testing.assert_allclose(ref.numpy(), jref, **F32)


def test_ssd_shared_bc_equals_the_repeat():
    args = _ssd_inputs(5, S=32, H=4, shared=True)
    t = list(map(torch.from_numpy, args))
    rep = [t[3].repeat(1, 1, 4, 1), t[4].repeat(1, 1, 4, 1)]
    np.testing.assert_allclose(
        ssd.ssd_chunked(*t, 16).numpy(),
        ssd.ssd_chunked(t[0], t[1], t[2], rep[0], rep[1], t[5], 16).numpy(),
        **F32)


def test_ssd_state_carries_across_chunks():
    """Zeroing the first token changes the last output three chunks on."""
    args = _ssd_inputs(6, B=1, H=1, P=4, N=8)
    args[1][:] = 0.2
    args[2][:] = -0.1
    t = list(map(torch.from_numpy, args))
    full = ssd.ssd_chunked(*t, 16)
    t[0] = t[0].clone()
    t[0][:, 0] = 0
    cut = ssd.ssd_chunked(*t, 16)
    assert float((full[:, -1] - cut[:, -1]).abs().max()) > 1e-5


def test_ssd_refuses_a_ragged_sequence():
    t = list(map(torch.from_numpy, _ssd_inputs(7, S=20)))
    with pytest.raises(ValueError):
        ssd.ssd_chunked(*t, 16)


def test_ssd_backward_is_finite_where_the_decay_overflows():
    """Strong decay (dt*|A| summing past 88 in a chunk): the anti-causal
    exponent would overflow exp in f32; with the clamp the gradients are
    finite and equal ray_tpu's to 1e-4 of each gradient's largest entry
    (the dt and A gradients are sums of terms that cancel)."""
    args = _ssd_inputs(8, S=64, dt_scale=4.0)
    x, dt, A, Bm, Cm, D = args
    assert float((dt * -A).sum(axis=1).max()) > 88.0
    # a fixed linear read-out of y, so the gradients stay of order 1
    w = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y = ssd.ssd_chunked(*leaves, 64)
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum(), leaves)
    jgrads = jax.grad(lambda *a: jnp.sum(jssd.ssd_chunked(*a, 64) * w),
                      argnums=tuple(range(6)))(*map(jnp.asarray, args))
    for g, w in zip(grads, jgrads):
        assert torch.isfinite(g).all()
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()))


def test_causal_depthwise_conv_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 11, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    want = np.asarray(jmamba._causal_depthwise_conv(jnp.asarray(x),
                                                    jnp.asarray(w)))
    got = mamba._causal_depthwise_conv(torch.from_numpy(x),
                                       torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, **F32)


# --- the model ------------------------------------------------------------------

def _tokens(seed, cfg, shape):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, shape).astype(np.int32)


@pytest.mark.parametrize("seq", [16, 23])
@pytest.mark.parametrize("remat", [False, True])
def test_forward_logits_match_jax(model, seq, remat):
    """Logits at 1e-4, on a sequence that is a multiple of the chunk (16)
    and one that is padded to it (23 -> 32, cut back), with and without
    remat."""
    name, jp = model
    cfg = dataclasses.replace(MAMBA_CONFIGS[name], remat=remat)
    toks = _tokens(seq, cfg, (2, seq))
    want = np.asarray(j_forward(jax.tree.map(jnp.asarray, jp),
                                jnp.asarray(toks), J_CONFIGS[name]))
    got = mamba_forward(params_from_jax(jp, device="cpu"),
                        torch.from_numpy(toks), cfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **MODEL)


def _grads(params, batch, cfg):
    leaves = {p: v.requires_grad_() for p, v in _leaves(params)}
    loss = mamba_lm_loss(params, {"tokens": torch.from_numpy(batch)}, cfg)
    return loss, dict(zip(leaves, torch.autograd.grad(
        loss, list(leaves.values()))))


@pytest.mark.parametrize("remat", [False, True])
def test_lm_loss_and_grads_match_jax(model, remat):
    """mamba_lm_loss (the model reads 32 tokens, padded to 32: no pad)
    and the gradient of every leaf at 1e-4."""
    name, jp = model
    cfg = dataclasses.replace(MAMBA_CONFIGS[name], remat=remat)
    toks = _tokens(40, cfg, (2, 33))
    want_loss, want_g = jax.value_and_grad(j_loss)(
        jax.tree.map(jnp.asarray, jp), {"tokens": jnp.asarray(toks)},
        J_CONFIGS[name])
    loss, grads = _grads(params_from_jax(jp, device="cpu"), toks, cfg)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for path, w in _leaves(jax.tree.map(np.asarray, want_g)):
        np.testing.assert_allclose(grads[path].numpy(), w, err_msg=str(path),
                                   **MODEL)


def test_long_sequence_grads_are_finite_with_strong_decay(model):
    """A 256-token sequence with every head at |A| = 16 and dt near 2:
    the in-chunk decay sums far past exp's f32 range, and every gradient
    stays finite and matches ray_tpu's."""
    name, jp = model
    cfg = MAMBA_CONFIGS[name]
    jp = dict(jp, layers=dict(jp["layers"]))
    jp["layers"]["A_log"] = np.full_like(jp["layers"]["A_log"], np.log(16.0))
    jp["layers"]["dt_bias"] = np.full_like(jp["layers"]["dt_bias"], 2.0)
    toks = _tokens(41, cfg, (1, 257))
    loss, grads = _grads(params_from_jax(jp, device="cpu"), toks, cfg)
    assert np.isfinite(loss.item())
    want_g = jax.grad(j_loss)(jax.tree.map(jnp.asarray, jp),
                              {"tokens": jnp.asarray(toks)}, J_CONFIGS[name])
    for path, w in _leaves(jax.tree.map(np.asarray, want_g)):
        assert torch.isfinite(grads[path]).all(), path
        np.testing.assert_allclose(grads[path].numpy(), w, err_msg=str(path),
                                   **MODEL)


def test_jamba_attention_runs_the_flash_forward_and_backward(monkeypatch):
    """jamba_tiny's one attention layer goes through ops.attention: with
    remat, the flash forward twice (forward, recompute) and each backward
    once; on the CPU the wrappers take their plain versions."""
    counts = {"flash_attention": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    for attr in counts:
        real = getattr(tattn, attr)

        def counted(*a, _real=real, _name=attr, **kw):
            counts[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(tattn, attr, counted)
    cfg = dataclasses.replace(MAMBA_CONFIGS["jamba_tiny"], remat=True)
    params = init_mamba(cfg, seed=1, device="cpu")
    loss, grads = _grads(params, _tokens(42, cfg, (2, 17)), cfg)
    assert counts == {"flash_attention": 2 * cfg.n_attn_layers,
                      "flash_bwd_dq": cfg.n_attn_layers,
                      "flash_bwd_dkv": cfg.n_attn_layers}
    assert float(grads[("attn_layers", "wqkv")].abs().max()) > 0


# --- training -------------------------------------------------------------------

def test_train_steps_match_optax(model):
    """3 AdamW steps (lr 1e-3, weight decay 0.1) under make_train_step,
    which hands the model per-layer leaves for both stacked groups, against
    optax.adamw on ray_tpu's loss: losses at 1e-5 and params at 1e-5.
    Adam's eps is 1e-4 on both sides: with 1e-8 an element whose gradient
    is f32 cancellation noise (|g| ~ 1e-8, either sign in either
    framework) moves by up to lr either way."""
    name, jp = model
    cfg, jcfg = MAMBA_CONFIGS[name], J_CONFIGS[name]
    opt = optax.adamw(1e-3, eps=1e-4, weight_decay=0.1)
    jparams = jax.tree.map(jnp.asarray, jp)
    opt_state = opt.init(jparams)
    init_fn, step_fn, place_batch = make_train_step(
        lambda p, b: mamba_lm_loss(p, b, cfg),
        adamw(1e-3, eps=1e-4, weight_decay=0.1), device="cpu")
    state = init_fn(params_from_jax(jp, device="cpu"))
    assert isinstance(state.params["layers"], list)
    if cfg.attn_period:
        assert isinstance(state.params["attn_layers"], list)
    for i in range(3):
        batch = {"tokens": _tokens(50 + i, cfg, (2, 33))}
        loss, g = jax.value_and_grad(j_loss)(
            jparams, {"tokens": jnp.asarray(batch["tokens"])}, jcfg)
        updates, opt_state = opt.update(g, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        state, m = step_fn(state, place_batch(batch))
        np.testing.assert_allclose(m["loss"].item(), float(loss), rtol=1e-5)
    got = params_to_numpy(state.params)
    for path, w in _leaves(jax.tree.map(np.asarray, jparams)):
        g = got
        for k in path:
            g = g[k]
        np.testing.assert_allclose(g, w, err_msg=str(path), **F32)
