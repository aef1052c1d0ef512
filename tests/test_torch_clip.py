"""ray_tpu_torch's CLIP against ray_tpu's (CPU).

``models/clip.py`` on ``tiny`` in f32: the configs, the init's tree, both
encoders, ``clip_outputs`` (loss, contrastive accuracy, scale), the
gradients against ``jax.grad`` and three AdamW steps of the port's trainer
(which splits both towers into per-layer lists) against optax; one bf16
case bounds the attention divergence (the port's attention rounds P to
bf16 before PV, the reference's ``blockwise_attention`` keeps it in f32).
Inputs are made with numpy from a seed, weights by ray_tpu's init carried
over with ``params_from_jax``; the port runs with ``device="cpu"``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import clip as jclip

from ray_tpu_torch._private.tree import tree_leaves
from ray_tpu_torch.models import (CLIP_CONFIGS, clip_loss, clip_outputs,
                                  encode_image, encode_text, init_clip,
                                  params_from_jax, params_to_numpy)
from ray_tpu_torch.train import adamw, make_train_step

# six xdist workers share the machine's cores
torch.set_num_threads(2)

F32 = dict(atol=1e-5, rtol=1e-5)
TINY, J_TINY = CLIP_CONFIGS["tiny"], jclip.CLIP_CONFIGS["tiny"]


def _batch(seed, cfg, n=8, T=8):
    """Block-coloured images and their token sequences, after
    test_clip_contrastive_learning, with trailing pads of varying length
    (and one all-pad row) so that pooling reads several positions."""
    rng = np.random.default_rng(seed)
    s = cfg.image_size
    images = np.zeros((n, s, s, 3), np.float32)
    tokens = np.zeros((n, T), np.int32)
    for i in range(n):
        images[i] = rng.normal(size=(3,)) * 0.1
        row = (i * 4) % s
        images[i, row:row + 4, :, i % 3] = 1.0
        length = (i % T) + 1 if i < n - 1 else 0
        tokens[i, :length] = rng.integers(1, cfg.vocab, length)
    return {"images": images, "tokens": tokens}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jp():
    return jax.tree.map(np.asarray, jclip.init_clip(jax.random.PRNGKey(0),
                                                    J_TINY))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def test_configs_match_jax():
    assert CLIP_CONFIGS.keys() == jclip.CLIP_CONFIGS.keys()
    for name, jc in jclip.CLIP_CONFIGS.items():
        tc = CLIP_CONFIGS[name]
        for f in dataclasses.fields(jc):
            if f.name != "dtype":
                assert getattr(tc, f.name) == getattr(jc, f.name), (name, f)
        assert str(tc.dtype).split(".")[-1] == jnp.dtype(jc.dtype).name
        assert tc.n_patches == jc.n_patches
        assert tc.n_params() == jc.n_params()


@pytest.mark.parametrize("name", ["tiny", "vit_b16"])
def test_init_has_the_reference_tree(name):
    """Same paths, shapes and dtypes as ray_tpu's init (vit_b16 on the
    meta device), the standard logit scale, unit norms and a zero cls."""
    want = jax.eval_shape(lambda: jclip.init_clip(jax.random.PRNGKey(0),
                                                  jclip.CLIP_CONFIGS[name]))
    dev = "cpu" if name == "tiny" else "meta"
    got = init_clip(CLIP_CONFIGS[name], seed=0, device=dev)
    got_leaves = dict(_leaves(got))
    want_leaves = dict(_leaves(want))
    assert got_leaves.keys() == want_leaves.keys()
    for path, w in want_leaves.items():
        g = got_leaves[path]
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).split(".")[-1] == jnp.dtype(w.dtype).name, path
    if dev == "cpu":
        np.testing.assert_allclose(float(got["logit_scale"]),
                                   np.log(1 / 0.07), rtol=1e-7)
        assert float(got["vision"]["cls"].abs().sum()) == 0.0
        assert bool((got["text"]["tower"]["mlp_norm"] == 1).all())
        again = init_clip(TINY, seed=0, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                     tree_leaves(again)))


def test_encode_image_matches_jax(jp):
    batch = _batch(0, TINY)
    want = np.asarray(jclip.encode_image(jp, jnp.asarray(batch["images"]),
                                         J_TINY))
    got = encode_image(params_from_jax(jp, device="cpu"),
                       torch.as_tensor(batch["images"]), TINY)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               rtol=1e-5)


def test_encode_text_matches_jax(jp):
    """Pooling at the last non-pad position, the all-pad row at 0."""
    batch = _batch(1, TINY)
    want = np.asarray(jclip.encode_text(jp, jnp.asarray(batch["tokens"]),
                                        J_TINY))
    got = encode_text(params_from_jax(jp, device="cpu"),
                      torch.as_tensor(batch["tokens"]), TINY)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("log_scale", [None, 7.0, -12.0])
def test_clip_outputs_match_jax(jp, log_scale):
    """Loss, accuracy and scale; the scale also clipped at log 100 and
    at -10."""
    if log_scale is not None:
        jp = {**jp, "logit_scale": np.asarray(log_scale, np.float32)}
    batch = _batch(2, TINY)
    want = jclip.clip_outputs(jp, _jax(batch), J_TINY)
    got = clip_outputs(params_from_jax(jp, device="cpu"), _torch(batch),
                       TINY)
    for k in ("loss", "contrastive_acc", "logit_scale"):
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   err_msg=k, **F32)


def test_gradients_match_jax(jp):
    """Every leaf's gradient of clip_loss, the logit scale's included."""
    batch = _batch(3, TINY)
    want = jax.grad(jclip.clip_loss)(jax.tree.map(jnp.asarray, jp),
                                     _jax(batch), J_TINY)
    params = params_from_jax(jp, device="cpu")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    clip_loss(params, _torch(batch), TINY).backward()
    for (path, w), t in zip(_leaves(jax.tree.map(np.asarray, want)), leaves,
                            strict=True):
        np.testing.assert_allclose(t.grad.numpy(), w, err_msg=str(path),
                                   **F32)


def test_train_steps_match_optax(jp):
    """3 AdamW steps (lr 1e-3, no weight decay) under make_train_step,
    which splits both towers into per-layer lists, against optax.adamw on
    ray_tpu's loss: losses and params at 1e-5. Adam's eps is 1e-4 on both
    sides: with 1e-8 an element whose gradient is f32 cancellation noise
    moves by up to lr either way."""
    opt = optax.adamw(1e-3, eps=1e-4, weight_decay=0.0)
    jparams = jax.tree.map(jnp.asarray, jp)
    opt_state = opt.init(jparams)
    init_fn, step_fn, place_batch = make_train_step(
        lambda p, b: clip_loss(p, b, TINY),
        adamw(1e-3, eps=1e-4, weight_decay=0.0), device="cpu")
    state = init_fn(params_from_jax(jp, device="cpu"))
    for tower in ("vision", "text"):
        assert isinstance(state.params[tower]["tower"], list)
        assert len(state.params[tower]["tower"]) == 2
    for i in range(3):
        batch = _batch(10 + i, TINY)
        loss, g = jax.value_and_grad(jclip.clip_loss)(jparams, _jax(batch),
                                                      J_TINY)
        updates, opt_state = opt.update(g, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        state, m = step_fn(state, place_batch(batch))
        np.testing.assert_allclose(m["loss"].item(), float(loss), **F32)
    got = dict(_leaves(params_to_numpy(state.params)))
    for path, w in _leaves(jax.tree.map(np.asarray, jparams)):
        np.testing.assert_allclose(got[path], w, err_msg=str(path), **F32)


def test_bf16_outputs_within_the_attention_divergence(jp):
    """`tiny` in bf16 (remat on, as at vit_b16) from the same weights: the
    port's attention rounds P to bf16 before PV where the reference's
    blockwise attention keeps f32, and bf16 matmuls round in another
    order. Embeddings (unit vectors of 32 entries, ~10 bf16 roundings
    deep; 0.004 apart here) within 0.02 abs, the loss (0.2% apart) within
    1e-2 relative."""
    jcfg = dataclasses.replace(J_TINY, dtype=jnp.bfloat16, remat=True)
    cfg = dataclasses.replace(TINY, dtype=torch.bfloat16, remat=True)
    jb = jax.tree.map(lambda x: jnp.asarray(x).astype(jnp.bfloat16)
                      if x.ndim else jnp.asarray(x), jp)
    tb = params_from_jax(jax.tree.map(np.asarray, jb), device="cpu")
    assert tb["vision"]["tower"]["wqkv"].dtype == torch.bfloat16
    assert tb["logit_scale"].dtype == torch.float32
    batch = _batch(4, TINY)
    want = jclip.clip_outputs(jb, _jax(batch), jcfg)
    got = clip_outputs(tb, _torch(batch), cfg)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-2)
    for fn, jfn, key in ((encode_image, jclip.encode_image, "images"),
                         (encode_text, jclip.encode_text, "tokens")):
        w = np.asarray(jfn(jb, jnp.asarray(batch[key]), jcfg))
        g = fn(tb, torch.as_tensor(batch[key]), cfg).numpy()
        np.testing.assert_allclose(g, w, atol=0.02)


def test_towers_run_the_flash_attention_path(monkeypatch):
    """Each tower layer goes through ops.attention.attention (the flash
    kernels on the card): non-causal in the vision tower, causal in the
    text tower; under remat with grad on, each layer's forward runs twice
    and its backward once."""
    import importlib

    tattn = importlib.import_module("ray_tpu_torch.ops.attention")
    calls = {"fwd": [], "dq": 0, "dkv": 0}
    real = (tattn.flash_attention, tattn.flash_bwd_dq, tattn.flash_bwd_dkv)

    def fwd(q, k, v, *, causal=True, **kw):
        calls["fwd"].append((q.shape[1], causal))
        return real[0](q, k, v, causal=causal, **kw)

    def dq(*a, **kw):
        calls["dq"] += 1
        return real[1](*a, **kw)

    def dkv(*a, **kw):
        calls["dkv"] += 1
        return real[2](*a, **kw)

    monkeypatch.setattr(tattn, "flash_attention", fwd)
    monkeypatch.setattr(tattn, "flash_bwd_dq", dq)
    monkeypatch.setattr(tattn, "flash_bwd_dkv", dkv)
    cfg = dataclasses.replace(TINY, remat=True)
    params = init_clip(cfg, seed=1, device="cpu")
    for t in tree_leaves(params):
        t.requires_grad_()
    clip_loss(params, _torch(_batch(5, cfg)), cfg).backward()
    n_v, n_t = cfg.v_layers, cfg.t_layers
    # vision: 1 + 16 patches, non-causal; text: 8 tokens, causal
    assert sorted(set(calls["fwd"])) == [(8, True), (cfg.n_patches + 1,
                                                     False)]
    assert len(calls["fwd"]) == 2 * (n_v + n_t)
    assert calls["dq"] == calls["dkv"] == n_v + n_t


@pytest.mark.parametrize("lr", [1e-3, 1e-4])
def test_vit_b16_widths_track_the_reference_under_adamw(lr):
    """vit_b16's widths and heads (768/512, 12/8 heads of 64) cut to 2
    layers a tower and 64x64 images, bf16, B=16 toy pairs: 3 AdamW steps
    of the port's trainer track optax on ray_tpu's loss, each loss within
    1e-2 relative. At 1e-3 (the `tiny` tests' rate) both losses rise
    above the first; at 1e-4, the clip phase's rate on the card, both
    fall at every step."""
    kw = dict(image_size=64, v_layers=2, t_layers=2, remat=False)
    jcfg = dataclasses.replace(jclip.CLIP_CONFIGS["vit_b16"], **kw)
    cfg = dataclasses.replace(CLIP_CONFIGS["vit_b16"], **kw)
    rng = np.random.default_rng(7)
    n, s = 16, cfg.image_size
    images = np.repeat(np.repeat(rng.normal(size=(n, 1, 1, 3)) * 0.1, s, 1),
                       s, 2).astype(np.float32)
    tokens = np.zeros((n, cfg.max_text), np.int32)
    for i in range(n):
        images[i, (i * 4) % s:(i * 4) % s + 4, :, i % 3] = 1.0
        tokens[i, :2] = (1 + i, 2 + i % 3)
    batch = {"images": images, "tokens": tokens}
    jp = jclip.init_clip(jax.random.PRNGKey(0), jcfg)
    opt = optax.adamw(lr, weight_decay=0.0)

    @jax.jit
    def jstep(p, st):
        loss, g = jax.value_and_grad(jclip.clip_loss)(p, _jax(batch), jcfg)
        updates, st = opt.update(g, st, p)
        return optax.apply_updates(p, updates), st, loss

    init_fn, step_fn, place_batch = make_train_step(
        lambda p, b: clip_loss(p, b, cfg), adamw(lr, weight_decay=0.0),
        device="cpu")
    state = init_fn(params_from_jax(jax.tree.map(np.asarray, jp),
                                    device="cpu"))
    placed, st, want, got = place_batch(batch), opt.init(jp), [], []
    for _ in range(3):
        jp, st, loss = jstep(jp, st)
        state, m = step_fn(state, placed)
        want.append(float(loss))
        got.append(m["loss"].item())
    np.testing.assert_allclose(got, want, rtol=1e-2)
    for losses in (want, got):
        if lr == 1e-4:
            assert losses[0] > losses[1] > losses[2], (want, got)
        else:
            assert max(losses[1:]) > losses[0], (want, got)
