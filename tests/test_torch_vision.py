"""ray_tpu_torch's ResNet against ray_tpu's (CPU).

``models/vision.py`` in f32: the configs and the init's tree, the forward
and ``image_loss``, the gradients and three AdamW steps of the port's
trainer against optax, on ``tiny``, on a config whose stages keep their
width (the stride-2 shortcut that subsamples instead of projecting), and
at odd and even input sizes (XLA's SAME padding at stride 2 is
asymmetric). Inputs are made with numpy from a seed, weights by ray_tpu's
init carried over with ``params_from_jax``; the port runs with
``device="cpu"``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import vision as jvision

from ray_tpu_torch._private.tree import tree_leaves
from ray_tpu_torch.models import (RESNET_CONFIGS, ResNetConfig, image_loss,
                                  init_resnet, params_from_jax,
                                  params_to_numpy, resnet_forward)
from ray_tpu_torch.models.vision import same_padding
from ray_tpu_torch.train import adamw, make_train_step

# six xdist workers share the machine's cores
torch.set_num_threads(2)

F32 = dict(atol=1e-5, rtol=1e-5)
# the stages keep their width: stage 2's first block subsamples its
# shortcut with x[:, ::2, ::2] instead of a 1x1 projection
SAME_WIDTH = dict(channels=(8, 8), depths=(1, 2), groups=4)
CONFIGS = {"tiny": (RESNET_CONFIGS["tiny"], jvision.RESNET_CONFIGS["tiny"]),
           "same_width": (ResNetConfig(**SAME_WIDTH, dtype=torch.float32),
                          jvision.ResNetConfig(**SAME_WIDTH,
                                               dtype=jnp.float32))}


def _batch(seed, cfg, n=4, size=16):
    """Images in [0, 1) and labels, seeded."""
    rng = np.random.default_rng(seed)
    return {"images": rng.uniform(0, 1, (n, size, size, 3)).astype(
                np.float32),
            "labels": rng.integers(0, cfg.num_classes, n).astype(np.int32)}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, node in enumerate(tree):
            yield from _leaves(node, prefix + (i,))
    else:
        yield prefix, tree


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    """(cfg, jax cfg, jax params as numpy) for each small config."""
    cfg, jcfg = CONFIGS[request.param]
    jp = jvision.init_resnet(jax.random.PRNGKey(0), jcfg)
    return cfg, jcfg, jax.tree.map(np.asarray, jp)


def test_configs_match_jax():
    assert RESNET_CONFIGS.keys() == jvision.RESNET_CONFIGS.keys()
    for name, jc in jvision.RESNET_CONFIGS.items():
        tc = RESNET_CONFIGS[name]
        for f in dataclasses.fields(jc):
            if f.name != "dtype":
                assert getattr(tc, f.name) == getattr(jc, f.name), (name, f)
        assert str(tc.dtype).split(".")[-1] == jnp.dtype(jc.dtype).name
        assert tc.n_params() == jc.n_params(), name


@pytest.mark.parametrize("name", ["tiny", "resnet18"])
def test_init_has_the_reference_tree(name):
    """Same paths (a list of lists of blocks; a projection only where the
    width changes), shapes and dtypes as ray_tpu's init."""
    jcfg = jvision.RESNET_CONFIGS[name]
    want = dict(_leaves(jax.eval_shape(
        lambda: jvision.init_resnet(jax.random.PRNGKey(0), jcfg))))
    got = dict(_leaves(init_resnet(RESNET_CONFIGS[name], seed=0,
                                   device="meta")))
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert tuple(got[path].shape) == tuple(w.shape), path
        assert (str(got[path].dtype).split(".")[-1]
                == jnp.dtype(w.dtype).name), path
    params = init_resnet(RESNET_CONFIGS["tiny"], seed=2, device="cpu")
    again = init_resnet(RESNET_CONFIGS["tiny"], seed=2, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(again)))


@pytest.mark.parametrize("size,kernel,stride,want", [
    (16, 3, 2, (0, 1)), (15, 3, 2, (1, 1)), (16, 3, 1, (1, 1)),
    (16, 1, 2, (0, 0)), (15, 1, 2, (0, 0)), (32, 7, 2, (2, 3)),
    (5, 3, 1, (1, 1))])
def test_same_padding_is_xla_s(size, kernel, stride, want):
    """The pads of one SAME axis, and the output size XLA gives for them."""
    assert same_padding(size, kernel, stride) == want
    x = jnp.zeros((1, size, size, 1))
    w = jnp.zeros((kernel, kernel, 1, 1))
    out = jax.lax.conv_general_dilated(
        x, w, (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    assert out.shape[1] == (size + sum(want) - kernel) // stride + 1


@pytest.mark.parametrize("size", [16, 15])
def test_forward_matches_jax(model, size):
    """Logits (B, num_classes) f32 at an even and an odd input size."""
    cfg, jcfg, jp = model
    batch = _batch(0, cfg, size=size)
    want = np.asarray(jvision.resnet_forward(
        jp, jnp.asarray(batch["images"]), jcfg))
    got = resnet_forward(params_from_jax(jp, device="cpu"),
                         torch.as_tensor(batch["images"]), cfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_f32_convolutions_never_reach_the_library_conv2d(model,
                                                        monkeypatch):
    """An f32 convolution is unfold + one f32 matmul (it follows the f32
    matmul precision setting, IEEE at PyTorch's default, as the port's
    other f32 matmuls do): with F.conv2d made to raise,
    the forward and the gradients still match the reference, and a bf16
    forward still reaches conv2d."""
    import torch.nn.functional as F

    def refuse(*a, **k):
        raise AssertionError("an f32 convolution reached F.conv2d")

    cfg, jcfg, jp = model
    batch = _batch(2, cfg, size=15)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = np.asarray(jvision.resnet_forward(
        jp, jbatch["images"], jcfg))
    loss, jgrads = jax.value_and_grad(jvision.image_loss)(
        jax.tree.map(jnp.asarray, jp), jbatch, jcfg)
    monkeypatch.setattr(F, "conv2d", refuse)
    params = params_from_jax(jp, device="cpu")
    np.testing.assert_allclose(resnet_forward(
        params, torch.as_tensor(batch["images"]), cfg).numpy(), want, **F32)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    got = image_loss(params, {k: torch.as_tensor(v)
                              for k, v in batch.items()}, cfg)
    np.testing.assert_allclose(got.item(), float(loss), **F32)
    got.backward()
    for (path, w), t in zip(_leaves(jax.tree.map(np.asarray, jgrads)),
                            leaves, strict=True):
        np.testing.assert_allclose(t.grad.numpy(), w, err_msg=str(path),
                                   **F32)
    bf16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    with pytest.raises(AssertionError, match="reached F.conv2d"):
        resnet_forward(params_from_jax(jp, device="cpu"),
                       torch.as_tensor(batch["images"]), bf16)


def test_image_loss_and_gradients_match_jax(model):
    cfg, jcfg, jp = model
    batch = _batch(1, cfg, size=15)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, want = jax.value_and_grad(jvision.image_loss)(
        jax.tree.map(jnp.asarray, jp), jbatch, jcfg)
    params = params_from_jax(jp, device="cpu")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_()
    got = image_loss(params, {k: torch.as_tensor(v)
                              for k, v in batch.items()}, cfg)
    np.testing.assert_allclose(got.item(), float(loss), **F32)
    got.backward()
    for (path, w), t in zip(_leaves(jax.tree.map(np.asarray, want)), leaves,
                            strict=True):
        np.testing.assert_allclose(t.grad.numpy(), w, err_msg=str(path),
                                   **F32)


def test_train_steps_match_optax(model):
    """3 AdamW steps (lr 1e-3, no weight decay) under make_train_step
    against optax.adamw on ray_tpu's loss: losses and params at 1e-5.
    Adam's eps is 1e-4 on both sides: with 1e-8 an element whose gradient
    is f32 cancellation noise moves by up to lr either way."""
    cfg, jcfg, jp = model
    opt = optax.adamw(1e-3, eps=1e-4, weight_decay=0.0)
    jparams = jax.tree.map(jnp.asarray, jp)
    opt_state = opt.init(jparams)
    init_fn, step_fn, place_batch = make_train_step(
        lambda p, b: image_loss(p, b, cfg),
        adamw(1e-3, eps=1e-4, weight_decay=0.0), device="cpu")
    state = init_fn(params_from_jax(jp, device="cpu"))
    for i in range(3):
        batch = _batch(10 + i, cfg)
        loss, g = jax.value_and_grad(jvision.image_loss)(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
        updates, opt_state = opt.update(g, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        state, m = step_fn(state, place_batch(batch))
        np.testing.assert_allclose(m["loss"].item(), float(loss), **F32)
    got = dict(_leaves(params_to_numpy(state.params)))
    want = dict(_leaves(jax.tree.map(np.asarray, jparams)))
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, err_msg=str(path), **F32)


def test_same_width_stages_subsample_the_shortcut():
    """The width-keeping config has no projection anywhere, so its
    stride-2 block takes the subsampled shortcut (held against the
    reference above); at an odd size the shortcut's ceil(H / 2) positions
    meet the SAME convolution's."""
    cfg, _ = CONFIGS["same_width"]
    params = init_resnet(cfg, seed=0, device="cpu")
    assert all("proj" not in block for blocks in params["stages"]
               for block in blocks)
    out = resnet_forward(params, torch.rand(2, 9, 9, 3), cfg)
    assert out.shape == (2, cfg.num_classes)
    assert bool(torch.isfinite(out).all())


def test_bf16_head_is_a_bf16_product_with_an_f32_result():
    """resnet18's dtype: the head multiplies bf16 operands into f32 logits
    (the reference's preferred_element_type), not an upcast of a bf16
    product."""
    cfg = dataclasses.replace(RESNET_CONFIGS["tiny"], dtype=torch.bfloat16)
    params = init_resnet(cfg, seed=3, device="cpu")
    images = torch.rand(2, 8, 8, 3, generator=torch.Generator().manual_seed(0))
    logits = resnet_forward(params, images, cfg)
    assert logits.dtype == torch.float32
    assert params["head"].dtype == torch.bfloat16
    # not representable in bf16 in general: an f32 result
    assert not torch.equal(logits, logits.to(torch.bfloat16).float())


@pytest.mark.parametrize("lr", [1e-3, 1e-4])
def test_resnet18_tracks_the_reference_under_adamw(lr):
    """resnet18 (bf16, full depth and width) at 16x16, B=16 separable
    images: 3 AdamW steps of the port's trainer track optax on ray_tpu's
    loss, each loss within 2e-2 relative (bf16 products in another order,
    grown by the steps). At 1e-3 both losses rise above the first; at
    1e-4, the resnet phase's rate on the card, both fall at every step."""
    cfg, jcfg = RESNET_CONFIGS["resnet18"], jvision.RESNET_CONFIGS["resnet18"]
    rng = np.random.default_rng(7)
    n, size = 16, 16
    labels = rng.integers(0, cfg.num_classes, n)
    xx = np.arange(size)[None, :, None, None]
    images = (rng.uniform(0, 0.2, (n, size, size, 3)) + 0.5 * np.sin(
        2 * np.pi * (labels[:, None, None, None] + 1) * xx / size))
    batch = {"images": images.astype(np.float32),
             "labels": labels.astype(np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jp = jvision.init_resnet(jax.random.PRNGKey(0), jcfg)
    opt = optax.adamw(lr, weight_decay=0.0)

    @jax.jit
    def jstep(p, st):
        loss, g = jax.value_and_grad(jvision.image_loss)(p, jbatch, jcfg)
        updates, st = opt.update(g, st, p)
        return optax.apply_updates(p, updates), st, loss

    init_fn, step_fn, place_batch = make_train_step(
        lambda p, b: image_loss(p, b, cfg), adamw(lr, weight_decay=0.0),
        device="cpu")
    state = init_fn(params_from_jax(jax.tree.map(np.asarray, jp),
                                    device="cpu"))
    placed, st, want, got = place_batch(batch), opt.init(jp), [], []
    for _ in range(3):
        jp, st, loss = jstep(jp, st)
        state, m = step_fn(state, placed)
        want.append(float(loss))
        got.append(m["loss"].item())
    np.testing.assert_allclose(got, want, rtol=2e-2)
    for losses in (want, got):
        if lr == 1e-4:
            assert losses[0] > losses[1] > losses[2], (want, got)
        else:
            assert max(losses[1:]) > losses[0], (want, got)
