"""The port's tree walk with nested layer groups (CPU).

``unstack_layers`` splits a stacked layer group at any depth: CLIP's two
``"tower"`` groups, and the Llama, MoE, Mamba and Jamba trees exactly as
the top-level walk did before. ``params_to_numpy`` stacks only layer
groups again (a ResNet's lists of blocks stay lists), and
``opt_state_from_jax`` splits an optax state's moments as the trainer's
tree is split, nested groups included.
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import clip as jclip
from ray_tpu.models import vision as jvision

from ray_tpu_torch._private.tree import (is_layer_group, tree_leaves,
                                         tree_unflatten, unstack_layers)
from ray_tpu_torch.models import (CLIP_CONFIGS, LLAMA_CONFIGS, MAMBA_CONFIGS,
                                  RESNET_CONFIGS, init_clip, init_mamba,
                                  init_params, init_resnet, opt_state_from_jax,
                                  params_from_jax, params_to_numpy)
from ray_tpu_torch.train import adamw, make_train_step

# six xdist workers share the machine's cores
torch.set_num_threads(2)


def _top_level_unstack(params):
    """The walk before nested groups: top-level groups only."""
    out = dict(params)
    for key, group in params.items():
        if (key == "layers" or key.endswith("_layers")) and isinstance(
                group, dict):
            n = len(next(iter(group.values())))
            out[key] = [{k: v[li] for k, v in group.items()}
                        for li in range(n)]
    return out


def _same_views(a, b):
    """Same structure, and each leaf a view of the same storage, offset,
    shape and strides."""
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.stride() == y.stride()
        assert x.data_ptr() == y.data_ptr()


def test_layer_groups_are_named_layers_or_tower():
    assert is_layer_group("layers") and is_layer_group("attn_layers")
    assert is_layer_group("tower")
    assert not is_layer_group("stages") and not is_layer_group("vision")


def test_clip_towers_unstack_into_views():
    params = init_clip(CLIP_CONFIGS["tiny"], seed=0, device="cpu")
    out = unstack_layers(params)
    for tower in ("vision", "text"):
        layers = out[tower]["tower"]
        assert isinstance(layers, list) and len(layers) == 2
        assert layers[1]["wqkv"].shape == (64, 192)
        before = params[tower]["tower"]["wo"][1].clone()
        layers[1]["wo"].add_(1.0)
        assert torch.equal(params[tower]["tower"]["wo"][1], before + 1.0)
        assert out[tower]["patch_embed" if tower == "vision" else "embed"] \
            is params[tower]["patch_embed" if tower == "vision" else "embed"]
    assert out["logit_scale"] is params["logit_scale"]
    # leaf order: sorted keys, each tower's layers in order
    n_stacked = len(tree_leaves(params))
    assert len(tree_leaves(out)) == n_stacked + 2 * 6 * (2 - 1)


@pytest.mark.parametrize("name", ["llama", "moe", "mamba", "jamba"])
def test_llama_moe_and_mamba_trees_unstack_as_before(name):
    tiny = LLAMA_CONFIGS["tiny"]
    params = {"llama": lambda: init_params(tiny, seed=0, device="cpu"),
              "moe": lambda: init_params(dataclasses.replace(
                  tiny, n_experts=4), seed=0, device="cpu"),
              "mamba": lambda: init_mamba(MAMBA_CONFIGS["tiny"], seed=0,
                                          device="cpu"),
              "jamba": lambda: init_mamba(MAMBA_CONFIGS["jamba_tiny"],
                                          seed=0, device="cpu")}[name]()
    _same_views(unstack_layers(params), _top_level_unstack(params))
    assert unstack_layers(params).keys() == params.keys()


def test_resnet_lists_stay_lists_in_and_out():
    params = init_resnet(RESNET_CONFIGS["tiny"], seed=0, device="cpu")
    out = unstack_layers(params)
    _same_views(out, params)
    back = params_to_numpy(out)
    assert isinstance(back["stages"], list)
    assert isinstance(back["stages"][1], list)
    assert "proj" in back["stages"][1][0]
    np.testing.assert_array_equal(back["stages"][1][0]["proj"],
                                  params["stages"][1][0]["proj"].numpy())


def test_tree_unflatten_keeps_order_and_frees_leaves_without_the_collector():
    """``tree_unflatten`` is ``tree_leaves``'s inverse (dict order kept,
    lists and tuples kept), and the tree it builds is freed when its last
    reference goes: the rebuild makes no reference cycle, which would keep
    every leaf (a pipeline stage's params) until the cyclic collector
    happened to run."""
    import gc
    import weakref

    skeleton = {"b": [0, (0, 0)], "a": {"y": 0, "x": 0}}
    leaves = [torch.full((2,), float(i)) for i in range(5)]
    enabled = gc.isenabled()
    gc.disable()
    try:
        out = tree_unflatten(skeleton, leaves)
        assert list(out) == ["b", "a"] and list(out["a"]) == ["y", "x"]
        assert isinstance(out["b"], list) and isinstance(out["b"][1], tuple)
        assert all(a is b for a, b in zip(tree_leaves(out), leaves))
        refs = [weakref.ref(t) for t in leaves]
        del out, leaves
        assert [r() for r in refs] == [None] * 5
    finally:
        if enabled:
            gc.enable()


def test_params_to_numpy_stacks_nested_groups_again():
    params = init_clip(CLIP_CONFIGS["tiny"], seed=1, device="cpu")
    back = params_to_numpy(unstack_layers(params))
    want = params_to_numpy(params)
    assert back["text"]["tower"]["w_up"].shape == (2, 64, 256)
    for a, b in zip(tree_leaves(back), tree_leaves(want), strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("model", ["clip", "resnet"])
def test_opt_state_from_jax_splits_nested_groups(model):
    """optax adamw state of a CLIP tree (nested towers, a 0-d logit scale)
    and of a ResNet tree (lists of blocks) carries into the trainer's
    state leaf for leaf; zero moments, count 0."""
    if model == "clip":
        jp = jclip.init_clip(jax.random.PRNGKey(0), jclip.CLIP_CONFIGS["tiny"])
    else:
        jp = jvision.init_resnet(jax.random.PRNGKey(0),
                                 jvision.RESNET_CONFIGS["tiny"])
    jp = jax.tree.map(np.asarray, jp)
    jstate = jax.tree.map(np.asarray, optax.adamw(1e-3).init(jp))
    init_fn, _, _ = make_train_step(lambda p, b: 0.0, adamw(1e-3),
                                    device="cpu")
    state = init_fn(params_from_jax(jp, device="cpu"))
    opt = opt_state_from_jax(jstate, state.params, device="cpu")
    assert opt.count == 0
    for p, m in zip(tree_leaves(state.params), tree_leaves(opt.mu),
                    strict=True):
        assert p.shape == m.shape and not bool(m.any())
    if model == "clip":
        assert isinstance(opt.mu["vision"]["tower"], list)
        assert opt.nu["logit_scale"].shape == ()
