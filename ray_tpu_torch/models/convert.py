"""Carry a ``ray_tpu`` parameter tree (and its optax AdamW state, and its
LoRA adapters) into the port, and a port tree back out as numpy.

The input is the JAX tree with its leaves already turned into numpy
arrays (``jax.tree.map(np.asarray, params)``), so this module needs
neither JAX nor ``ray_tpu``. bf16 leaves arrive as ``ml_dtypes.bfloat16``
arrays, which torch cannot take; they go through float32 (exact) and back
to bfloat16. Quantized ``{"q", "s"}`` leaves convert leaf for leaf. Trees
may hold lists (an RL policy's ``params["layers"]``), kept as lists, and
Python float leaves (SAC's initial ``log_alpha``), which become f32 as JAX
weak-types them.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .._private.device import resolve_device
from .._private.tree import is_layer_group, tree_leaves, unstack_layers
from ..train.optim import AdamState


def _leaf(a: Any, dev: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype == np.float64:
        # JAX (without x64) holds no f64 array: this is a Python float
        # leaf, which JAX weak-types to f32
        arr = arr.astype(np.float32)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=dev, dtype=torch.bfloat16)
    return torch.tensor(arr, device=dev)


def params_from_jax(tree, device=None):
    """Nested dicts and lists of numpy leaves → the same tree of tensors on
    ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return _leaf(node, dev)

    return walk(tree)


def lora_from_jax(adapter, device=None):
    """A ``ray_tpu`` LoRA adapter (``ray_tpu.llm.lora.init_lora_adapter``'s
    dict with numpy leaves) -> the port's adapter dict: ``a_q``, ``b_q``,
    ``a_v`` and ``b_v`` as tensors on ``device`` (default: the CUDA card)
    in their own dtype, ``scale`` as a float."""
    dev = resolve_device(device)
    out = {k: _leaf(adapter[k], dev) for k in ("a_q", "b_q", "a_v", "b_v")}
    out["scale"] = float(np.asarray(adapter.get("scale", 1.0)))
    return out


def _find_adam_state(node):
    """optax's ``ScaleByAdamState(count, mu, nu)`` inside the chained
    state of ``optax.adamw`` or ``optax.adam`` (the other states of the
    chain are empty)."""
    if all(hasattr(node, f) for f in ("count", "mu", "nu")):
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _find_adam_state(child)
            if found is not None:
                return found
    return None


def opt_state_from_jax(opt_state, params, device=None) -> AdamState:
    """optax ``adamw`` or ``adam`` state with numpy leaves → the port's
    :class:`AdamState` for ``params`` (the trainer's tree, or an RL
    learner's): mu and nu leaf for leaf, split per layer where ``params``
    stacks layers and the trainer's tree splits them, and optax's
    ``count``, so a run resumes with the same bias correction."""
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no ScaleByAdamState(count, mu, nu) in the state")
    mu = params_from_jax(adam.mu, device)
    nu = params_from_jax(adam.nu, device)
    if _has_split_group(params):
        # stacked groups are split, at any depth; a group that is a list
        # already (an RL policy's) is left as it is
        mu, nu = unstack_layers(mu), unstack_layers(nu)
    for p, m, n in zip(tree_leaves(params), tree_leaves(mu),
                       tree_leaves(nu), strict=True):
        if not (p.shape == m.shape == n.shape and p.dtype == m.dtype):
            raise ValueError(f"moment {tuple(m.shape)} {m.dtype} does not "
                             f"match its param {tuple(p.shape)} {p.dtype}")
    return AdamState(int(np.asarray(adam.count)), mu, nu)


def _has_split_group(tree) -> bool:
    """Whether a layer group (``is_layer_group``) anywhere in ``tree`` is a
    per-layer list, as in the trainer's tree."""
    if isinstance(tree, dict):
        return any((is_layer_group(k) and isinstance(v, list))
                   or _has_split_group(v) for k, v in tree.items())
    if isinstance(tree, list):
        return any(_has_split_group(v) for v in tree)
    return False


def params_to_numpy(params):
    """A port tree → the same tree of numpy arrays in the reference's
    stacked layout: a per-layer list under a layer-group key
    (``is_layer_group``) is stacked again, any other list (a ResNet's
    stages and blocks) stays a list; bf16 leaves come out as float32,
    exactly."""

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            items = [walk(n) for n in node]
            if not is_layer_group(key):
                return items
            return {k: np.stack([lp[k] for lp in items]) for k in items[0]}
        t = node.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return walk(params)
