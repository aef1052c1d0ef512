"""Train-step factory (counterpart of ``ray_tpu/train/step.py`` outside
a training session).

``step_fn`` runs the loss's forward and backward, the global gradient
norm and the optimizer update in place: the reference donates its state
to a jitted step, the port updates the same tensors. With ``mesh=`` the
params are DTensors placed by their logical axes (``shard_pytree``),
AdamW's moments mirror them, batches shard by ("batch", "seq"), and the
grad norm is the global one. The reference's session and telemetry
plane is host plane and is not ported.

Parameter layout: ``init_fn`` turns the stacked tree into the trainer's
tree, whose stacked layer groups (``"layers"``, and any ``"*_layers"``)
are lists of per-layer dicts of leaves that are views of the stacked
tensors (``unstack_layers``). Autograd then gives
one gradient per layer and name: slicing a stacked leaf inside the
forward would make every layer's backward add a zero tensor of the whole
stacked leaf into its gradient (3.76 GB for ``w_gate`` at 8B). The
updates land in the stacked tensors, which the serving path and
``params_to_numpy`` read as they are.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.profiler import record_function

from torch.distributed.tensor import DTensor

from .._private.device import DeviceLike, resolve_device
from .._private.tree import tree_leaves, tree_map, unstack_layers
from ..parallel.sharding import (DEFAULT_RULES, distribute_batch,
                                 distribute_pytree)


class TrainState(NamedTuple):
    step: torch.Tensor      # int32 scalar on the device
    params: Any             # the trainer's tree (per-layer leaves)
    opt_state: Any


def _full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def make_train_step(loss_fn: Callable[..., torch.Tensor], optimizer,
                    device: DeviceLike = None,
                    model_flops_per_token: Optional[float] = None, *,
                    mesh=None, param_axes=None, rules=DEFAULT_RULES):
    """Build ``(init_fn, step_fn, place_batch)`` for
    ``loss_fn(params, batch) -> scalar``.

    init_fn(params) -> TrainState on ``device`` (default: the card).
    step_fn(state, batch) -> (state, {"loss", "grad_norm", "step"}),
    metrics left as device tensors (no sync inside the step).
    place_batch(batch) moves a dict of int arrays to the device.
    ``model_flops_per_token`` is kept as ``step_fn.model_flops_per_token``
    for the caller's MFU.

    With ``mesh`` (on ``device``'s type) and ``param_axes`` (the params'
    logical axes, e.g. ``param_logical_axes(cfg)``), every rank calls
    these with the same full params and batches: init_fn places each leaf
    as a DTensor by ``shard_pytree`` and AdamW's moments mirror it,
    place_batch shards by ("batch", "seq"), and the metrics are the
    global values on every rank. ``loss_fn`` runs the model with the same
    mesh (``lm_loss(..., mesh=mesh)``).
    """
    dev = resolve_device(device)
    if mesh is not None:
        if param_axes is None:
            raise ValueError("make_train_step(mesh=...) needs param_axes")
        if mesh.device_type != dev.type:
            raise ValueError(f"the mesh is on {mesh.device_type}, the "
                             f"trainer on {dev}")

    def init_fn(params) -> TrainState:
        params = tree_map(lambda t: t.to(dev), params)
        if mesh is not None:
            params = distribute_pytree(params, param_axes, mesh, rules)
        params = unstack_layers(params)
        leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
        return TrainState(torch.zeros((), dtype=torch.int32, device=dev),
                          leaves, optimizer.init(leaves))

    def step_fn(state: TrainState, batch):
        leaves = tree_leaves(state.params)
        with record_function("train.forward_backward"):
            loss = loss_fn(state.params, batch)
            loss.backward()
        # a leaf the loss does not reach has a zero gradient, as in JAX;
        # a DTensor's comes back at its param's placements
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in leaves]
        if mesh is not None:
            grads = [g if g.placements == p.placements else
                     g.redistribute(p.device_mesh, p.placements)
                     for p, g in zip(leaves, grads)]
        with torch.no_grad(), record_function("train.grad_norm"):
            # an f32 sum of squares over all leaves, whatever their dtype;
            # ray_tpu reports optax.global_norm, which sums in the leaf
            # dtype (bf16 at 8B). Equal in f32; no update reads the norm
            grad_norm = torch.stack([
                torch.linalg.vector_norm(g, dtype=torch.float32).square()
                for g in grads]).sum().sqrt()
            grad_norm = _full(grad_norm)
        with record_function("train.optimizer"):
            optimizer.update_(state.params, grads, state.opt_state)
        for p in leaves:
            p.grad = None
        step = state.step + 1
        return (TrainState(step, state.params, state.opt_state),
                {"loss": _full(loss.detach()), "grad_norm": grad_norm,
                 "step": step})

    def place_batch(batch):
        placed = {k: torch.as_tensor(v).to(dev, non_blocking=True)
                  for k, v in batch.items()}
        if mesh is None:
            return placed
        return {k: distribute_batch(t, mesh, rules)
                for k, t in placed.items()}

    step_fn.model_flops_per_token = model_flops_per_token
    return init_fn, step_fn, place_batch


def make_eval_step(loss_fn: Callable[..., torch.Tensor]):
    def eval_fn(params, batch):
        with torch.no_grad():
            return loss_fn(params, batch)

    return eval_fn
