"""Train-step factory (counterpart of ``ray_tpu/train/step.py``).

``step_fn`` runs the loss's forward and backward, the global gradient
norm and the optimizer update in place: the reference donates its state
to a jitted step, the port updates the same tensors. With ``mesh=`` the
params are DTensors placed by their logical axes (``shard_pytree``),
AdamW's moments mirror them, batches shard by ("batch", "seq"), and the
grad norm is the global one.

Inside a training session (``session=``, a callable that returns the
current session or None) the step and ``place_batch`` report to it as the
reference's do: compile, compute and host-to-device intervals, the
compile kind, recompiles, tokens, flops and chips. The session is the
host plane's (``ray_tpu.train``'s, or any object with ``telemetry_on``,
``timeline.record_interval`` and ``note_step``); the port imports none
of it.

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

import os
import time
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor

from .._private.device import DeviceLike, resolve_device
from .._private.tree import tree_leaves, tree_map, unstack_layers
from ..ops._kernels import BUILD_DIR
from ..parallel.sharding import (DEFAULT_RULES, distribute_batch,
                                 distribute_pytree)
from ..util.tracing import span
from .telemetry import StepInstrumenter

# the port's convention: a rank drives one card (or, on the CPU, one
# process), so each rank reports 1 chip and the ledger's fold sums them
CHIPS_PER_RANK = 1


class TrainState(NamedTuple):
    step: torch.Tensor      # int32 scalar on the device
    params: Any             # the trainer's tree (per-layer leaves)
    opt_state: Any


def _full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


# ---- the session's helpers (the reference's, on tensors) --------------

def _dtype_name(x) -> str:
    dtype = getattr(x, "dtype", "?")
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")    # numpy's name
    return str(dtype)


def _batch_signature(batch) -> str:
    """The batch's shapes and dtypes in the reference's format
    (``"(4, 24)/int32,..."``, leaves in sorted-key order, numpy dtype
    names), so that one batch gives one string in both packages: the
    unit the recompile detector keys on."""
    return ",".join(f"{tuple(getattr(x, 'shape', ()))}/{_dtype_name(x)}"
                    for x in tree_leaves(batch))


def _numel(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel()        # a DTensor's is its global count
    return int(getattr(x, "size", 0))


def _batch_tokens(batch) -> int:
    """Tokens for the throughput math: the ``tokens`` leaf's element
    count when the batch names one, else the largest leaf's."""
    if isinstance(batch, dict) and "tokens" in batch:
        return _numel(batch["tokens"])
    return max((_numel(x) for x in tree_leaves(batch)), default=0)


def _kernel_cache_entries() -> int:
    """Entries of the kernel build directory, the port's stand-in for the
    reference's XLA cache count: a first call that built a kernel
    library adds one, a call that only loaded one adds none."""
    try:
        return len(os.listdir(BUILD_DIR))
    except FileNotFoundError:
        return 0


def make_train_step(loss_fn: Callable[..., torch.Tensor], optimizer,
                    device: DeviceLike = None,
                    model_flops_per_token: Optional[float] = None, *,
                    mesh=None, param_axes=None, rules=DEFAULT_RULES,
                    session: Optional[Callable[[], Any]] = None,
                    on_recompile: Optional[Callable[[str, str], None]] = None,
                    compile_hit_threshold_s: float = 0.5):
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

    ``session`` returns the current training session or None (inside
    ``ray_tpu.train``: ``lambda: ray_tpu.train.session._session``). When
    it returns one with ``telemetry_on``, step_fn and place_batch are
    instrumented as the reference's: each call is timed to the card's
    sync (``torch.cuda.synchronize``; nothing on the CPU) and recorded in
    ``session.timeline`` as "compile" (the first call for a batch
    signature), "compute" or "host_to_device", and every step goes to
    ``session.note_step`` with the batch's tokens, ``model_flops_per_token
    * tokens`` flops, the compile kind ("cold" when the call built a
    kernel library, else by ``compile_hit_threshold_s``, the reference's
    ``train_compile_cache_hit_threshold_s``), the recompile flag, the batch
    signature and ``CHIPS_PER_RANK`` chips. A new signature after the
    first calls ``on_recompile(old, new)``. Under a mesh every rank is
    given the whole batch and reports its tokens and flops, as every
    process of the reference's gang does for its global batch; the
    ledger's fold sums the ranks. Otherwise the step is the bare one,
    with no sync.
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
        with span("train.forward_backward"):
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
        with torch.no_grad(), span("train.grad_norm"):
            # an f32 sum of squares over all leaves, whatever their dtype;
            # ray_tpu reports optax.global_norm, which sums in the leaf
            # dtype (bf16 at 8B). Equal in f32; no update reads the norm
            grad_norm = torch.stack([
                torch.linalg.vector_norm(g, dtype=torch.float32).square()
                for g in grads]).sum().sqrt()
            grad_norm = _full(grad_norm)
        with span("train.optimizer"):
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
    if session is None:
        return init_fn, step_fn, place_batch
    instrumenter = StepInstrumenter(
        cache_entries=_kernel_cache_entries,
        hit_threshold_s=compile_hit_threshold_s, on_recompile=on_recompile)

    def block(out):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    def instrumented_step(state: TrainState, batch):
        sess = session()
        if sess is None or not sess.telemetry_on:
            return step_fn(state, batch)
        sig = _batch_signature(batch)
        out = instrumenter.run(lambda: step_fn(state, batch), sig,
                               block=block)
        last = instrumenter.last
        sess.timeline.record_interval(last["phase"], last["t0"], last["t1"])
        tokens = _batch_tokens(batch)
        sess.note_step(tokens=tokens,
                       flops=(model_flops_per_token or 0.0) * tokens,
                       chips=CHIPS_PER_RANK,
                       compile_kind=last["compile_kind"],
                       recompile=last["recompile"], batch_shape=sig)
        return out

    def instrumented_place(batch):
        sess = session()
        if sess is None or not sess.telemetry_on:
            return place_batch(batch)
        t0 = time.time()
        placed = block(place_batch(batch))
        sess.timeline.record_interval("host_to_device", t0, time.time())
        return placed

    instrumented_step.model_flops_per_token = model_flops_per_token
    return init_fn, instrumented_step, instrumented_place


def make_eval_step(loss_fn: Callable[..., torch.Tensor]):
    def eval_fn(params, batch):
        with torch.no_grad():
            return loss_fn(params, batch)

    return eval_fn
