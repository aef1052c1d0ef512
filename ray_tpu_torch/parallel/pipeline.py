"""Pipeline parallelism over the "pp" mesh axis (counterpart of
``ray_tpu/parallel/pipeline.py``).

GPipe-style microbatch pipelining as one SPMD program: inside
``shard_map`` over the pp axis each rank holds its stage's parameters
(the leading "stage" dim sharded) and runs the same M + P - 1 ticks;
each tick moves activations one stage forward with the differentiable
shift (``send``), so the backward pipeline follows through autograd:
each rank's graph holds every tick's shift, so every rank runs their
backward shifts in the same order. The bubble is the standard
(P - 1) / (M + P - 1).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.distributed.device_mesh import DeviceMesh

from .._private.tree import tree_leaves, tree_map, tree_unflatten
from .collectives import allreduce, axis_index, send, shard_map
from .mesh import axis_sizes


def split_stages(params: Any, n_stages: int) -> Any:
    """Reshape layer-stacked params (L, ...) into (n_stages, L // n_stages,
    ...): the leading stage axis is what the pipeline shards over pp."""
    def leaf(p):
        L = p.shape[0]
        assert L % n_stages == 0, f"layers {L} not divisible by {n_stages} stages"
        return p.reshape(n_stages, L // n_stages, *p.shape[1:])

    return tree_map(leaf, params)


def pipeline_apply(mesh: DeviceMesh, stage_fn: Callable, stage_params: Any,
                   x: torch.Tensor, *, microbatches: int,
                   axis: str = "pp") -> torch.Tensor:
    """Run ``stage_fn`` as a P-stage pipeline over ``x``.

    stage_fn(stage_local_params, activations) -> activations: one stage's
    compute (its share of layers); its params have the leading per-stage
    layer dim (the stage axis stripped). stage_params: a tree with a
    leading stage axis of size ``mesh``'s ``axis`` (see split_stages),
    held whole by every rank. x: (B, ...), B divisible by
    ``microbatches``. Returns the whole output on every rank."""
    n_stages = axis_sizes(mesh)[axis]
    B = x.shape[0]
    assert B % microbatches == 0, "batch not divisible by microbatches"
    M = microbatches
    xm = x.reshape(M, B // M, *x.shape[1:])
    leaves = tree_leaves(stage_params)

    def per_rank(xm_local, *leaves_local):
        # leaves_local: (1, layers_per_stage, ...): strip the stage dim
        params_here = tree_unflatten(stage_params,
                                     [leaf[0] for leaf in leaves_local])
        s = axis_index(axis)
        first = torch.tensor(s == 0)
        state = torch.zeros_like(xm_local[0])
        outputs = [torch.zeros_like(xm_local[0])] * M
        for t in range(M + n_stages - 1):
            # stage 0 takes microbatch t; later stages what the last
            # tick's shift delivered. Selections keep both sides in the
            # graph, as jnp.where does: every rank then runs every
            # shift's backward, in the same order
            inp = torch.where(first, xm_local[min(t, M - 1)], state)
            y = stage_fn(params_here, inp)
            idx = t - s
            # inactive ticks send zeros, so the sum over pp stays exact
            active = torch.tensor(0 <= idx < M)
            y = torch.where(active, y, torch.zeros_like(y))
            # the last stage records its finished microbatch
            out_idx = min(max(idx, 0), M - 1)
            keep = torch.tensor(0 <= idx < M and s == n_stages - 1)
            outputs[out_idx] = torch.where(keep, y, outputs[out_idx])
            state = send(y, axis, shift=1)
        # only the last stage wrote outputs: the sum over pp replicates
        # them to every stage
        return allreduce(torch.stack(outputs), axis)

    out = shard_map(per_rank, mesh, [()] + [(axis,)] * len(leaves), ())(
        xm, *leaves)
    return out.reshape(B, *x.shape[1:])
