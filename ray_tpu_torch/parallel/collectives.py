"""Collective ops over mesh axes (counterpart of
``ray_tpu/parallel/collectives.py``), on ``torch.distributed``.

Two usage modes, as in the reference:

1. **Symbolic, inside a per-rank region** (``shard_map``, the counterpart
   of ``jax.shard_map``): ``allreduce(x, axis="tp")`` etc. take this
   rank's local tensor and run over ``mesh.get_group(axis)`` (a tuple of
   axes runs over the group of their flattened sub-mesh, ranked in the
   tuple's row-major order, as ``jax.lax.axis_index`` ranks it). Each
   linear op is differentiable, its backward being its transpose, as JAX
   differentiates a collective inside ``shard_map``: psum's is psum,
   all-gather's reduce-scatter, ppermute's the opposite shift.
2. **Eager** (``pgroup(mesh, axis)``): a ``ProcessGroup`` whose methods
   run one op over the axis. The reference holds a global array with the
   rank on its leading axis; here every rank is a process, passes its own
   slice and gets its row of the reference's result.

The reference's stall sentinel reports arrivals to, and waits on, the
cluster's control store; the port is device plane only, so both are
``CollectiveHooks`` whose defaults do nothing. ``allreduce(op="prod")``
is ``ReduceOp.PRODUCT``, exact, where the reference takes exp(psum(log))
with a sign and a zero test.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import math
import threading
import time
from typing import Callable, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate

from .._private.device import resolve_device
from ..exceptions import CollectiveTimeoutError
from .mesh import active_mesh, axis_sizes, mesh_cache
from .sharding import Spec, spec_placements

AxisName = Union[str, tuple]

_REGION = threading.local()


# ---------------------------------------------------------------------------
# The per-rank region.
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def rank_region(mesh: DeviceMesh):
    """Name ``mesh`` as the one whose axes the symbolic ops reduce over,
    for the block (``shard_map`` enters it around its function)."""
    prev = getattr(_REGION, "mesh", None)
    _REGION.mesh = mesh
    try:
        yield mesh
    finally:
        _REGION.mesh = prev


def current_mesh() -> DeviceMesh:
    mesh = getattr(_REGION, "mesh", None)
    if mesh is None:
        raise RuntimeError("a symbolic collective runs inside a per-rank "
                           "region: shard_map(fn, mesh, ...) or "
                           "rank_region(mesh)")
    return mesh


def _names(axis: AxisName) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_group(axis: AxisName, mesh: Optional[DeviceMesh] = None):
    """(process group, size) of ``axis`` (a name or a tuple of names) on
    ``mesh`` (default: the region's). A tuple's group is made once, by
    every rank of the mesh, and kept."""
    mesh = mesh if mesh is not None else current_mesh()
    names = _names(axis)
    if len(names) == 1:
        return mesh.get_group(names[0]), axis_sizes(mesh)[names[0]]
    groups = mesh_cache(mesh).setdefault("groups", {})
    if names not in groups:
        dims = [mesh.mesh_dim_names.index(n) for n in names]
        rest = [d for d in range(mesh.mesh.ndim) if d not in dims]
        rows = mesh.mesh.permute(*rest, *dims).reshape(
            -1, math.prod(mesh.mesh.shape[d] for d in dims))
        me = dist.get_rank()
        mine = None
        for row in rows.tolist():
            group = dist.new_group(row)
            if me in row:
                mine = group
        groups[names] = (mine, rows.shape[1])
    return groups[names]


def axis_index(axis: AxisName, mesh: Optional[DeviceMesh] = None) -> int:
    """This rank's index along ``axis`` (``jax.lax.axis_index``)."""
    group, _ = axis_group(axis, mesh)
    return dist.get_group_rank(group, dist.get_rank())


def axis_size(axis: AxisName, mesh: Optional[DeviceMesh] = None) -> int:
    return axis_group(axis, mesh)[1]


# ---------------------------------------------------------------------------
# Mode 1: symbolic ops on local tensors, each differentiable by its
# transpose.
# ---------------------------------------------------------------------------


def _psum(x, group):
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _gather0(x, group, n):
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def _scatter0(x, group, n):
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out


def _all_to_all(x, group, n, split_axis, concat_axis):
    chunks = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    out = torch.empty_like(chunks)
    dist.all_to_all_single(out, chunks, group=group)
    return torch.cat(out.unbind(0), dim=concat_axis)


def _shift(x, group, n, shift):
    """Rank i's ``x`` lands on rank (i + shift) % n of the group."""
    me = dist.get_group_rank(group, dist.get_rank())
    dst, src = (me + shift) % n, (me - shift) % n
    x = x.contiguous()
    if dst == me:
        return x.clone()
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, dist.get_global_rank(group, dst), group),
        dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group)])
    for req in reqs:
        req.wait()
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return _gather0(x.movedim(dim, 0), group, n).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        out = _scatter0(g.movedim(ctx.dim, 0), ctx.group, ctx.n)
        return out.movedim(0, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return _scatter0(x.movedim(dim, 0), group, n).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        out = _gather0(g.movedim(ctx.dim, 0), ctx.group, ctx.n)
        return out.movedim(0, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_axis, concat_axis):
        ctx.args = (group, n, concat_axis, split_axis)
        return _all_to_all(x, group, n, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, shift):
        ctx.group, ctx.n, ctx.shift = group, n, shift
        return _shift(x, group, n, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, ctx.n, -ctx.shift), None, None, None


def allreduce(x, axis: AxisName, op: str = "sum"):
    """Allreduce along a mesh axis: sum and mean differentiable, max,
    min and prod (``ReduceOp.PRODUCT``, exact) not."""
    group, n = axis_group(axis)
    if op == "sum":
        return _Psum.apply(x, group)
    if op == "mean":
        return _Psum.apply(x, group) / n
    reduce_op = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
                 "prod": dist.ReduceOp.PRODUCT}.get(op)
    if reduce_op is None:
        raise ValueError(f"unsupported reduce op: {op}")
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=reduce_op, group=group)
    return out


def allgather(x, axis: AxisName, *, concat_axis: int = 0,
              tiled: bool = True):
    """Allgather along a mesh axis: the ranks' tensors concatenated along
    ``concat_axis`` (``tiled``) or stacked on a new axis there."""
    group, n = axis_group(axis)
    if not tiled:
        x = x.unsqueeze(concat_axis)
    return _AllGather.apply(x, group, n, concat_axis % x.dim())


def reducescatter(x, axis: AxisName, *, scatter_axis: int = 0,
                  op: str = "sum"):
    """Reduce-scatter along a mesh axis: rank i keeps the i-th block of
    ``scatter_axis`` of the sum (or mean)."""
    if op not in ("sum", "mean"):
        raise ValueError("reducescatter supports sum/mean")
    group, n = axis_group(axis)
    out = _ReduceScatter.apply(x, group, n, scatter_axis % x.dim())
    return out / n if op == "mean" else out


def broadcast(x, axis: AxisName, root: int = 0):
    """The root rank's value on every rank along ``axis`` (the
    reference's masked psum)."""
    keep = torch.tensor(axis_index(axis) == root, device=x.device)
    return allreduce(torch.where(keep, x, torch.zeros_like(x)), axis)


def alltoall(x, axis: AxisName, *, split_axis: int, concat_axis: int):
    """All-to-all: scatter ``split_axis``, gather ``concat_axis`` (tiled)."""
    group, n = axis_group(axis)
    return _AllToAll.apply(x, group, n, split_axis % x.dim(),
                           concat_axis % x.dim())


def send(x, axis: AxisName, *, shift: int = 1):
    """Neighbour p2p along a ring (``ppermute``): every rank sends to
    rank + shift and receives from rank - shift."""
    group, n = axis_group(axis)
    return _Shift.apply(x, group, n, shift)


def recv(x, axis: AxisName, *, shift: int = 1):
    """Inverse permutation of ``send``: ``recv(send(x, shift=k), shift=k)
    == x``."""
    return send(x, axis, shift=-shift)


# ---------------------------------------------------------------------------
# shard_map: global values in, per-rank function, global values out.
# ---------------------------------------------------------------------------


def _block(x, mesh: DeviceMesh, spec: Spec):
    """This rank's block of the global ``x`` under ``spec``."""
    coord = mesh.get_coordinate()
    names = mesh.mesh_dim_names
    sizes = axis_sizes(mesh)
    for dim, part in enumerate(spec):
        if part is None:
            continue
        idx, n = 0, 1
        for a in _names(part):
            idx = idx * sizes[a] + coord[names.index(a)]
            n *= sizes[a]
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {part} ({n})")
        size = x.shape[dim] // n
        x = x.narrow(dim, idx * size, size)
    return x


def _mentioned(spec: Spec):
    return {a for part in spec if part is not None for a in _names(part)}


def _unmentioned_size(mesh: DeviceMesh, spec: Spec) -> int:
    m = _mentioned(spec)
    return math.prod(n for a, n in axis_sizes(mesh).items() if a not in m)


def _whole(mesh: DeviceMesh):
    """(group, size) over every mesh axis of size > 1 (None when 1)."""
    names = tuple(a for a, n in axis_sizes(mesh).items() if n > 1)
    return axis_group(names, mesh) if names else (None, 1)


class _In(torch.autograd.Function):
    """A global value entering the region: forward, this rank's block;
    backward, the block's cotangent in a zero tensor of the global shape,
    summed over the mesh (the transpose of a broadcast)."""

    @staticmethod
    def forward(ctx, x, mesh, spec):
        ctx.mesh, ctx.spec, ctx.shape = mesh, spec, x.shape
        return _block(x, mesh, spec).clone()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        _block(full, ctx.mesh, ctx.spec).copy_(g)
        group, n = _whole(ctx.mesh)
        if n > 1:
            dist.all_reduce(full, group=group)
        return full, None, None


class _Out(torch.autograd.Function):
    """A rank's block leaving the region as the global value: forward,
    the blocks gathered over the spec's axes; backward, this rank's block
    of the cotangent over the number of ranks that hold the same block
    (JAX divides so, so that psum's transpose gives it back whole)."""

    @staticmethod
    def forward(ctx, y, mesh, spec):
        ctx.mesh, ctx.spec = mesh, spec
        for dim in reversed(range(len(spec))):
            if spec[dim] is not None:
                group, n = axis_group(spec[dim], mesh)
                y = _gather0(y.movedim(dim, 0), group, n).movedim(0, dim)
        return y.contiguous()

    @staticmethod
    def backward(ctx, g):
        return (_block(g, ctx.mesh, ctx.spec)
                / _unmentioned_size(ctx.mesh, ctx.spec), None, None)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _grad_placements(mesh: DeviceMesh, spec: Spec):
    """A local block's gradient placements: sharded where the spec shards,
    partial (summed when it leaves) along the other axes of size > 1."""
    placements = list(spec_placements(mesh, spec))
    for d, n in enumerate(active_mesh(mesh).mesh.shape):
        if n > 1 and isinstance(placements[d], Replicate):
            placements[d] = Partial()
    return placements


def _enter(x, mesh, spec):
    if isinstance(x, DTensor):
        _block(torch.empty(x.shape, device="meta"), mesh, spec)  # even?
        placements = spec_placements(mesh, spec)
        if tuple(x.placements) != placements:
            x = x.redistribute(active_mesh(mesh), placements)
        return x.to_local(grad_placements=_grad_placements(mesh, spec))
    if isinstance(x, torch.Tensor):
        return _In.apply(x, mesh, spec)
    return x


def _leave(y, mesh, spec, as_dtensor):
    if not as_dtensor:
        return _Out.apply(y, mesh, spec)
    n = _unmentioned_size(mesh, spec)
    if n > 1:
        y = _ScaleGrad.apply(y, 1.0 / n)
    shape = list(y.shape)
    sizes = axis_sizes(mesh)
    for dim, part in enumerate(spec):
        if part is not None:
            shape[dim] *= math.prod(sizes[a] for a in _names(part))
    shape = torch.Size(shape)
    stride = torch.empty(shape, device="meta").stride()
    # DTensor views the local tensor by the global strides
    return DTensor.from_local(y.contiguous(), active_mesh(mesh),
                              spec_placements(mesh, spec),
                              shape=shape, stride=stride)


def shard_map(fn: Callable, mesh: DeviceMesh, in_specs,
              out_specs) -> Callable:
    """The counterpart of ``jax.shard_map`` on ``mesh``: ``fn`` runs on
    each rank's blocks of the inputs, inside ``rank_region(mesh)``, and
    its outputs are put back together as global values.

    Specs are the tuples ``_spec_for`` gives (one part a dim: None, an
    axis, or a tuple of axes); ``in_specs`` is one spec for every
    argument or a list of one an argument, ``out_specs`` one spec or a
    list of one an output. A DTensor argument is redistributed to
    its spec and its local tensor taken; a plain tensor is a global value
    held alike by every rank, and its block is sliced. Blocks are even,
    as in JAX (``sharding.fit_spec`` fits a spec to a shape). Outputs
    are DTensors when any argument is one, else plain global tensors,
    gathered. Gradients follow JAX's rules for ``shard_map``."""

    def one_spec(specs):
        return not isinstance(specs, list)

    def wrapped(*args):
        ins = [in_specs] * len(args) if one_spec(in_specs) else in_specs
        as_dtensor = any(isinstance(a, DTensor) for a in args)
        local = [_enter(a, mesh, s) for a, s in zip(args, ins, strict=True)]
        with rank_region(mesh):
            out = fn(*local)
        single = not isinstance(out, (tuple, list))
        outs = (out,) if single else tuple(out)
        specs = ([out_specs] * len(outs) if one_spec(out_specs)
                 else out_specs)
        res = tuple(_leave(y, mesh, s, as_dtensor)
                    for y, s in zip(outs, specs, strict=True))
        return res[0] if single else res

    return wrapped


# ---------------------------------------------------------------------------
# Mode 2: eager process groups.
# ---------------------------------------------------------------------------


class CollectiveHooks:
    """The stall sentinel's calls to the cluster's control store, which
    the reference makes through its runtime: the defaults do nothing, as
    the reference does outside a cluster. ``note_arrival`` records a
    rank's arrival at (group, step) and returns the store's reply or None;
    ``await_peers`` blocks until every rank of (group, step) arrived and
    returns ``{"complete": bool, "missing": [...], "arrived": n}``, or
    None when there is no store."""

    def note_arrival(self, group: str, step: int, rank: int, size: int,
                     op: str, t: float,
                     deadline_s: Optional[float]) -> Optional[dict]:
        return None

    def await_peers(self, group: str, step: int, timeout_s: float,
                    size: int) -> Optional[dict]:
        return None


_NO_HOOKS = CollectiveHooks()


class ProcessGroup:
    """Imperative collective API over one mesh axis (the reference's
    ``ProcessGroup``).

    Input convention: rank r passes its own slice, the reference's
    ``x[r * chunk:(r + 1) * chunk]`` of a global array whose leading axis
    is the rank axis, and gets its row of the reference's result (for
    ``allgather``, the whole gathered array). ``rank`` and
    ``world_size``, which the stall sentinel reports, default to this
    rank's index along the axis and the axis size: every rank is a
    process here."""

    def __init__(self, mesh: DeviceMesh, axis: str, *,
                 group_name: Optional[str] = None,
                 rank: Optional[int] = None,
                 world_size: Optional[int] = None,
                 hooks: Optional[CollectiveHooks] = None):
        if axis not in mesh.mesh_dim_names:
            raise ValueError(
                f"axis {axis!r} not in mesh {mesh.mesh_dim_names}")
        self.mesh = mesh
        self.axis = axis
        self.group_name = group_name
        self.rank = rank if rank is not None else axis_index(axis, mesh)
        self.world_size = (world_size if world_size is not None
                           else self.size)
        self.hooks = hooks if hooks is not None else _NO_HOOKS
        self._step = 0

    @property
    def size(self) -> int:
        return axis_sizes(self.mesh)[self.axis]

    # ------------------------------------------------ stall-sentinel hooks
    def _sync(self, op: str, timeout_s: Optional[float]) -> None:
        """Arrival registration (and the peer wait when a timeout is
        asked for); nothing for a group without a name."""
        if self.group_name is None:
            return
        self._step += 1
        step = self._step
        try:
            self.hooks.note_arrival(self.group_name, step, self.rank,
                                    self.world_size, op, time.time(),
                                    timeout_s)
        except Exception:   # telemetry never fails an op
            pass
        if timeout_s is None or self.world_size <= 1:
            return
        try:
            reply = self.hooks.await_peers(self.group_name, step, timeout_s,
                                           self.world_size)
        except CollectiveTimeoutError:
            raise
        except Exception:   # no store: the op itself still runs
            return
        if reply is not None and not reply.get("complete", True):
            raise CollectiveTimeoutError(
                op, reply.get("missing", []), timeout_s,
                detail=f"group {self.group_name} step {step}: "
                       f"{reply.get('arrived', 0)}/{self.world_size} "
                       f"ranks arrived")

    def _run(self, fn, x):
        with rank_region(self.mesh):
            return fn(x)

    def allreduce(self, x, op: str = "sum",
                  timeout_s: Optional[float] = None):
        self._sync(f"allreduce_{op}", timeout_s)
        return self._run(lambda s: allreduce(s, self.axis, op), x)

    def allgather(self, x, timeout_s: Optional[float] = None):
        self._sync("allgather", timeout_s)
        return self._run(lambda s: allgather(s, self.axis), x)

    def reducescatter(self, x, op: str = "sum",
                      timeout_s: Optional[float] = None):
        """Rank r contributes its (size * chunk, ...) rows and keeps the
        r-th chunk of their sum over the ranks."""
        self._sync(f"reducescatter_{op}", timeout_s)
        return self._run(lambda s: reducescatter(s, self.axis, op=op), x)

    def broadcast(self, x, root: int = 0,
                  timeout_s: Optional[float] = None):
        self._sync(f"broadcast_{root}", timeout_s)
        return self._run(lambda s: broadcast(s, self.axis, root=root), x)

    def shift(self, x, shift: int = 1,
              timeout_s: Optional[float] = None):
        self._sync(f"shift_{shift}", timeout_s)
        return self._run(lambda s: send(s, self.axis, shift=shift), x)

    def _device_sync(self, dev: torch.device):
        """One allreduce on ``dev`` and a wait for it: ``dev`` is resolved
        by the caller's thread, since a thread of its own starts on the
        first card, not on its rank's."""
        one = torch.zeros((1,), dtype=torch.float32, device=dev)
        self.allreduce(one)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def barrier(self, timeout_s: Optional[float] = None):
        """Synchronize the axis (and, for a named group, every
        participating rank). With ``timeout_s`` the wait is bounded: a
        barrier some participants never reach raises
        CollectiveTimeoutError, naming the missing ranks when the hooks
        supply them."""
        self._sync("barrier", timeout_s)
        dev = resolve_device(self.mesh.device_type)
        if timeout_s is None or self.group_name is not None:
            self._device_sync(dev)
            return
        # no context manager: its exit would wait for the very sync the
        # timeout bounds
        ex = concurrent.futures.ThreadPoolExecutor(1)
        fut = ex.submit(self._device_sync, dev)
        try:
            fut.result(timeout_s)
        except concurrent.futures.TimeoutError:
            raise CollectiveTimeoutError(
                "barrier", [], timeout_s,
                detail="local mesh sync did not complete") from None
        finally:
            ex.shutdown(wait=False)


def pgroup(mesh: DeviceMesh, axis: str, *, group_name: Optional[str] = None,
           rank: Optional[int] = None, world_size: Optional[int] = None,
           hooks: Optional[CollectiveHooks] = None) -> ProcessGroup:
    """The eager process group for a mesh axis."""
    return ProcessGroup(mesh, axis, group_name=group_name, rank=rank,
                        world_size=world_size, hooks=hooks)


def barrier(mesh: DeviceMesh, axis: Optional[str] = None,
            timeout_s: Optional[float] = None, *,
            group_name: Optional[str] = None, rank: Optional[int] = None,
            world_size: Optional[int] = None,
            hooks: Optional[CollectiveHooks] = None):
    """Barrier over ``axis`` (default: every axis of size > 1).
    ``timeout_s`` bounds the wait and raises CollectiveTimeoutError."""
    sizes = axis_sizes(mesh)
    axes = [axis] if axis else [a for a in mesh.mesh_dim_names
                                if sizes[a] > 1]
    if not axes and group_name is not None:
        # a one-device mesh in a multi-process group: the rendezvous is
        # the point, so still register and wait
        ProcessGroup(mesh, mesh.mesh_dim_names[0], group_name=group_name,
                     rank=rank, world_size=world_size,
                     hooks=hooks)._sync("barrier", timeout_s)
        return
    for a in axes:
        ProcessGroup(mesh, a, group_name=group_name, rank=rank,
                     world_size=world_size,
                     hooks=hooks).barrier(timeout_s=timeout_s)
