"""Logical-axis sharding rules (counterpart of
``ray_tpu/parallel/sharding.py``).

Models annotate arrays with logical axis names ("batch", "embed",
"heads", ...); a rules table maps them to mesh dims. The reference's
``NamedSharding`` is here a DTensor placement tuple, one placement per
mesh dim: ``Shard(i)`` where tensor dim ``i`` maps to that mesh dim,
``Replicate()`` elsewhere. Placements are over the mesh's dims larger
than 1 (``mesh.active_mesh``), where DTensors live: a dim of size 1
places nothing (the reference drops it from specs too). A dim mapped to
a tuple of mesh dims, such as batch to ("dp", "fsdp"), is sharded over
both, the first one outermost: DTensor splits over its mesh dims in
mesh order, which is the order of ``AXIS_ORDER`` and JAX's order for
the same tuple. The sharding
constraint is ``redistribute`` on a DTensor and a no-op on a plain
tensor (the reference's eager path is a no-op too).

Where an array is placed (``distribute_pytree``, the constraint), a dim
shards only over the leading axes of its part whose sizes divide it
(``fit_spec``): DTensor cannot flatten an unevenly sharded dim, which
the model's projections do, where GSPMD pads. A batch of 2 on dp=8 is
then replicated over dp. The values are the same either way.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from .mesh import active_mesh, axis_sizes

# (logical axis name, mesh axis or tuple of mesh axes or None)
LogicalAxisRules = Sequence[Tuple[str, Union[None, str, Tuple[str, ...]]]]

# batch over (dp, fsdp), params over fsdp (ZeRO-3 style) and tp, sequence
# over sp, experts over ep
DEFAULT_RULES: LogicalAxisRules = (
    ("batch", ("dp", "fsdp")),
    ("seq", "sp"),
    ("embed", "fsdp"),
    ("heads", "tp"),
    ("kv_heads", "tp"),
    ("head_dim", None),
    ("mlp", "tp"),
    ("vocab", "tp"),
    ("expert", "ep"),
    ("layers", None),
    ("stage", "pp"),
)

# one spec part a tensor dim: None, a mesh axis, or a tuple of mesh axes
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


def _spec_for(logical_axes: Sequence[Optional[str]],
              rules: LogicalAxisRules,
              mesh: Optional[DeviceMesh] = None) -> Spec:
    """The reference's ``PartitionSpec`` as a tuple: a mesh axis shards at
    most one dim of an array, axes of size 1 are dropped (with a mesh),
    trailing Nones are stripped."""
    table = dict(rules)
    sizes = axis_sizes(mesh) if mesh is not None else None
    used = set()
    parts = []
    for ax in logical_axes:
        mesh_ax = table.get(ax) if ax is not None else None
        if mesh_ax is not None:
            flat = (mesh_ax,) if isinstance(mesh_ax, str) else tuple(mesh_ax)
            flat = tuple(a for a in flat if a not in used)
            if sizes is not None:
                flat = tuple(a for a in flat if sizes.get(a, 1) > 1)
            used.update(flat)
            mesh_ax = flat[0] if len(flat) == 1 else (flat or None)
        parts.append(mesh_ax)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def fit_spec(spec: Spec, shape: Sequence[int], mesh: DeviceMesh) -> Spec:
    """``spec`` with each part cut to the leading axes whose sizes'
    product divides the dim."""
    sizes = axis_sizes(mesh)
    out = []
    for part, n in zip(tuple(spec) + (None,) * (len(shape) - len(spec)),
                       shape):
        keep, prod = [], 1
        for a in (() if part is None else
                  (part,) if isinstance(part, str) else part):
            if n % (prod * sizes.get(a, 1)):
                break
            keep.append(a)
            prod *= sizes.get(a, 1)
        out.append(None if not keep else keep[0] if len(keep) == 1
                   else tuple(keep))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def placements_for(shape: Sequence[int], logical_axes, mesh: DeviceMesh,
                   rules: LogicalAxisRules = DEFAULT_RULES
                   ) -> Tuple[Placement, ...]:
    """The placements an array of ``shape`` is put at: its logical axes'
    spec, fitted to the shape."""
    return spec_placements(mesh, fit_spec(
        _spec_for(logical_axes, rules, mesh), shape, mesh))


def spec_placements(mesh: DeviceMesh, spec: Spec) -> Tuple[Placement, ...]:
    """The placement tuple of a spec, one placement a dim of
    ``active_mesh(mesh)``; axes of size 1 in the spec place nothing. A
    dim over several mesh dims must name them in mesh order (DTensor
    nests them so)."""
    names = list(active_mesh(mesh).mesh_dim_names)
    sizes = axis_sizes(mesh)
    out = [Replicate() for _ in names]
    for i, part in enumerate(spec):
        if part is None:
            continue
        flat = (part,) if isinstance(part, str) else tuple(part)
        dims = [names.index(a) for a in flat if sizes[a] > 1]
        if dims != sorted(dims):
            raise ValueError(f"dim {i} is sharded over {flat}, which are not "
                             f"in the mesh's order {tuple(names)}")
        for d in dims:
            out[d] = Shard(i)
    return tuple(out)


def logical_sharding(mesh: DeviceMesh,
                     logical_axes: Sequence[Optional[str]],
                     rules: LogicalAxisRules = DEFAULT_RULES
                     ) -> Tuple[Placement, ...]:
    """The placements of an array whose dims carry the given logical axes."""
    return spec_placements(mesh, _spec_for(logical_axes, rules, mesh))


def _is_axes_leaf(x) -> bool:
    return x is None or isinstance(x, tuple)


def _map_axes(fn, axes_tree, *trees):
    if _is_axes_leaf(axes_tree):
        return fn(axes_tree, *trees)
    if isinstance(axes_tree, dict):
        return {k: _map_axes(fn, v, *[t[k] for t in trees])
                for k, v in axes_tree.items()}
    return type(axes_tree)(_map_axes(fn, v, *[t[i] for t in trees])
                           for i, v in enumerate(axes_tree))


def shard_pytree(tree, axes_tree, mesh: DeviceMesh,
                 rules: LogicalAxisRules = DEFAULT_RULES):
    """A tree of placement tuples matching ``axes_tree``, whose leaves are
    tuples of logical axis names (or None for replicated). ``tree`` is
    not read, as in the reference."""
    del tree

    def leaf(ax):
        return logical_sharding(mesh, () if ax is None else ax, rules)

    return _map_axes(leaf, axes_tree)


def distribute_pytree(tree, axes_tree, mesh: DeviceMesh,
                      rules: LogicalAxisRules = DEFAULT_RULES):
    """``tree``'s tensors as DTensors placed by ``shard_pytree`` (the
    reference's ``jax.device_put(tree, shardings)``). Every rank passes
    the same full tensors; each keeps its shard, moved to the mesh's
    device type."""
    on = active_mesh(mesh)
    return _map_axes(lambda ax, t: distribute_tensor(
        t.to(mesh.device_type), on,
        placements_for(t.shape, () if ax is None else ax, mesh, rules)),
        axes_tree, tree)


def distribute_batch(t, mesh: DeviceMesh,
                     rules: LogicalAxisRules = DEFAULT_RULES):
    """A batch leaf (B, S, ...) as a DTensor sharded by ("batch", "seq")
    (the reference's ``place_batch``); a DTensor or None as it is."""
    if t is None or isinstance(t, DTensor):
        return t
    return distribute_tensor(t, active_mesh(mesh), placements_for(
        t.shape, ("batch", "seq"), mesh, rules))


def with_sharding_constraint_logical(x, logical_axes, rules=DEFAULT_RULES,
                                     mesh: Optional[DeviceMesh] = None):
    """A DTensor redistributed to the placements of ``logical_axes``
    (fitted to its shape) on ``mesh``; a plain tensor unchanged."""
    if not isinstance(x, DTensor):
        return x
    placements = placements_for(x.shape, logical_axes, mesh, rules)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(active_mesh(mesh), placements)
