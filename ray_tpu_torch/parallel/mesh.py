"""Device meshes over ranks (counterpart of ``ray_tpu/parallel/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose dims are
named by ``AXIS_ORDER``: all six are always present, and a dim of size 1
is inert. The reference's devices are this port's ranks: one process
drives one card, and a mesh of n devices needs a process group of n
ranks. ``build_mesh`` in a process with no group and a one-device spec
initializes a world-1 group itself, over an in-process ``HashStore``
(NCCL on the card, gloo on the CPU), so one process needs no rendezvous,
as in the reference; a spec of more devices needs the caller's group
(``torch.distributed.init_process_group`` on every rank, for example
through ``train.worker_group.init_torch_distributed``).
"""

from __future__ import annotations

import dataclasses
import math
import socket
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .._private.device import DeviceLike, resolve_device

# Outermost (lowest bandwidth: across hosts) to innermost (highest
# traffic: tp's per-layer collectives), as in the reference.
AXIS_ORDER: Tuple[str, ...] = ("pp", "dp", "fsdp", "sp", "ep", "tp")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape over named parallelism axes. Any axis
    omitted (or sized 1) is inert. Example: ``MeshSpec(dp=2, fsdp=2,
    tp=2)`` on 8 ranks."""

    pp: int = 1
    dp: int = 1
    fsdp: int = 1
    sp: int = 1
    ep: int = 1
    tp: int = 1

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in AXIS_ORDER}

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes.values())

    def axis_names(self) -> Tuple[str, ...]:
        return AXIS_ORDER

    @staticmethod
    def for_devices(n: int, tp: int = 1, pp: int = 1, sp: int = 1,
                    ep: int = 1, dp: Optional[int] = None,
                    fsdp: Optional[int] = None) -> "MeshSpec":
        """Fill the unspecified device factor into fsdp and/or dp: with
        neither given, all of it goes to fsdp; with one given, the other
        takes the rest."""
        inner = tp * pp * sp * ep
        if n % inner != 0:
            raise ValueError(f"{n} devices not divisible by tp*pp*sp*ep={inner}")
        rest = n // inner
        if dp is None and fsdp is None:
            dp, fsdp = 1, rest
        elif fsdp is None:
            if rest % dp != 0:
                raise ValueError(f"residual {rest} not divisible by dp={dp}")
            fsdp = rest // dp
        elif dp is None:
            if rest % fsdp != 0:
                raise ValueError(f"residual {rest} not divisible by fsdp={fsdp}")
            dp = rest // fsdp
        elif dp * fsdp != rest:
            raise ValueError(f"dp*fsdp={dp * fsdp} != residual {rest}")
        return MeshSpec(pp=pp, dp=dp, fsdp=fsdp, sp=sp, ep=ep, tp=tp)


def axis_sizes(mesh: DeviceMesh) -> Dict[str, int]:
    """``{name: size}`` of a mesh's dims (the reference's ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_cache(mesh: DeviceMesh) -> dict:
    """What the port keeps for a mesh (its active sub-mesh, the groups of
    tuples of its axes), on the mesh object: every rank makes the same
    ones for the same mesh, and they go with it."""
    cache = getattr(mesh, "_ray_tpu_torch_cache", None)
    if cache is None:
        cache = mesh._ray_tpu_torch_cache = {}
    return cache


def active_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The sub-mesh of ``mesh``'s dims of size > 1 (its innermost dim when
    every dim is 1), on which DTensors live: a dim of size 1 places
    nothing, and DTensor's sharding propagation grows with every dim it
    weighs, size 1 or not."""
    cache = mesh_cache(mesh)
    if "active" not in cache:
        names = tuple(a for a, n in axis_sizes(mesh).items() if n > 1)
        names = names or mesh.mesh_dim_names[-1:]
        cache["active"] = (mesh if names == tuple(mesh.mesh_dim_names)
                           else mesh[names])
    return cache["active"]


def ensure_process_group(n_devices: int, device: torch.device) -> None:
    """A world-1 group for a one-device mesh in a process without one;
    a clear error for a multi-rank mesh without the caller's group."""
    if dist.is_initialized():
        return
    if n_devices != 1:
        raise RuntimeError(
            f"a mesh of {n_devices} devices needs a process group of as "
            "many ranks: call torch.distributed.init_process_group on every "
            "rank first (train.worker_group.init_torch_distributed)")
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def _ranks(devices: Optional[Sequence[int]]) -> list:
    if devices is not None:
        return sorted(int(r) for r in devices)
    return list(range(dist.get_world_size() if dist.is_initialized() else 1))


def slice_topology(devices: Optional[Sequence[int]] = None, *,
                   device: DeviceLike = None) -> Dict[str, object]:
    """Counts of ranks, slices (one: GPUs have no slice) and hosts of the
    given (default: all) ranks, and the platform ("gpu" or "cpu"). A GPU
    has no ICI coordinates, so ``ici_bbox`` is None. With a group of more
    than one rank, the host count is gathered from every rank: call it
    on all of them."""
    dev = resolve_device(device)
    ranks = _ranks(devices)
    if dist.is_initialized() and dist.get_world_size() > 1:
        names = [None] * dist.get_world_size()
        dist.all_gather_object(names, socket.gethostname())
        hosts = {names[r] for r in ranks}
    else:
        hosts = {socket.gethostname()}
    return {
        "n_devices": len(ranks),
        "n_slices": 1,
        "n_hosts": len(hosts),
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "ici_bbox": None,
    }


def build_mesh(spec: MeshSpec, devices: Optional[Sequence[int]] = None, *,
               device: DeviceLike = None) -> DeviceMesh:
    """A ``DeviceMesh`` for the spec over ``devices`` (ranks; default:
    every rank of the group), dims named and ordered by ``AXIS_ORDER``,
    ranks in increasing order. ``device`` picks the device type (default:
    the card; raises without one). Every rank of the group calls it, also
    one outside ``devices``: making a mesh makes process groups."""
    dev = resolve_device(device)
    n = len(devices) if devices is not None else None
    ensure_process_group(spec.size if n is None else n, dev)
    ranks = _ranks(devices)
    if spec.size != len(ranks):
        raise ValueError(
            f"MeshSpec wants {spec.size} devices ({spec.axis_sizes}) but "
            f"{len(ranks)} provided")
    shape = tuple(spec.axis_sizes[a] for a in AXIS_ORDER)
    return DeviceMesh(dev.type, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=AXIS_ORDER)


def local_mesh(*, device: DeviceLike = None, **axis_sizes: int) -> DeviceMesh:
    """A mesh over every rank of the group, e.g. ``local_mesh(tp=4)``."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return build_mesh(MeshSpec.for_devices(n, **axis_sizes), device=device)
