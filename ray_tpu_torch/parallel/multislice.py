"""Multi-slice execution: two-level collectives and slice-per-stage
pipelining (counterpart of ``ray_tpu/parallel/multislice.py``).

The cross-slice boundary is a leading mesh dim named ``dcn``; batch
shards over ("dcn", "dp", "fsdp") in ``MULTISLICE_RULES``, so only the
cross-slice gradient mean crosses it, and ``two_level_psum`` reduces
within a slice before it reduces across. A GPU has no slices: ranks form
one group unless ``n_slices`` asks for chunks of the rank list (as the
reference emulates slices on CPU devices), and a node's ranks are the
natural slice when a caller passes them so.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .._private.device import DeviceLike, resolve_device
from .collectives import allreduce
from .mesh import ensure_process_group
from .sharding import DEFAULT_RULES, LogicalAxisRules

DCN_AXIS = "dcn"


def group_devices_by_slice(devices: Optional[Sequence[int]] = None
                           ) -> List[List[int]]:
    """Ranks grouped by slice: one group on GPUs (no slice index), in
    rank order."""
    if devices is None:
        devices = range(dist.get_world_size() if dist.is_initialized()
                        else 1)
    return [sorted(int(r) for r in devices)]


def build_multislice_mesh(axes: Dict[str, int],
                          n_slices: Optional[int] = None,
                          devices: Optional[Sequence[int]] = None,
                          dcn_axis_name: str = DCN_AXIS, *,
                          device: DeviceLike = None) -> DeviceMesh:
    """A mesh with a leading cross-slice dim (``dcn`` by default) and the
    intra-slice ``axes`` (their product the ranks of a slice).
    ``n_slices`` chunks the rank list into that many slices;
    ``dcn_axis_name="pp"`` gives the slice-per-stage pipeline layout."""
    dev = resolve_device(device)
    need = (n_slices or 1) * math.prod(max(1, int(v)) for v in axes.values())
    ensure_process_group(need if devices is None else len(devices), dev)
    devices = sorted(int(r) for r in (
        devices if devices is not None else range(dist.get_world_size())))
    if n_slices is None:
        groups = group_devices_by_slice(devices)
    else:
        per = len(devices) // n_slices
        assert per * n_slices == len(devices), (
            f"{len(devices)} devices do not split into {n_slices} slices")
        groups = [devices[i * per:(i + 1) * per] for i in range(n_slices)]
    per_slice = len(groups[0])
    sizes = [max(1, int(v)) for v in axes.values()]
    assert math.prod(sizes) == per_slice, (
        f"intra-slice axes {axes} do not fill a {per_slice}-device slice")
    ranks = torch.tensor([r for g in groups for r in g]).reshape(
        len(groups), *sizes)
    return DeviceMesh(dev.type, ranks,
                      mesh_dim_names=(dcn_axis_name, *axes.keys()))


def multislice_rules(base: LogicalAxisRules = DEFAULT_RULES
                     ) -> LogicalAxisRules:
    """The rules for a dcn-leading mesh: batch gains the cross-slice
    axis; the other logical axes stay within a slice."""
    out = []
    for name, axes in base:
        if name == "batch":
            flat = (axes,) if isinstance(axes, str) else tuple(axes or ())
            out.append((name, (DCN_AXIS, *flat)))
        else:
            out.append((name, axes))
    return tuple(out)


MULTISLICE_RULES = multislice_rules()


def two_level_psum(x, intra_axis, dcn_axis: str = DCN_AXIS):
    """Hierarchical all-reduce inside a per-rank region: over the slice's
    axis first, then the per-slice partials over ``dcn``."""
    return allreduce(allreduce(x, intra_axis), dcn_axis)


def two_level_pmean(x, intra_axis, dcn_axis: str = DCN_AXIS):
    return allreduce(allreduce(x, intra_axis, "mean"), dcn_axis, "mean")
