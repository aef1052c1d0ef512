"""ray_tpu_torch.parallel: the multi-device plane on ``torch.distributed``
(counterpart of ``ray_tpu/parallel``).

Meshes are ``DeviceMesh``es over ranks, named shardings are DTensor
placements chosen by logical-axis rules, and the collectives run over
the mesh's process groups (NCCL on the card, gloo on the CPU), inside a
per-rank region (``collectives.shard_map``) or eagerly
(``pgroup``). The pipeline and two-level collectives are built on them.
"""

from .collectives import (
    allgather,
    allreduce,
    alltoall,
    barrier,
    broadcast,
    pgroup,
    recv,
    reducescatter,
    send,
)
from .mesh import MeshSpec, build_mesh, local_mesh, slice_topology
from .multislice import (DCN_AXIS, MULTISLICE_RULES, build_multislice_mesh,
                         group_devices_by_slice, multislice_rules,
                         two_level_pmean, two_level_psum)
from .pipeline import pipeline_apply, split_stages
from .sharding import (
    DEFAULT_RULES,
    LogicalAxisRules,
    logical_sharding,
    shard_pytree,
    with_sharding_constraint_logical,
)

__all__ = [
    "DCN_AXIS", "MULTISLICE_RULES", "build_multislice_mesh",
    "group_devices_by_slice", "multislice_rules", "two_level_pmean",
    "two_level_psum",
    "pipeline_apply", "split_stages",
    "MeshSpec", "build_mesh", "local_mesh", "slice_topology",
    "LogicalAxisRules", "DEFAULT_RULES", "logical_sharding", "shard_pytree",
    "with_sharding_constraint_logical",
    "allreduce", "allgather", "reducescatter", "broadcast", "alltoall",
    "send", "recv", "barrier", "pgroup",
]
