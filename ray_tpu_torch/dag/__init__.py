"""ray_tpu_torch.dag: the DAG IR and compiled graphs (counterpart of
``ray_tpu.dag``).

Build with ``actor(handle).method.bind(...)`` under an ``InputNode``
context; ``root.experimental_compile(hooks=..., device=...)`` returns a
CompiledDAG whose actors run standing channel-fed loops, placed through
``DagHooks`` (``LOCAL``: plain objects in this process, on threads).
``with_device_transport()`` edges move torch tensors over
``experimental.DeviceChannel`` (CUDA IPC on the card)."""

from .compiled import LOCAL, CompiledDAG, CompiledDAGRef, DagHooks
from .nodes import (
    AttributeNode,
    ClassMethodNode,
    CollectiveNode,
    DAGNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
    actor,
    collective,
)

__all__ = [
    "DAGNode", "InputNode", "InputAttributeNode", "AttributeNode",
    "ClassMethodNode", "MultiOutputNode", "CollectiveNode", "collective",
    "CompiledDAG", "CompiledDAGRef", "DagHooks", "LOCAL", "actor",
]
