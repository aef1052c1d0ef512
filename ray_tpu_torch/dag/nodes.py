"""DAG IR (counterpart of ``ray_tpu/dag/nodes.py``). Nodes are built with
``actor(handle).method.bind(...)`` under an ``InputNode`` context and run
compiled (``dag/compiled.py``: standing channel-fed loops on the actors).

The reference binds a node through its own actor handle
(``handle.method.bind``); the port takes any handle, a ``ray_tpu`` actor,
a spawned process or a plain object, through :func:`actor`, and places
the loops through the compile's ``DagHooks``. Interpreted execution
(one ``ray_tpu`` task a node), ``ClassNode`` and ``FunctionNode`` are
host plane and not ported."""

from __future__ import annotations

import threading
from typing import Any, List


class DAGNode:
    """Base: something that produces a value per DAG execution."""

    # set by with_device_transport(): this node's output edge moves as
    # torch tensors over DeviceChannel (CUDA IPC) in compiled DAGs
    device_transport: bool = False

    def with_device_transport(self) -> "DAGNode":
        """Mark this node's output for device-to-device transport (ref:
        with_tensor_transport / TorchTensorType hints). Compiled DAGs then
        move this edge's torch tensors over ``experimental.DeviceChannel``
        (CUDA IPC for CUDA tensors, the host lane for CPU ones) instead of
        the shm lane. Requires exactly one remote consumer and no driver
        read of this node."""
        if isinstance(self, (AttributeNode, InputAttributeNode,
                             MultiOutputNode)):
            # the compiler checks the flag on the PRODUCER node; letting
            # a wrapper carry it would silently ride the shm lane
            raise TypeError(
                "with_device_transport() applies to the producing node "
                "— call it on the .bind(...) result before indexing/"
                "wrapping")
        if isinstance(self, InputNode):
            # the DRIVER writes the input edge; it feeds host values, so
            # a device channel there fails at the first execute()
            raise TypeError(
                "with_device_transport() cannot apply to the InputNode "
                "(the driver writes that edge with host values)")
        self.device_transport = True
        return self

    def experimental_compile(self, *, hooks=None, device=None,
                             buffer_size_bytes: int = 1 << 20,
                             max_inflight: int = 2):
        """A ``CompiledDAG`` whose loops run on the actors through
        ``hooks`` (a ``DagHooks``; default ``LOCAL``: each actor a plain
        object in this process, its loop on a thread). ``device`` is where
        every channel reader places tensors: the card by default,
        ``"cpu"`` when asked."""
        from .compiled import CompiledDAG

        return CompiledDAG(self, hooks=hooks, device=device,
                           buffer_size_bytes=buffer_size_bytes,
                           max_inflight=max_inflight)

    # composition sugar
    def __getitem__(self, key):
        return AttributeNode(self, key)


class InputNode(DAGNode):
    """The DAG's per-execution input. Use as a context manager:
    ``with InputNode() as inp: dag = actor(a).f.bind(inp)``"""

    _local = threading.local()

    def __enter__(self):
        stack = getattr(InputNode._local, "stack", None)
        if stack is None:
            stack = InputNode._local.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        InputNode._local.stack.pop()

    def __getitem__(self, key):
        return InputAttributeNode(self, key)


class InputAttributeNode(DAGNode):
    """inp[0] / inp["key"]: positional or keyword piece of the input."""

    def __init__(self, input_node: InputNode, key):
        self.input_node = input_node
        self.key = key


class AttributeNode(DAGNode):
    """node[key]: index into an upstream node's result."""

    def __init__(self, upstream: DAGNode, key):
        self.upstream = upstream
        self.key = key


class ClassMethodNode(DAGNode):
    """actor(handle).method.bind(*args)."""

    def __init__(self, handle, method_name: str, args: tuple,
                 kwargs: dict):
        self.handle = handle
        self.method_name = method_name
        self.args = args
        self.kwargs = kwargs


class _BindableMethod:
    def __init__(self, handle, name: str):
        self._handle = handle
        self._name = name

    def bind(self, *args, **kwargs) -> ClassMethodNode:
        return ClassMethodNode(self._handle, self._name, args, kwargs)


class _Binder:
    def __init__(self, handle):
        self._handle = handle

    def __getattr__(self, name: str) -> _BindableMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return _BindableMethod(self._handle, name)


def actor(handle) -> _Binder:
    """``actor(handle).method.bind(*args, **kwargs)`` builds the node that
    calls ``method`` on the actor behind ``handle`` (the reference's
    ``handle.method.bind``)."""
    return _Binder(handle)


class MultiOutputNode(DAGNode):
    """Bundle several leaves into one DAG output."""

    def __init__(self, outputs: List[DAGNode]):
        self.outputs = list(outputs)


class CollectiveNode(DAGNode):
    """One participant's output of a cross-actor collective. Built via
    ``collective.allreduce``."""

    def __init__(self, group: "_CollectiveGroup", index: int):
        self.group = group
        self.index = index


class _CollectiveGroup:
    def __init__(self, inputs: List[DAGNode], op: str):
        for n in inputs:
            if not isinstance(n, ClassMethodNode):
                raise TypeError(
                    "collective inputs must be actor-method nodes")
        self.inputs = inputs
        self.op = op
        self.nodes = [CollectiveNode(self, i) for i in range(len(inputs))]


class _AllReduce:
    def bind(self, inputs: List[DAGNode], op: str = "sum") -> List[Any]:
        """allreduce.bind([n1, n2, ...]) -> [r1, r2, ...] where every ri
        is the elementwise reduction of all inputs, living on ni's actor."""
        return _CollectiveGroup(inputs, op).nodes


class _Collective:
    allreduce = _AllReduce()


collective = _Collective()
