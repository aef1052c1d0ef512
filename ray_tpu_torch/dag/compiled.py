"""Compiled DAG execution (counterpart of ``ray_tpu/dag/compiled.py``;
ref: python/ray/dag/compiled_dag_node.py CompiledDAG).

Compilation turns submission-per-task into a standing dataflow machine:
every actor that owns DAG nodes runs ONE long-lived loop that reads its
input channels, runs its methods back-to-back, and writes its output
channels, with no scheduler involved per execution. Channels are the
port's ``experimental.Channel`` (the shm slot, whose tensor lane moves a
torch tensor as one copy into the map and one out) and, on
``with_device_transport()`` edges, ``experimental.DeviceChannel`` (CUDA
IPC for CUDA tensors, the host lane for CPU ones). Every reader places
tensors on the compile's ``device``: the card by default, the CPU when
asked.

Where the loops run is the caller's, through :class:`DagHooks`:

  * ``actor_key(handle) -> str`` names the actor (one loop per key);
  * ``run(handle, fn, *args) -> ref`` starts ``fn(instance, *args)`` on
    the actor behind ``handle``;
  * ``get(ref, timeout=seconds)`` returns its value, or raises its error.

The default, :data:`LOCAL`, takes plain objects in this process as the
actors and runs each call on a thread. ``ray_tpu``'s actors fill the
hooks in the caller (never in the port, which imports nothing of
``ray_tpu``)::

    import cloudpickle, ray_tpu
    from ray_tpu.actor import ActorMethod
    hooks = DagHooks(
        actor_key=lambda h: h.actor_id.hex(),
        run=lambda h, fn, *a: ActorMethod(h, "_rtpu_dyn_call").remote(
            cloudpickle.dumps(fn), *a),
        get=ray_tpu.get)

Each loop opens its actor's channel ends when it starts, as the
reference's does. A ``with_device_transport()`` edge crosses between
processes: under hooks whose ``run`` is LOCAL's (every actor in this
process, where a CUDA IPC handle cannot be opened) it raises at compile
time unless the compile is for the CPU.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from .._private.device import checked_device
from ..experimental.channel import Channel, ChannelClosed, ChannelTimeout
from ..experimental.device_channel import DeviceChannel
from .nodes import (
    AttributeNode,
    ClassMethodNode,
    CollectiveNode,
    DAGNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
)

# bound of teardown's drain of the outputs and wait for the loops' ends (a
# loop's own error reaches the driver through its channels, so teardown
# does not wait past this)
JOIN_TIMEOUT_S = 30.0


# --- the default hooks: actors in this process, calls on threads ---------


class _LocalRef:
    """A call running on its own thread: its value, or its exception."""

    def __init__(self, fn, args):
        self.value, self.error = None, None
        self.thread = threading.Thread(target=self._run, args=(fn, args),
                                       daemon=True, name="dag_local_call")
        self.thread.start()

    def _run(self, fn, args):
        try:
            self.value = fn(*args)
        except Exception as e:  # handed to the caller by get()
            self.error = e


def _local_key(handle) -> str:
    return f"local:{id(handle):x}"


def _local_run(handle, fn, *args) -> _LocalRef:
    return _LocalRef(fn, (handle, *args))


def _local_get(ref: _LocalRef, timeout: Optional[float] = None):
    ref.thread.join(timeout)
    if ref.thread.is_alive():
        raise TimeoutError(f"a local DAG call is still running after "
                           f"{timeout} s")
    if ref.error is not None:
        raise ref.error
    return ref.value


@dataclass(frozen=True)
class DagHooks:
    """Where a compiled DAG's loops run (see the module docstring). The
    defaults run them on threads of this process."""

    actor_key: Callable[[Any], str] = _local_key
    run: Callable[..., Any] = _local_run
    get: Callable[..., Any] = _local_get


LOCAL = DagHooks()


# --- on the actor ---------------------------------------------------------

def _dag_exec_loop(actor_self, spec: dict):
    """Runs ON the actor: the standing execution loop of this actor's DAG
    partition, readers on the compile's device (ref:
    compiled_dag_node.py _execute_until / do_exec_tasks)."""
    device_paths = set(spec["device_paths"])
    readers: Dict[str, Any] = {}
    writers: Dict[str, Any] = {}

    def _open(path: str):
        return (DeviceChannel(path, device=spec["device"])
                if path in device_paths
                else Channel(path, device=spec["device"]))

    def shutdown():
        for ch in writers.values():
            try:
                ch.close_write()
            except (ChannelTimeout, RuntimeError, ValueError, OSError):
                pass  # peer already gone / mapping torn down

    try:
        for path in spec["read_paths"]:
            readers[path] = _open(path)
        for path in spec["write_paths"]:
            writers[path] = _open(path)
        while True:
            results: Dict[int, Any] = {}
            chan_cache: Dict[str, Any] = {}

            def fetch(path: str, slot: int):
                if path not in chan_cache:
                    chan_cache[path] = readers[path].read(slot)
                return chan_cache[path]

            def resolve(argspec):
                kind = argspec[0]
                if kind == "const":
                    return argspec[1]
                if kind == "local":
                    return results[argspec[1]]
                if kind == "local_attr":
                    return _apply_keys(results[argspec[1]], argspec[2])
                if kind == "chan":
                    _, path, slot, keys = argspec
                    value = fetch(path, slot)
                    if isinstance(value, _WrappedError):
                        # an upstream actor failed: forward the error
                        raise _Propagated(value)
                    return _apply_keys(value, keys)
                raise ValueError(argspec)

            try:
                for step in spec["steps"]:
                    if step["kind"] == "call":
                        args = [resolve(a) for a in step["args"]]
                        kwargs = {k: resolve(v)
                                  for k, v in step["kwargs"].items()}
                        value = getattr(actor_self, step["method"])(
                            *args, **kwargs)
                    elif step["kind"] == "collective_root":
                        # torch tensors cross the contribution channels on
                        # the shm tensor lane (a copy out, a copy in)
                        value = results[step["src"]]
                        for path in step["contrib_paths"]:
                            value = value + fetch(path, 0)
                        if step["bcast_path"]:
                            writers[step["bcast_path"]].write(value)
                    elif step["kind"] == "collective_leaf":
                        writers[step["contrib_path"]].write(
                            results[step["src"]])
                        value = fetch(step["bcast_path"], step["bcast_slot"])
                    else:
                        raise ValueError(step["kind"])
                    results[step["node_id"]] = value
                    if step.get("out_path"):
                        writers[step["out_path"]].write(value)
            except ChannelClosed:
                shutdown()
                return True
            except BaseException as e:
                # surface through EVERY out channel, so the error travels
                # the dataflow graph hop by hop until the driver's result
                # read raises it (mid-chain failures included); on a
                # device edge it rides DeviceChannel's inline control lane
                err = e.err if isinstance(e, _Propagated) else \
                    _WrappedError(repr(e))
                for path in spec["write_paths"]:
                    try:
                        writers[path].write(err, timeout=5.0)
                    except (ChannelTimeout, RuntimeError, TypeError,
                            ValueError, OSError):
                        pass  # dead consumer: it can't observe the error
                shutdown()
                if isinstance(e, _Propagated):
                    return False  # upstream already raised the original
                raise
    finally:
        for ch in list(readers.values()) + list(writers.values()):
            ch.close()


def _apply_keys(value, keys):
    """Apply a chain of index keys (node["a"]["b"] nests) to a node
    result / DAG input. A mixed positional+keyword input rides the
    channel as {"*args": args, **kwargs}, so integer keys index the tuple
    inside."""
    for key in keys or ():
        if (isinstance(key, int) and isinstance(value, dict)
                and "*args" in value):
            value = value["*args"][key]
        else:
            value = value[key]
    return value


class _WrappedError:
    def __init__(self, msg: str):
        self.msg = msg


class _Propagated(Exception):
    """Wrapper for an upstream _WrappedError read off a channel."""

    def __init__(self, err: _WrappedError):
        super().__init__(err.msg)
        self.err = err


# --- on the driver --------------------------------------------------------


class CompiledDAGRef:
    """Result handle of one compiled execution (ref: compiled_dag_ref.py).
    ``get`` reads the DAG's output channel(s); results arrive in
    execution order."""

    def __init__(self, dag: "CompiledDAG", index: int):
        self._dag = dag
        self._index = index
        self._value = None
        self._fetched = False

    def get(self, timeout: Optional[float] = 60.0):
        if not self._fetched:
            self._dag._fetch_until(self._index, timeout)
        return self._value

    def __repr__(self):
        return f"CompiledDAGRef(exec={self._index})"


class CompiledDAG:
    def __init__(self, root: DAGNode, *, hooks: Optional[DagHooks] = None,
                 device=None, buffer_size_bytes: int = 1 << 20,
                 max_inflight: int = 2):
        # the readers resolve ``device`` in their own processes; a compile
        # for the card (the default) raises here when there is none
        self._on_cpu = checked_device(device).type == "cpu"
        self.hooks = hooks or LOCAL
        self.device = device
        self.buffer_size = buffer_size_bytes
        self.max_inflight = max_inflight
        self._lock = threading.Lock()
        self._exec_count = 0
        self._next_fetch = 0
        self._row_vals: List[Any] = []
        self._pending: Dict[int, CompiledDAGRef] = {}
        self._torn_down = False
        # defaults BEFORE _build so a mid-build validation error leaves
        # teardown()-able state (channels allocate in topo order — the
        # ones created before the raise must not leak their shm files)
        self._channels: List[Any] = []
        self._device_paths: set = set()
        self._input_channel = None
        self._outputs: List[Tuple[Any, int, Any]] = []
        self._loop_refs: List[Any] = []
        try:
            self._build(root)
        except BaseException:
            for ch in self._channels:
                try:
                    ch.close()
                except (RuntimeError, ValueError, OSError):
                    pass
                try:  # unlink even when close() raised — the shm file
                    ch.unlink()  # is what must not leak
                except OSError:
                    pass
            self._torn_down = True
            raise

    # --- compilation ---

    def _build(self, root: DAGNode) -> None:
        outputs = (root.outputs if isinstance(root, MultiOutputNode)
                   else [root])
        self._multi = isinstance(root, MultiOutputNode)

        # topological node list (post-order DFS)
        order: List[DAGNode] = []
        seen: Dict[int, int] = {}

        def visit(node: DAGNode):
            if id(node) in seen:
                return
            seen[id(node)] = 1
            for dep in _deps(node):
                visit(dep)
            order.append(node)

        for out in outputs:
            visit(out)

        self._input_node = next(
            (n for n in order if isinstance(n, InputNode)), None)
        if self._input_node is None:
            # without an input channel the actor loops would free-run,
            # producing results decoupled from execute() calls
            raise ValueError(
                "experimental_compile requires the DAG to read from an "
                "InputNode (build it under `with InputNode() as inp:`)")
        node_ids = {id(n): i for i, n in enumerate(order)}
        actor_of: Dict[int, Any] = {}
        for n in order:
            if isinstance(n, ClassMethodNode):
                actor_of[node_ids[id(n)]] = n.handle
            elif isinstance(n, CollectiveNode):
                actor_of[node_ids[id(n)]] = n.group.inputs[n.index].handle

        actor_key = self.hooks.actor_key

        # consumers per producer node: which OTHER actors read it + driver
        remote_consumers: Dict[int, List[str]] = {}
        driver_reads: Dict[int, bool] = {}

        def unwrap(node: DAGNode):
            """Peel (possibly nested) attribute access down to the real
            producer; returns (producer, key_chain)."""
            keys: List[Any] = []
            while True:
                if isinstance(node, InputAttributeNode):
                    keys.append(node.key)
                    node = node.input_node
                elif isinstance(node, AttributeNode):
                    keys.append(node.key)
                    node = node.upstream
                else:
                    return node, tuple(reversed(keys))

        def note_consumer(producer: DAGNode, consumer_actor: Optional[str]):
            producer, _ = unwrap(producer)
            pid = node_ids[id(producer)]
            p_actor = (None if isinstance(producer, InputNode)
                       else actor_key(actor_of[pid]))
            if consumer_actor is not None and consumer_actor == p_actor:
                return  # same actor: local variable, no channel
            if consumer_actor is None:
                driver_reads[pid] = True
            else:
                remote_consumers.setdefault(pid, [])
                if consumer_actor not in remote_consumers[pid]:
                    remote_consumers[pid].append(consumer_actor)

        for n in order:
            if isinstance(n, ClassMethodNode):
                me = actor_key(n.handle)
                for a in list(n.args) + list(n.kwargs.values()):
                    if isinstance(a, DAGNode):
                        note_consumer(a, me)
        for out in outputs:
            note_consumer(out, None)

        # channels: one per produced value that crosses a process boundary
        chan_of: Dict[int, Any] = {}
        slot_of: Dict[Tuple[int, str], int] = {}
        for n in order:
            pid = node_ids[id(n)]
            consumers = remote_consumers.get(pid, [])
            n_readers = len(consumers) + (1 if driver_reads.get(pid) else 0)
            if n_readers == 0:
                continue
            if not isinstance(n, (InputNode, ClassMethodNode,
                                  CollectiveNode)):
                continue
            if getattr(n, "device_transport", False):
                # with_device_transport(): this edge's torch tensors move
                # over DeviceChannel (CUDA IPC on the card)
                if driver_reads.get(pid) or len(consumers) != 1:
                    raise ValueError(
                        "with_device_transport() edges need exactly one "
                        "remote consumer and no driver read (DeviceChannel "
                        "is 1:1; route driver-bound values over the "
                        "default shm lane)")
                if self.hooks.run is _local_run and not self._on_cpu:
                    raise ValueError(
                        "with_device_transport() edges cross between "
                        "processes over CUDA IPC, and these hooks run every "
                        "actor in this process, which cannot open its own "
                        "IPC handles: place the actors in processes of "
                        "their own, or compile with device='cpu'")
                ch = DeviceChannel(capacity=self.buffer_size,
                                   device=self.device)
                self._device_paths.add(ch.path)
            else:
                ch = Channel(num_readers=n_readers,
                             capacity=self.buffer_size, device=self.device)
            self._channels.append(ch)
            chan_of[pid] = ch
            for slot, actor in enumerate(consumers):
                slot_of[(pid, actor)] = slot
            if driver_reads.get(pid):
                slot_of[(pid, "__driver__")] = len(consumers)

        # collective plumbing
        coll_channels: Dict[int, Dict[str, Any]] = {}
        groups = {}
        for n in order:
            if isinstance(n, CollectiveNode) and id(n.group) not in groups:
                groups[id(n.group)] = n.group
        for group in groups.values():
            handles = [inp.handle for inp in group.inputs]
            contribs = [Channel(num_readers=1, capacity=self.buffer_size,
                                device=self.device)
                        for _ in handles[1:]]
            # single-participant allreduce is the identity: no broadcast
            # channel (a reader-less channel would block on execution 2)
            bcast = (Channel(num_readers=len(handles) - 1,
                             capacity=self.buffer_size, device=self.device)
                     if len(handles) > 1 else None)
            self._channels.extend(contribs + ([bcast] if bcast else []))
            coll_channels[id(group)] = {
                "contribs": contribs, "bcast": bcast}

        # per-actor step specs
        specs: Dict[str, Dict[str, Any]] = {}

        def spec_for(handle) -> Dict[str, Any]:
            key = actor_key(handle)
            if key not in specs:
                specs[key] = {"handle": handle, "steps": [],
                              "read_paths": set(), "write_paths": set()}
            return specs[key]

        def argspec(a, me: str):
            if not isinstance(a, DAGNode):
                return ("const", a)
            producer, keys = unwrap(a)
            pid = node_ids[id(producer)]
            p_actor = (None if isinstance(producer, InputNode)
                       else actor_key(actor_of[pid]))
            if p_actor == me:
                if not keys:
                    return ("local", pid)
                return ("local_attr", pid, keys)
            ch = chan_of[pid]
            slot = slot_of[(pid, me)]
            return ("chan", ch.path, slot, keys)

        for n in order:
            pid = node_ids[id(n)]
            if isinstance(n, ClassMethodNode):
                me = actor_key(n.handle)
                spec = spec_for(n.handle)
                out_ch = chan_of.get(pid)
                step = {
                    "kind": "call", "node_id": pid,
                    "method": n.method_name,
                    "args": [argspec(a, me) for a in n.args],
                    "kwargs": {k: argspec(v, me)
                               for k, v in n.kwargs.items()},
                    "out_path": out_ch.path if out_ch else None,
                }
                spec["steps"].append(step)
            elif isinstance(n, CollectiveNode):
                group = n.group
                plumb = coll_channels[id(group)]
                handle = group.inputs[n.index].handle
                spec = spec_for(handle)
                src = node_ids[id(group.inputs[n.index])]
                out_ch = chan_of.get(pid)
                if n.index == 0:
                    step = {
                        "kind": "collective_root", "node_id": pid,
                        "src": src,
                        "contrib_paths": [c.path
                                          for c in plumb["contribs"]],
                        "bcast_path": (plumb["bcast"].path
                                       if plumb["bcast"] else None),
                        "out_path": out_ch.path if out_ch else None,
                    }
                else:
                    step = {
                        "kind": "collective_leaf", "node_id": pid,
                        "src": src,
                        "contrib_path": plumb["contribs"][n.index - 1].path,
                        "bcast_path": plumb["bcast"].path,
                        "bcast_slot": n.index - 1,
                        "out_path": out_ch.path if out_ch else None,
                    }
                spec["steps"].append(step)

        # read/write path sets per spec
        for spec in specs.values():
            for step in spec["steps"]:
                if step.get("out_path"):
                    spec["write_paths"].add(step["out_path"])
                if step["kind"] == "call":
                    for a in (list(step["args"])
                              + list(step["kwargs"].values())):
                        if a[0] == "chan":
                            spec["read_paths"].add(a[1])
                elif step["kind"] == "collective_root":
                    spec["read_paths"].update(step["contrib_paths"])
                    if step["bcast_path"]:
                        spec["write_paths"].add(step["bcast_path"])
                elif step["kind"] == "collective_leaf":
                    spec["write_paths"].add(step["contrib_path"])
                    spec["read_paths"].add(step["bcast_path"])

        # driver-side output bindings
        for out in outputs:
            producer, keys = unwrap(out)
            pid = node_ids[id(producer)]
            ch = chan_of[pid]
            self._outputs.append((ch, slot_of[(pid, "__driver__")], keys))

        # driver-side input binding
        self._input_channel = chan_of.get(node_ids[id(self._input_node)])

        self._launch(specs)

    def _launch(self, specs: Dict[str, Dict[str, Any]]) -> None:
        """Start every actor's loop (fire-and-forget)."""
        for spec in specs.values():
            handle = spec.pop("handle")
            payload = dict(spec)
            payload["read_paths"] = sorted(payload["read_paths"])
            payload["write_paths"] = sorted(payload["write_paths"])
            payload["device_paths"] = sorted(self._device_paths)
            payload["device"] = self.device
            self._loop_refs.append(
                self.hooks.run(handle, _dag_exec_loop, payload))

    # --- execution ---

    def execute(self, *args, **kwargs) -> CompiledDAGRef:
        with self._lock:
            if self._torn_down:
                raise RuntimeError("CompiledDAG was torn down")
            if (self._exec_count - self._next_fetch) >= self.max_inflight:
                raise RuntimeError(
                    f"too many in-flight executions "
                    f"(max_inflight={self.max_inflight}); get() pending "
                    f"results first")
            if self._input_channel is not None:
                if kwargs or len(args) != 1:
                    value = ({"*args": args, **kwargs} if kwargs
                             else args)
                else:
                    value = args[0]
                self._input_channel.write(value, timeout=60.0)
            ref = CompiledDAGRef(self, self._exec_count)
            self._pending[self._exec_count] = ref
            self._exec_count += 1
            return ref

    def _fetch_until(self, index: int, timeout: Optional[float]) -> None:
        with self._lock:
            while self._next_fetch <= index:
                # resume a partially-read output row (a ChannelTimeout
                # mid-row must not desync channels whose cursor already
                # advanced), hence the persistent _row_vals cursor
                while len(self._row_vals) < len(self._outputs):
                    ch, slot, keys = self._outputs[len(self._row_vals)]
                    try:
                        v = ch.read(slot, timeout=timeout)
                    except ChannelClosed:
                        self.teardown()
                        raise RuntimeError(
                            "compiled DAG channels closed unexpectedly "
                            "(an actor loop exited)") from None
                    if isinstance(v, _WrappedError):
                        self.teardown()
                        raise RuntimeError(
                            f"compiled DAG task failed: {v.msg}")
                    self._row_vals.append(_apply_keys(v, keys))
                vals, self._row_vals = self._row_vals, []
                ref = self._pending.pop(self._next_fetch)
                ref._value = vals if self._multi else vals[0]
                ref._fetched = True
                self._next_fetch += 1

    # --- lifecycle ---

    def teardown(self) -> None:
        """Stop the loops (the input's STOP reaches every loop hop by
        hop), drain what they still write until their STOP reaches the
        driver, wait for each loop to end, and close and unlink every
        channel file."""
        if self._torn_down:
            return
        self._torn_down = True
        if self._input_channel is not None:
            try:
                self._input_channel.close_write()
            except (ChannelTimeout, RuntimeError, ValueError, OSError):
                pass  # loops already gone; draining below still runs
        # drain leftover outputs so mid-pipeline writers unblock, until
        # each output's writer has closed it
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        for ch, slot in {(ch, slot): None for ch, slot, _ in self._outputs}:
            while time.monotonic() < deadline:
                try:
                    ch.read(slot, timeout=0.2)
                except ChannelTimeout:
                    continue
                except ChannelClosed:
                    break
                except (RuntimeError, ValueError, OSError,
                        EOFError, AttributeError):
                    break  # torn-down mapping or a half-written payload
        for ref in self._loop_refs:
            try:
                self.hooks.get(ref, timeout=max(
                    deadline - time.monotonic(), 1.0))
            except Exception:
                pass  # a loop's own error reached the driver as a result
        for ch in self._channels:
            ch.close()
            ch.unlink()

    def __del__(self):
        try:
            self.teardown()
        except Exception:
            pass


def _deps(node: DAGNode) -> List[DAGNode]:
    if isinstance(node, ClassMethodNode):
        return [a for a in list(node.args) + list(node.kwargs.values())
                if isinstance(a, DAGNode)]
    if isinstance(node, (InputAttributeNode,)):
        return [node.input_node]
    if isinstance(node, AttributeNode):
        return [node.upstream]
    if isinstance(node, CollectiveNode):
        return list(node.group.inputs)
    if isinstance(node, MultiOutputNode):
        return list(node.outputs)
    return []
