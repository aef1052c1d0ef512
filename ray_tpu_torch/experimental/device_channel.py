"""Tensor channel between two processes (counterpart of
``ray_tpu/experimental/device_channel.py``).

The reference pulls device arrays through the PJRT transfer fabric. On
one card the port moves CUDA tensors over CUDA IPC instead, through
PyTorch's own sharing of caching-allocator blocks
(``torch.multiprocessing.reductions``): the writer copies the payload's
tensors into one staged block and publishes the block's IPC handle on a
small shm control channel; the reader maps the block, copies it into
memory of its own and lets go of the mapping. CPU tensors take the host
lane, the TCP transfer shim, and the reader places them on its device.

    ch = DeviceChannel()                    # writer side
    ch.write({"k": k, "v": v})              # a tree of torch tensors
    ...
    ch = DeviceChannel(path, device="cuda") # reader side (same path)
    out = ch.read()                         # the same tree, reader-owned

Single-writer, single-reader. The control channel provides ordering and
backpressure (one payload in flight until the reader takes it).

What the port adds, because torch tensors are mutable where jax arrays
are not:
- ``write`` snapshots its tensors before it returns, so the caller may
  reuse them at once; ``read`` returns tensors the reader owns.
- A staged block is freed only after the reader's copy of it has
  completed: the reader's mapping holds PyTorch's IPC reference count on
  it, and the reader synchronizes its stream before it lets the mapping
  go. The writer frees released blocks (``torch.cuda.ipc_collect``) at
  each write and when it closes the channel.
- An IPC handle cannot be opened by the process that made it. A reader in
  the writer's process takes the staged block from this process's table
  of staged payloads and copies it directly. The writer keeps its blocks
  there only while another end is open on the channel's path in its own
  process, so such a reader is opened before the write.
- CUDA IPC needs processes started with ``spawn`` (a process forked
  after CUDA is initialized cannot use the card).

Counters, per process, as the kernel wrappers count launches:
``DeviceChannel.ipc_transfers`` counts payloads staged for IPC (writer)
and copied out of a mapped block (reader); ``DeviceChannel.host_lane_bytes``
counts tensor bytes registered on or pulled from the host lane. A CUDA
payload never takes the host lane: what cannot take IPC raises.
"""

from __future__ import annotations

import os
import secrets
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._private.device import DeviceLike, resolve_device
from .._private.tree import tree_leaves, tree_map
from ._transfer_shim import ShimConnection, ShimTransferServer
from .channel import DEFAULT_CAPACITY, TORCH_DTYPES, Channel, dtype_name

_server_lock = threading.RLock()
_server = None
_connections: Dict[str, Any] = {}
# this process's staged CUDA payloads by uid, (block, event after its
# copies), kept only for a reader in the same process
_staged: Dict[int, Tuple[torch.Tensor, Any]] = {}
# open DeviceChannel ends in this process, by path
_open: Dict[str, int] = {}

_ALIGN = 256   # byte alignment of each leaf inside a staged block


def _transfer_server():
    """One host-lane server per process (lazy), on the loopback: the
    channel's two ends share the one card's host."""
    global _server
    with _server_lock:
        if _server is None:
            _server = ShimTransferServer("127.0.0.1:0")
        return _server


def _connection(address: str):
    with _server_lock:
        conn = _connections.get(address)
        if conn is None:
            conn = _connections[address] = ShimConnection(address)
        return conn


def _flatten(tree) -> Tuple[List[Any], Any]:
    """Leaves in the port's tree order (dict keys sorted, lists in order)
    and a picklable skeleton with each leaf replaced by None."""
    return tree_leaves(tree), tree_map(lambda _: None, tree)


def _unflatten(skeleton, leaves: List[Any]):
    """The inverse of :func:`_flatten`: leaves in tree_leaves' order."""
    return _fill(skeleton, iter(leaves))


def _fill(node, it):
    # a module function, not a closure that calls itself: such a closure
    # is a reference cycle, which would keep every payload read alive
    # until the cyclic collector runs
    if isinstance(node, dict):
        return {k: _fill(node[k], it) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return type(node)(_fill(v, it) for v in node)
    return next(it)


def _specs(flat: List[torch.Tensor]):
    return [(tuple(a.shape), dtype_name(a.dtype)) for a in flat]


def _layout(flat: List[torch.Tensor]) -> Tuple[List[int], int]:
    """Byte offset of each leaf in a staged block, and the block's size."""
    offsets, size = [], 0
    for t in flat:
        offsets.append(size)
        size += -(-t.nbytes // _ALIGN) * _ALIGN
    return offsets, size


def _leaf_view(block: torch.Tensor, off: int, shape, dtype: torch.dtype):
    n = dtype.itemsize
    for d in shape:
        n *= d
    return block[off:off + n].view(dtype).reshape(shape)


class DeviceChannel:
    """One writer, one reader; payloads are trees (dicts, lists, tuples)
    of torch tensors, all on the card or all on the CPU. ``device`` is
    where the reader places what it reads (default: the card); making a
    channel needs no card."""

    ipc_transfers = 0
    host_lane_bytes = 0

    def __init__(self, path: Optional[str] = None, *,
                 capacity: int = DEFAULT_CAPACITY, create: bool = False,
                 device: DeviceLike = None):
        # control lane: uid/handle/spec metadata (small), plus the
        # channel's ordering and backpressure
        self._control = Channel(path, num_readers=1, capacity=capacity,
                                create=create or path is None)
        self.path = self._control.path
        self.device = device
        self._uids: List[int] = []   # this writer's uids in _staged
        self._shared = False         # this end has staged an IPC payload
        with _server_lock:
            _open[self.path] = _open.get(self.path, 0) + 1
        self._registered = True

    # --- writer ---

    def write(self, tree: Any, timeout: Optional[float] = None) -> None:
        flat, skeleton = _flatten(tree)
        if not flat or not all(isinstance(a, torch.Tensor) for a in flat):
            # a tree that holds tensors must not degrade to pickling in
            # the control lane: that includes mixed trees (a tensor next
            # to a scalar would drag the tensor through pickle)
            if any(isinstance(a, (torch.Tensor, np.ndarray)) for a in flat):
                raise TypeError(
                    "DeviceChannel payloads must be trees whose leaves are "
                    "ALL torch tensors; split host values out, or use "
                    "experimental.channel.Channel for host data")
            # non-tensor payloads (error markers, small control values)
            # ride the control lane inline
            self._control.write({"inline": tree}, timeout=timeout)
            return
        kinds = {a.device.type for a in flat}
        if kinds == {"cuda"}:
            self._write_ipc(flat, skeleton, timeout)
        elif kinds == {"cpu"}:
            self._write_host(flat, skeleton, timeout)
        else:
            raise TypeError(
                "DeviceChannel payloads hold tensors all on the card or all "
                f"on the CPU, not {sorted(kinds)}")

    def _write_ipc(self, flat, skeleton, timeout):
        from torch.multiprocessing.reductions import reduce_tensor

        torch.cuda.ipc_collect()   # free the blocks readers released
        # wait for the slot before anything is staged or shared: a
        # timeout then pins nothing, as the reference's publish-first
        # order ensures (the handle itself rides in the metadata)
        self._control.wait_writable(timeout)
        offsets, size = _layout(flat)
        # the snapshot: one block the writer owns, so that the caller may
        # reuse its tensors once write returns
        block = torch.empty(size, dtype=torch.uint8, device=flat[0].device)
        for t, off in zip(flat, offsets):
            _leaf_view(block, off, t.shape, t.dtype).copy_(t)
        staged = torch.cuda.Event()
        staged.record()
        # sharing records an IPC event after the copies, which another
        # process's reader waits on before it reads the block
        _, args = reduce_tensor(block)
        uid = secrets.randbits(62)
        self._control.write({
            "uuid": uid, "pid": os.getpid(), "ipc": args,
            "offsets": offsets, "specs": _specs(flat),
            "treedef": skeleton}, timeout=timeout)
        # another process's mapping keeps the block alive on its own.
        # A reader in this process (another end open on the path) takes it
        # from _staged: keep the last two writes' blocks there (a reader
        # that has taken write n's metadata is done with write n - 1)
        with _server_lock:
            if _open.get(self.path, 0) > 1:
                _staged[uid] = (block, staged)
                self._uids.append(uid)
                if len(self._uids) > 2:
                    _staged.pop(self._uids.pop(0), None)
        self._shared = True
        DeviceChannel.ipc_transfers += 1

    def _write_host(self, flat, skeleton, timeout):
        server = _transfer_server()
        snapshot = [a.detach().clone(memory_format=torch.contiguous_format)
                    for a in flat]
        uid = secrets.randbits(62)
        # metadata publishes FIRST: a control-write timeout then pins
        # nothing (await_pull has no unregister). The pull is a
        # rendezvous, so a reader that pulls before the registration
        # below blocks until it lands.
        self._control.write({
            "uuid": uid, "address": server.address(),
            "specs": _specs(flat), "treedef": skeleton},
            timeout=timeout)
        server.await_pull(uid, snapshot)
        DeviceChannel.host_lane_bytes += sum(a.nbytes for a in snapshot)

    def close_write(self) -> None:
        self._control.close_write()

    # --- reader ---

    def read(self, slot: int = 0, timeout: Optional[float] = None) -> Any:
        """``slot`` is kept for Channel's signature (compiled-DAG exec
        loops call read(slot)); DeviceChannel is 1:1, slot 0."""
        if slot != 0:
            raise ValueError("DeviceChannel is single-reader (slot 0)")
        # resolved before the payload is taken, so a refusal loses nothing
        dev = resolve_device(self.device)
        meta = self._control.read(0, timeout=timeout)
        if "inline" in meta:
            return meta["inline"]
        specs = [(shape, TORCH_DTYPES[name]) for shape, name in meta["specs"]]
        if "ipc" in meta:
            flat = self._read_ipc(meta, specs, dev)
        else:
            pulled = _connection(meta["address"]).pull(
                meta["uuid"], specs, timeout=timeout)
            DeviceChannel.host_lane_bytes += sum(a.nbytes for a in pulled)
            flat = [a.to(dev) for a in pulled]
        return _unflatten(meta["treedef"], flat)

    def _read_ipc(self, meta, specs, dev) -> List[torch.Tensor]:
        from torch.multiprocessing.reductions import rebuild_cuda_tensor

        if dev.type != "cuda":
            raise RuntimeError(
                "a CUDA payload crosses over CUDA IPC and lands on the "
                f"card; this reader's device is {dev}")
        stream = torch.cuda.current_stream(dev)
        args = meta["ipc"]
        local = meta["pid"] == os.getpid()
        if local:
            # a handle cannot be opened by the process that made it
            with _server_lock:
                if meta["uuid"] not in _staged:
                    raise RuntimeError(
                        "a reader in the writer's process needs its own "
                        "DeviceChannel on the path, opened before the write")
                src, staged = _staged[meta["uuid"]]
            stream.wait_event(staged)
        else:
            src = rebuild_cuda_tensor(*args)   # waits on the writer's event
        block = torch.empty(src.numel(), dtype=torch.uint8, device=dev)
        block.copy_(src)
        # the copy has run before the writer's block is let go
        stream.synchronize()
        if local:
            # release the count the writer's share set, as dropping a
            # mapping does in another process
            storage_cls, device, ref_handle, ref_offset = (
                args[4], args[6], args[11], args[12])
            storage_cls._release_ipc_counter(ref_handle, ref_offset,
                                             device=device)
        del src
        DeviceChannel.ipc_transfers += 1
        return [_leaf_view(block, off, shape, dtype)
                for off, (shape, dtype) in zip(meta["offsets"], specs)]

    # --- lifecycle ---

    def close(self) -> None:
        with _server_lock:
            for uid in self._uids:
                _staged.pop(uid, None)
            if self._registered:
                self._registered = False
                _open[self.path] -= 1
                if not _open[self.path]:
                    del _open[self.path]
        self._uids.clear()
        self._control.close()
        if self._shared:
            # free the staged blocks whose readers have let them go, so a
            # closed channel's blocks do not wait for a later write
            torch.cuda.ipc_collect()

    def unlink(self) -> None:
        self._control.unlink()

    def __reduce__(self):
        return (DeviceChannel, (self.path,), {"device": self.device})

    def __setstate__(self, state):
        self.device = state["device"]
