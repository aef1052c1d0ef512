"""Mutable shared-memory channels (counterpart of
``ray_tpu/experimental/channel.py``).

A channel is a fixed-capacity mmap slot with single-writer / N-reader
semantics: the writer blocks until every registered reader consumed the
previous value, readers block until the next value arrives. No locks:
processes coordinate through monotonic u64 sequence counters in the
mapped header (a store-release / load-acquire pattern).

The ordering of those stores is the hardware's. The reference fences
between the payload store and the seq publication through its native
library where it has one; the port has no native library, so it takes
the reference's other branch: it requires x86-64, whose TSO keeps plain
stores in program order, and refuses to build a channel elsewhere.

Layout (the reference's, byte for byte, so either package reads a file
the other wrote):

    [magic u32][num_readers u32][write_seq u64]
    [read_seq u64 x num_readers][payload_len u64][payload ...]

Tensor lane: array payloads skip pickle. A numpy array or a torch tensor
is written as a raw header and its bytes, the dtype by numpy name. A torch
tensor sets the ``_TNSR_DEV`` flag, as a jax array does in the reference;
a CUDA tensor is one device-to-host copy straight into the mapped buffer.
A reader gives a flagged payload back as a torch tensor on its
``device`` (one host-to-device copy from the mapped buffer), and an
unflagged one as numpy; dtypes numpy lacks (bfloat16, the float8s) come
back as torch CPU tensors, since the port reads them through its own
name table and not through ``ml_dtypes``.
"""

from __future__ import annotations

import mmap
import os
import pickle
import platform
import struct
import time
import uuid
from typing import Any, Optional

import numpy as np
import torch

from .._private.device import DeviceLike, resolve_device

_MAGIC = 0x52435400  # "RCT\0"
_HDR = struct.Struct("<II")          # magic, num_readers
_U64 = struct.Struct("<Q")
_STOP_LEN = (1 << 64) - 1            # payload_len sentinel: channel closed

# tensor-payload prefix: cannot collide with pickle (protocol>=2 starts
# with b"\x80"), so readers dispatch on the first bytes
_TNSR = b"\x93RTT"
_TNSR_HDR = struct.Struct("<4sBB")   # magic, flags, ndim
_TNSR_DEV = 1                        # flags bit: a device array

DEFAULT_CAPACITY = 1 << 20

# dtype names of the tensor header (numpy's, and ml_dtypes' for the types
# numpy lacks) and the torch dtype of each
TORCH_DTYPES = {name: getattr(torch, name) for name in (
    "bool", "uint8", "int8", "int16", "int32", "int64", "float16",
    "bfloat16", "float32", "float64", "complex64", "complex128",
    "float8_e4m3fn", "float8_e5m2")}
_DTYPE_NAMES = {dtype: name for name, dtype in TORCH_DTYPES.items()}
# names the port always reads as torch tensors: numpy knows them only
# while ml_dtypes is loaded
_NOT_NUMPY = ("bfloat16", "float8_e4m3fn", "float8_e5m2")


def dtype_name(dtype: torch.dtype) -> str:
    """The header's name of a torch dtype (``torch.bfloat16`` -> 'bfloat16')."""
    try:
        return _DTYPE_NAMES[dtype]
    except KeyError:
        raise TypeError(f"no channel dtype name for {dtype}") from None


def _as_tensor(value):
    """(flags, array) when value takes the raw-tensor lane, else None.
    The array is a contiguous numpy array or torch tensor."""
    if isinstance(value, torch.Tensor):
        if (value.layout != torch.strided or value.is_nested
                or value.dtype not in _DTYPE_NAMES):
            return None
        return _TNSR_DEV, value.detach().contiguous()
    # exact type only: ndarray subclasses (MaskedArray, matrix) carry
    # state the raw lane would drop; they stay on pickle
    if type(value) is not np.ndarray:
        return None
    if value.dtype.hasobject or value.dtype.names is not None:
        return None
    # the header stores dtype.name; names that don't round-trip through
    # np.dtype (str/bytes dtypes: 'str160' etc.) stay on pickle
    try:
        if np.dtype(value.dtype.name) != value.dtype:
            return None
    except TypeError:
        return None
    return 0, np.ascontiguousarray(value)


def _name_of(arr) -> str:
    if isinstance(arr, torch.Tensor):
        return dtype_name(arr.dtype)
    return arr.dtype.name


def _tensor_payload_len(arr) -> int:
    return (_TNSR_HDR.size + 1 + len(_name_of(arr).encode())
            + 8 * arr.ndim + arr.nbytes)


def _require_ordered_stores() -> None:
    """The counter protocol relies on stores becoming visible in program
    order; without a fence that holds on x86-64 only."""
    if platform.machine() not in ("x86_64", "AMD64"):
        raise RuntimeError(
            "ray_tpu_torch's mutable channels need x86-64 (TSO orders the "
            "payload before its sequence counter); this host is "
            f"{platform.machine()}")


class ChannelClosed(Exception):
    """The writer closed the channel (DAG teardown)."""


class ChannelTimeout(Exception):
    pass


def _default_dir() -> str:
    for d in ("/dev/shm", "/tmp"):
        if os.path.isdir(d):
            return d
    return "/tmp"


class Channel:
    """One writer, ``num_readers`` readers, capacity-bounded payloads.

    ``device`` is where a reader places device-flagged tensor payloads
    (default: the card); it is resolved at the first such read, so a
    channel is made, written and read as numpy without a card."""

    def __init__(self, path: Optional[str] = None, *, num_readers: int = 1,
                 capacity: int = DEFAULT_CAPACITY, create: bool = False,
                 device: DeviceLike = None):
        _require_ordered_stores()
        if path is None:
            create = True
            path = os.path.join(_default_dir(),
                                f"rtpu_chan_{uuid.uuid4().hex[:12]}")
        self.path = path
        self.capacity = capacity
        self.num_readers = num_readers
        self.device = device
        if create:
            size = _HDR.size + 8 + 8 * num_readers + 8 + capacity
            with open(path, "wb") as f:
                f.truncate(size)
            with open(path, "r+b") as f:
                mm = mmap.mmap(f.fileno(), size)
            _HDR.pack_into(mm, 0, _MAGIC, num_readers)
            self._mm = mm
        else:
            with open(path, "r+b") as f:
                mm = mmap.mmap(f.fileno(), os.path.getsize(path))
            magic, nr = _HDR.unpack_from(mm, 0)
            if magic != _MAGIC:
                raise ValueError(f"{path}: not a channel file")
            self.num_readers = nr
            self.capacity = len(mm) - (_HDR.size + 8 + 8 * nr + 8)
            self._mm = mm
        self._w_off = _HDR.size
        self._r_off = _HDR.size + 8
        self._len_off = self._r_off + 8 * self.num_readers
        self._data_off = self._len_off + 8

    # --- low-level counter access ---

    def _write_seq(self) -> int:
        return _U64.unpack_from(self._mm, self._w_off)[0]

    def _read_seq(self, slot: int) -> int:
        return _U64.unpack_from(self._mm, self._r_off + 8 * slot)[0]

    def _wait(self, cond, timeout: Optional[float]):
        deadline = None if timeout is None else time.monotonic() + timeout
        spin = 0
        while not cond():
            if deadline is not None and time.monotonic() > deadline:
                raise ChannelTimeout(self.path)
            spin += 1
            if spin < 200:
                continue                      # hot spin: latency path
            time.sleep(0.0002 if spin < 2000 else 0.002)

    # --- writer API ---

    def wait_writable(self, timeout: Optional[float] = None) -> None:
        """Block until every reader consumed the last value, so that the
        next :meth:`write` does not wait (raises ChannelTimeout)."""
        seq = self._write_seq()
        self._wait(lambda: all(self._read_seq(i) >= seq
                               for i in range(self.num_readers)), timeout)

    def write(self, value: Any, timeout: Optional[float] = None) -> None:
        tens = _as_tensor(value)
        if tens is not None:
            payload = None
            flags, arr = tens
            length = _tensor_payload_len(arr)
        else:
            payload = pickle.dumps(value, protocol=5)
            length = len(payload)
        if length > self.capacity:
            raise ValueError(
                f"channel payload {length}B exceeds capacity "
                f"{self.capacity}B (recompile with a larger buffer)")
        seq = self._write_seq()
        self.wait_writable(timeout)
        if payload is not None:
            self._mm[self._data_off:self._data_off + length] = payload
        else:
            self._write_tensor(flags, arr)
        _U64.pack_into(self._mm, self._len_off, length)
        # release: payload and length stored before the seq advance
        _U64.pack_into(self._mm, self._w_off, seq + 1)

    def _write_tensor(self, flags: int, arr) -> None:
        name = _name_of(arr).encode()
        off = self._data_off
        _TNSR_HDR.pack_into(self._mm, off, _TNSR, flags, arr.ndim)
        off += _TNSR_HDR.size
        self._mm[off] = len(name)
        off += 1
        self._mm[off:off + len(name)] = name
        off += len(name)
        for dim in arr.shape:
            _U64.pack_into(self._mm, off, dim)
            off += 8
        nbytes = arr.nbytes
        if not nbytes:
            return
        # raw bytes straight into the mapped buffer (no pickle copy); for
        # a CUDA tensor this is the one device-to-host copy
        if isinstance(arr, torch.Tensor):
            view = torch.frombuffer(self._mm, dtype=torch.uint8,
                                    count=nbytes, offset=off)
            view.copy_(arr.reshape(-1).view(torch.uint8))
        else:
            view = np.frombuffer(self._mm, dtype=np.uint8, count=nbytes,
                                 offset=off)
            view[:] = arr.reshape(-1).view(np.uint8)
        del view   # an exported view would keep the map from closing

    def close_write(self) -> None:
        """Publish the STOP sentinel; readers raise ChannelClosed."""
        seq = self._write_seq()
        try:
            self.wait_writable(5.0)
        except ChannelTimeout:
            pass  # force-close: a stuck reader must still see STOP
        _U64.pack_into(self._mm, self._len_off, _STOP_LEN)
        _U64.pack_into(self._mm, self._w_off, seq + 1)

    # --- reader API ---

    def read(self, slot: int = 0, timeout: Optional[float] = None) -> Any:
        seq = self._read_seq(slot)
        self._wait(lambda: self._write_seq() > seq, timeout)
        length = _U64.unpack_from(self._mm, self._len_off)[0]
        if length == _STOP_LEN:
            raise ChannelClosed(self.path)
        if (length >= _TNSR_HDR.size
                and self._mm[self._data_off:self._data_off + 4] == _TNSR):
            value = self._read_tensor()
        else:
            value = pickle.loads(
                self._mm[self._data_off:self._data_off + length])
        # release: the payload is copied out before the seq advance
        _U64.pack_into(self._mm, self._r_off + 8 * slot, seq + 1)
        return value

    def _read_tensor(self):
        off = self._data_off
        _, flags, ndim = _TNSR_HDR.unpack_from(self._mm, off)
        off += _TNSR_HDR.size
        nlen = self._mm[off]
        off += 1
        name = bytes(self._mm[off:off + nlen]).decode()
        off += nlen
        shape = []
        for _ in range(ndim):
            shape.append(_U64.unpack_from(self._mm, off)[0])
            off += 8
        if flags & _TNSR_DEV or name in _NOT_NUMPY:
            dev = (resolve_device(self.device) if flags & _TNSR_DEV
                   else torch.device("cpu"))
            return _tensor_from(self._mm, off, name, shape, dev)
        dtype = np.dtype(name)
        count = dtype.itemsize
        for dim in shape:
            count *= dim
        # a private copy before the slot is released: the next write may
        # overwrite the buffer the moment our read seq advances
        return (np.frombuffer(self._mm, dtype=np.uint8, count=count,
                              offset=off)
                .copy().view(dtype).reshape(shape))

    # --- lifecycle ---

    def unlink(self) -> None:
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass

    def close(self) -> None:
        try:
            self._mm.close()
        except BufferError:
            pass  # a view of the map is still alive; the GC unmaps it

    def __reduce__(self):
        return (Channel, (self.path,),
                {"capacity": self.capacity,
                 "num_readers": self.num_readers, "device": self.device})

    def __setstate__(self, state):
        # __init__(path) already remapped from the file header; the
        # reader's device travels with the channel
        self.device = state.get("device")


def _tensor_from(buf, off: int, name: str, shape, device: torch.device):
    """A tensor on ``device`` that owns a copy of the raw bytes at
    ``buf[off:]``: one host-to-device copy, or one host copy on the CPU."""
    try:
        dtype = TORCH_DTYPES[name]
    except KeyError:
        raise TypeError(f"channel payload of dtype {name!r}: no torch "
                        "dtype") from None
    count = dtype.itemsize
    for dim in shape:
        count *= dim
    if not count:
        return torch.empty(shape, dtype=dtype, device=device)
    src = torch.frombuffer(buf, dtype=torch.uint8, count=count, offset=off)
    # .to() from pageable memory returns once the bytes are read, and the
    # CPU copy is a clone: either way nothing holds the map after this
    out = src.to(device) if device.type != "cpu" else src.clone()
    del src
    return out.view(dtype).reshape(shape)
