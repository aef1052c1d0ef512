"""A socket transfer server for CPU tensors (counterpart of
``ray_tpu/experimental/_transfer_shim.py``): the host lane of
:class:`~ray_tpu_torch.experimental.device_channel.DeviceChannel`.

    server = ShimTransferServer("h:0")
    server.address()            -> "host:port"
    server.await_pull(uid, tensors)
    conn = ShimConnection("host:port")
    tensors = conn.pull(uid, specs)  # specs: [(shape, torch dtype)]

The pull protocol is a rendezvous (a reader that pulls before the writer
registers blocks until the registration lands), and a payload is consumed
by exactly one pull, after which the registration is dropped. It carries
CPU tensors only: a CUDA tensor never goes through it.

Wire protocol (the reference's; all integers big-endian):
    request:  u64 uid
    response: u32 narrays, then per array u64 length + raw bytes
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("transfer peer closed mid-message")
        got += k
    return buf


def _no_delay(sock: socket.socket) -> None:
    """Send small messages at once: a request and a reply's header wait
    otherwise for the peer's delayed acknowledgement (~40 ms each)."""
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


class ShimConnection:
    """One reader's link to a writer-side server; pulls are sequential
    (the channel orders them through its control lane)."""

    def __init__(self, address: str):
        host, port = address.rsplit(":", 1)
        self._sock = socket.create_connection((host, int(port)))
        _no_delay(self._sock)
        self._lock = threading.Lock()

    def pull(self, uid: int, specs: Sequence[Tuple[Tuple[int, ...],
                                                   torch.dtype]],
             timeout: Optional[float] = None) -> List[torch.Tensor]:
        """The tensors registered under ``uid``, as CPU tensors that own
        their bytes. ``timeout`` bounds each socket wait (None: none)."""
        with self._lock:
            self._sock.settimeout(timeout)
            self._sock.sendall(struct.pack(">Q", uid))
            (count,) = struct.unpack(">I", _recv_exact(self._sock, 4))
            raw = []
            for _ in range(count):
                (size,) = struct.unpack(">Q", _recv_exact(self._sock, 8))
                raw.append(_recv_exact(self._sock, size))
        if count != len(specs):
            raise ValueError(
                f"transfer pull {uid}: peer sent {count} arrays, "
                f"reader expected {len(specs)}")
        out = []
        for buf, (shape, dtype) in zip(raw, specs):
            if not buf:
                out.append(torch.empty(shape, dtype=dtype))
                continue
            out.append(torch.frombuffer(buf, dtype=torch.uint8)
                       .view(dtype).reshape(shape))
        return out

    def close(self) -> None:
        self._sock.close()


class ShimTransferServer:
    def __init__(self, address: str):
        host = address.rsplit(":", 1)[0]
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, 0))
        self._listener.listen()
        self._address = f"{host}:{self._listener.getsockname()[1]}"
        self._pending: Dict[int, list] = {}
        self._cv = threading.Condition()
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="transfer_shim_accept").start()

    def address(self) -> str:
        return self._address

    def await_pull(self, uid: int, tensors: Sequence[torch.Tensor]) -> None:
        if any(t.device.type != "cpu" for t in tensors):
            raise TypeError("the transfer shim carries CPU tensors only")
        with self._cv:
            self._pending[uid] = list(tensors)
            self._cv.notify_all()

    # --- serving side ---

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            _no_delay(conn)
            threading.Thread(target=self._serve, args=(conn,), daemon=True,
                             name="transfer_shim_serve").start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            while True:
                (uid,) = struct.unpack(">Q", _recv_exact(conn, 8))
                with self._cv:
                    # rendezvous: block until the writer registers uid
                    while uid not in self._pending:
                        self._cv.wait()
                    tensors = self._pending.pop(uid)
                conn.sendall(struct.pack(">I", len(tensors)))
                for t in tensors:
                    raw = t.contiguous().reshape(-1).view(torch.uint8)
                    conn.sendall(struct.pack(">Q", raw.numel()))
                    if raw.numel():
                        conn.sendall(raw.numpy())
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

