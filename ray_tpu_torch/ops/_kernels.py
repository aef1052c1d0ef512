"""Builds the port's CUDA kernels and binds them through ctypes.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), at first use, into ``ray_tpu_torch/_kernels_build/``. Library
names carry a hash of the source, the headers and the flags, so an edited
source or header is rebuilt and a stale library is never loaded. Sources
include headers from ``csrc/`` only (``sm90.cuh``), and no ``-I`` path is
given. Only the repository's own sources are built; nothing is fetched.

The C entry points take pointers and the stream as ``c_void_p`` and
return ``cudaGetLastError()``; :func:`check` raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_kernels_build"

# library -> source; each library's C entry points are in ENTRIES
SOURCES = {"flash_fwd": "flash_fwd.cu", "flash_bwd": "flash_bwd.cu",
           "paged_decode": "paged_decode.cu"}
ENTRIES = {"flash_fwd": ("flash_fwd", "flash_fwd_tc"),
           "flash_bwd": ("flash_bwd_dq", "flash_bwd_dq_tc", "flash_bwd_dkv",
                         "flash_bwd_dkv_tc"),
           "paged_decode": ("paged_decode",)}
# the head dims every flash and paged kernel is built for, in f32 and bf16
# (the instantiations in each source's C entry points)
HEAD_DIMS = (16, 32, 64, 128)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    # q, k, v, o, lse, B, Sq, Skv, Hq, Hkv, D, strides[9], scale, causal,
    # dtype, stream
    "flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _F, _I,
                  _I, _P],
    # q, k, v, dout, lse, dvec, dq, B, Sq, Skv, Hq, Hkv, D, strides[12],
    # scale, causal, dtype, stream
    "flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                     _F, _I, _I, _P],
    # as flash_bwd_dq with dk, dv in place of dq
    "flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      _P, _F, _I, _I, _P],
    # q, ck, cv, nk, nv, bt, ctx_len, new_len, part, out, B, kvh, rep, hd,
    # P, page_size, n_pages, K, pages_per_split, n_splits, scale, dtype,
    # stream
    "paged_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                     _I, _I, _I, _I, _I, _I, _F, _I, _P],
}
# each tensor-core entry takes its SIMT sibling's arguments
_ARGTYPES.update({e + "_tc": _ARGTYPES[e]
                  for e in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")})

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's output per kernel (ptxas register and shared-memory use) and the
# seconds the last build_all() took
build_log: Dict[str, str] = {}
build_seconds: float = 0.0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _lib_path(name: str) -> Path:
    """The library's path, named by a hash of its source, of every header
    in ``csrc/`` (a source may include any of them) and of the flags."""
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every kernel whose library is missing, all nvcc processes
    started together. Returns name -> library path. Raises with nvcc's
    output if a build fails."""
    global build_seconds
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in SOURCES}
    procs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, path)
    build_seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def lib(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (a key of SOURCES), built on first use,
    with the argument types of its entry points set."""
    with _lock:
        if name not in _libs:
            path = _lib_path(name)
            if not path.exists():
                build_all()
            dll = ctypes.CDLL(str(path))
            for entry in ENTRIES[name]:
                fn = getattr(dll, entry)
                fn.argtypes = _ARGTYPES[entry]
                fn.restype = ctypes.c_int
            _libs[name] = dll
        return _libs[name]


# the wrappers' launch counters (``<wrapper>.launches``) are shared by
# every thread of the process: two serve pumps may launch at once
COUNT_LOCK = threading.Lock()


def check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
