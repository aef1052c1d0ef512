"""The device profiler (counterpart of ``profile`` and ``span`` in
``ray_tpu/util/tracing.py``). The rest of that module, the cluster's
span and timeline plane, is host plane and is not ported."""

from __future__ import annotations

import os
import socket
import time
from contextlib import contextmanager

from torch.profiler import ProfilerActivity, record_function
from torch.profiler import profile as _torch_profile

from .._private.device import DeviceLike, resolve_device


@contextmanager
def profile(log_dir: str, device: DeviceLike = None):
    """Trace the block with ``torch.profiler``: CPU and CUDA activity on
    the card (the default), CPU activity only with ``device="cpu"``. On
    exit a Chrome/Perfetto trace, ``<host>_<pid>.<ms>.pt.trace.json``, is
    written under ``log_dir``. Yields the profiler, whose ``events()``
    hold what it traced."""
    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    # acc_events: the caller reads events() after the block has ended
    prof = _torch_profile(activities=activities, acc_events=True)
    prof.start()
    try:
        yield prof
    finally:
        # the trace is written whatever the block did, as the
        # reference's stop_trace is
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"{socket.gethostname()}_{os.getpid()}."
                     f"{time.time_ns() // 1_000_000}.pt.trace.json"))


@contextmanager
def span(name: str):
    """Annotate a host-side region so that it shows in the profiler's
    trace, its device work under it (``record_function``)."""
    with record_function(name):
        yield
