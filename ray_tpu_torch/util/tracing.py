"""The port's one range API (``span``, ``record``) and the device profiler
(counterparts of ``span`` and ``profile`` in ``ray_tpu/util/tracing.py``;
the rest of that module, the cluster's span and timeline plane, is host
plane and is not ported).

Code of the port marks a region with ``span``, and nothing else:

    with span("engine.decode", steps=K):
        ...

A span is one of three things, decided when it opens:

- the tracer off and no ``torch.profiler`` running: one shared no-op
  context, with no ``record_function`` call, no clock read and no
  allocation, so that spans cost nothing on a path that is not traced;
- the tracer off and a ``torch.profiler`` running: a ``record_function``
  range, so that the profiler's trace names the region;
- the tracer on (``enable``): a record in memory of its name, its start
  and end on ``time.perf_counter``, its parent (the span open around it
  on the same thread), its root (the outermost span open on that thread:
  every span inside an ``engine.step`` has that step's id as its root)
  and its attributes. With ``enable(device=True)`` a span opened with
  ``device=True`` also records a pair of CUDA events on the current
  stream, which ``drain`` turns into the interval its device work took,
  on the same host clock.

``record(name, t0)`` records an interval that began at ``t0`` (a
``stamp()``, taken perhaps on another thread) and ends now. The records
stay in memory, in a bounded buffer that drops the oldest, until
``drain`` takes them; nothing is written out.
"""

from __future__ import annotations

import collections
import itertools
import os
import socket
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Any, Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, record_function
from torch.profiler import profile as _torch_profile

from .._private.device import DeviceLike, resolve_device

# the spans (and the device spans) the buffer keeps before it drops the
# oldest: about a minute of a serving engine's steps
CAPACITY = 1 << 18

_now = time.perf_counter
_NOOP = nullcontext()


class Span(NamedTuple):
    """One recorded interval. ``t0`` and ``t1`` are seconds on
    ``time.perf_counter``; ``parent`` and ``root`` are span ids (``root``
    is the span's own id for an outermost span; ``parent`` is None)."""
    name: str
    t0: float
    t1: float
    id: int
    parent: Optional[int]
    root: int
    attrs: Dict[str, Any]


class _Tracer:
    """The spans recorded since the last ``drain``, and the state that
    says what to record."""

    def __init__(self, capacity: int = CAPACITY):
        self.on = False
        self.device = False
        self.spans: collections.deque = collections.deque(maxlen=capacity)
        # (span, start event, end event) of device spans not yet drained
        self.pending: collections.deque = collections.deque(maxlen=capacity)
        self.ids = itertools.count(1)
        self.local = threading.local()
        # (event, host time) recorded on an idle card by enable(device=True)
        self.anchor = None
        self.pool: List[Any] = []       # drained events, reused

    def stack(self) -> list:
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack

    def event(self):
        if self.pool:
            return self.pool.pop()
        return torch.cuda.Event(enable_timing=True)


_TRACER = _Tracer()


class _Open:
    """A span of the tracer while it is open."""

    __slots__ = ("name", "device", "attrs", "id", "parent", "root", "t0",
                 "ev0")

    def __init__(self, name: str, device: bool, attrs: Dict[str, Any]):
        self.name, self.attrs = name, attrs
        self.device = device and _TRACER.device

    def __enter__(self):
        tr = _TRACER
        stack = tr.stack()
        self.id = next(tr.ids)
        if stack:
            self.parent, self.root = stack[-1].id, stack[0].id
        else:
            self.parent, self.root = None, self.id
        stack.append(self)
        if self.device:
            self.ev0 = tr.event()
            self.ev0.record()
        self.t0 = _now()
        return self

    def __exit__(self, *exc):
        t1 = _now()
        tr = _TRACER
        span = Span(self.name, self.t0, t1, self.id, self.parent, self.root,
                    self.attrs)
        if self.device:
            ev1 = tr.event()
            ev1.record()
            tr.pending.append((span, self.ev0, ev1))
        tr.stack().pop()
        tr.spans.append(span)
        return False


def span(name: str, device: bool = False, **attrs):
    """A context that marks the region it encloses as ``name`` (see the
    module's docstring for what it records, and when). ``device=True``
    also times the region's device work while device tracing is on."""
    if not _TRACER.on:
        if not _autograd_profiler._is_profiler_enabled:
            return _NOOP
        return record_function(name)
    return _Open(name, device, attrs)


def stamp() -> Optional[float]:
    """The host clock while the tracer is on, else None (no clock read):
    the start of an interval that ``record`` ends."""
    return _now() if _TRACER.on else None


def record(name: str, t0: Optional[float], **attrs) -> None:
    """Record ``name`` from ``t0`` (a ``stamp()``) to now, as an outermost
    span. Nothing is recorded while the tracer is off or when ``t0`` is
    None."""
    tr = _TRACER
    if not tr.on or t0 is None:
        return
    sid = next(tr.ids)
    tr.spans.append(Span(name, t0, _now(), sid, None, sid, attrs))


def enable(device: bool = False) -> None:
    """Turn the tracer on. ``device=True`` also times ``device=True``
    spans on the current CUDA device; its first call after the tracer was
    off (or after device tracing was off) synchronises the card and
    records the anchor event that ``drain`` measures those spans from.
    ``device=False`` turns device tracing off and keeps host tracing on."""
    tr = _TRACER
    if device and not tr.device:
        torch.cuda.synchronize()
        ev = torch.cuda.Event(enable_timing=True)
        t = _now()
        ev.record()
        ev.synchronize()
        tr.anchor = (ev, t)
    tr.device = bool(device)
    tr.on = True


@contextmanager
def device_spans_off():
    """Suspend device spans in the block, on every thread, and restore the
    tracer's state after it: host spans are still recorded. A CUDA graph
    capture runs in this block, so that no span's events are baked into
    the graph."""
    tr = _TRACER
    saved = tr.device
    tr.device = False
    try:
        yield
    finally:
        tr.device = saved


def annotate(**attrs) -> None:
    """Add ``attrs`` to the innermost span open on this thread, while the
    tracer is on (for what is known only inside the span)."""
    tr = _TRACER
    if tr.on:
        stack = tr.stack()
        if stack:
            stack[-1].attrs.update(attrs)


def disable() -> None:
    """Turn the tracer off; what it recorded stays until ``drain``."""
    _TRACER.on = False
    _TRACER.device = False


def drain() -> Dict[str, List[Span]]:
    """The spans recorded since the last drain, and empty the buffer:
    ``{"host": [...], "device": [...]}``, each in the order the spans
    ended. A device span has its host span's name, id, parent, root and
    attributes, and the interval its device work took, placed on the
    host clock by the anchor (the anchor's host time plus the events'
    elapsed time from it)."""
    tr = _TRACER
    # popleft, one at a time: a span another thread ends meanwhile stays
    # for the next drain
    host = [tr.spans.popleft() for _ in range(len(tr.spans))]
    pending = [tr.pending.popleft() for _ in range(len(tr.pending))]
    device = []
    if pending:
        anchor, t_anchor = tr.anchor
        for sp, ev0, ev1 in pending:
            ev1.synchronize()
            device.append(sp._replace(
                t0=t_anchor + anchor.elapsed_time(ev0) / 1e3,
                t1=t_anchor + anchor.elapsed_time(ev1) / 1e3))
            tr.pool += (ev0, ev1)
    return {"host": host, "device": device}


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
