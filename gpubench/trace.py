"""A traced slice of a window, between two marker kernels, read in memory.

The slice's edges are taken on the card's clock: a marker kernel
(``torch.cuda._sleep``'s ``spin_kernel``, which nothing else launches) runs
alone, with a sync before and after it, at each edge; the slice's device
events are those after the first marker's end and before the second's
start. The profiler's events are reduced here and never written out: the
device busy time (the union of kernel and copy intervals), each kernel's
total, and the idle gaps.
"""

from __future__ import annotations

import re
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

MARK_KERNEL = "spin_kernel"
# the first marker spins this many cycles (~1 us), the second twenty times
# as long, so that each is known by its length alone
MARK_CYCLES = 1000
SECOND_MARK_MIN_US = 5.0
# small kernels launched before the first marker and after the second: the
# tracer can drop records at the start and at the end of a trace (seen
# with a dense stream of small kernels), which then fall on these, outside
# the slice
FILLERS = 40000


def mark(device, cycles: int) -> float:
    """A marker alone on the card, synced on both sides. Returns the host
    clock at its launch."""
    torch.cuda.synchronize(device)
    t = time.perf_counter()
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize(device)
    return t


def fill(device) -> None:
    one = torch.zeros(1, device=device)
    for _ in range(FILLERS):
        one.add_(1)
    torch.cuda.synchronize(device)


def union_length(spans: Sequence[Tuple[float, float]]) -> float:
    """Length covered by the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def gaps(spans: Sequence[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The intervals of [lo, hi] that no span covers."""
    out, at = [], lo
    for a, b in sorted(spans):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces, template
    arguments and parameters; a copy's or a fill's name whole."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip().rsplit("::", 1)[-1] or name


def warm_profiler(device) -> None:
    """Start and stop the profiler once on this thread: its first start in
    a process initialises the CUDA tracer, which takes seconds, and would
    otherwise fall inside the window."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize(device)


class Slice:
    """Profile a slice: ``begin()`` starts the profiler (the card's
    activity only, so that the host's dispatch runs at its own pace) and
    lays the first marker, ``end()`` lays the second and stops it,
    ``read()`` reduces the events."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.host_marks: List[float] = []

    def begin(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA],
                            acc_events=True)
        self.prof.start()
        fill(self.device)
        self.host_marks.append(mark(self.device, MARK_CYCLES))

    def end(self) -> None:
        self.host_marks.append(mark(self.device, 20 * MARK_CYCLES))
        t = time.perf_counter()
        fill(self.device)
        self.prof.stop()
        self.stop_s = time.perf_counter() - t

    def read(self) -> Optional[dict]:
        """The slice's reduction, or None when the trace holds neither
        marker. Where the tracer dropped one of them, the other stands
        for both edges, with the host's interval between the two launches
        (both laid on an idle card, so each starts within microseconds of
        its launch); ``edges`` says which markers were found."""
        from torch.autograd import DeviceType

        events = self.prof.events()
        self.prof = None
        dev = [e for e in events if e.device_type == DeviceType.CUDA]
        found = {("second" if e.time_range.elapsed_us() >= SECOND_MARK_MIN_US
                  else "first"): e.time_range
                 for e in dev if MARK_KERNEL in e.name}
        interval = 1e6 * (self.host_marks[1] - self.host_marks[0])
        if len(found) == 2:
            lo, hi = found["first"].end, found["second"].start
        elif "first" in found:
            lo = found["first"].end
            hi = found["first"].start + interval
        elif "second" in found:
            hi = found["second"].start
            lo = hi - interval
        else:
            print(f"gpubench: the trace holds no marker in {len(dev)} "
                  "device events", file=sys.stderr)
            return None
        edges = " and ".join(sorted(found))
        if len(found) == 1:
            print(f"gpubench: the tracer dropped a marker; the slice's edges "
                  f"are the {edges} one and the host's interval",
                  file=sys.stderr)
        spans, kernels = [], {}
        for e in dev:
            a, b = e.time_range.start, e.time_range.end
            if MARK_KERNEL in e.name or a < lo or b > hi:
                continue
            spans.append((a, b))
            k = short_name(e.name)
            kernels[k] = kernels.get(k, 0.0) + (b - a) / 1e6
        # the trace's seconds against the host clock, at the first edge
        offset = lo / 1e6 - self.host_marks[0]
        out = {"window_s": (hi - lo) / 1e6, "stop_s": self.stop_s,
               "device_events": len(dev), "edges": edges,
               "busy_s": union_length(spans) / 1e6,
               "kernels": kernels,
               "gaps": [((a / 1e6) - offset, (b / 1e6) - offset)
                        for a, b in gaps(spans, lo, hi)]}
        return out


def kernel_seconds(trace: Optional[dict], names: Sequence[str]) -> float:
    """Device seconds of the kernels whose short name is one of
    ``names``."""
    if not trace:
        return 0.0
    return sum(s for k, s in trace["kernels"].items() if k in names)


def breakdown(trace: dict, label_gap) -> dict:
    """The ten device ops that took most time, and the ten longest idle
    gaps, each named by ``label_gap(host_start, host_end)``."""
    ops = sorted(trace["kernels"].items(), key=lambda kv: -kv[1])[:10]
    longest = sorted(trace["gaps"], key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[k, s] for k, s in ops],
            "idle_gaps": [[label_gap(a, b), b - a] for a, b in longest]}
