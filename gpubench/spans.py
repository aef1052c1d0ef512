"""The per-layer metrics that read the program's own spans.

The program's tracer (``ray_tpu_torch/util/tracing.py``) records each
span's name, its start and end on ``time.perf_counter``, its parent and
root, and its attributes; a ``device=True`` span also gives the interval
its device work took, on the same clock. A driver that turns the tracer
on puts ``tracing.drain()`` into ``records["spans"]``
(``{"host": [...], "device": [...]}``). Host metrics are taken over the
window's spans (those that ended inside it), device metrics over the
traced slice, whose idle gaps ``gpubench/trace.py`` puts on the same host
clock. Each reader returns None where the records hold no spans (a
program or a driver without the tracer) or nothing the metric reads.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Sequence, Tuple

from gpubench import trace

# the innermost host span over an idle gap says what the host was doing:
# its bookkeeping around the model ...
BOOKKEEPING = ("serve.pump.hop", "serve.pump.fanout", "engine.step",
               "engine.admit", "engine.prefill.prep", "engine.decode.prep",
               "engine.decode.emit")
# ... or launching the model's forward
DISPATCH_PREFIXES = ("runner.", "op.")


def _host(records) -> Optional[list]:
    spans = records.get("spans")
    return spans["host"] if spans and spans.get("host") else None


def window_spans(records, name: str) -> list:
    """The host spans ``name`` that ended inside the window."""
    t0, t1 = records["window"]
    return [s for s in _host(records) or ()
            if s.name == name and t0 <= s.t1 <= t1]


def _ms(spans) -> float:
    return sum(s.t1 - s.t0 for s in spans) * 1e3


def pump_ms(records):
    """Mean host ms a step the server's pump spent outside the engine: its
    hop (submit to the step's start, the engine lock included) and its
    fan-out (the step's return to the next submit)."""
    hops = window_spans(records, "serve.pump.hop")
    fans = window_spans(records, "serve.pump.fanout")
    if not hops or not fans:
        return None
    return _ms(hops) / len(hops) + _ms(fans) / len(fans)


def decode_host_ms(records):
    """Host ms a decode step spent not waiting on the card: the window's
    ``engine.decode`` spans less their ``engine.decode.sync`` children,
    over the decode steps (the spans' ``steps``) they ran."""
    decodes = window_spans(records, "engine.decode")
    steps = sum(s.attrs["steps"] for s in decodes)
    if not steps:
        return None
    ids = {s.id for s in decodes}
    syncs = [s for s in _host(records) if s.name == "engine.decode.sync"
             and s.parent in ids]
    return (_ms(decodes) - _ms(syncs)) / steps


def prefill_pad_share(records):
    """Padding's share of the tokens the window's prefills ran, in %:
    sum(padded - tokens) / sum(padded) over ``engine.prefill`` spans."""
    pre = window_spans(records, "engine.prefill")
    padded = sum(s.attrs["padded"] for s in pre)
    if not padded:
        return None
    return 100.0 * (padded - sum(s.attrs["tokens"] for s in pre)) / padded


def slice_bounds(tr) -> Tuple[float, float]:
    """The traced slice on the host clock. Its first idle gap starts at
    the slice's edge: the card is synced and idle after the first
    marker."""
    lo = tr["gaps"][0][0]
    return lo, lo + tr["window_s"]


def _traced(records) -> Optional[dict]:
    tr = records.get("trace")
    if not tr or tr["window_s"] <= 0 or not tr["gaps"] \
            or not _host(records):
        return None
    return tr


def innermost_idle(host: Sequence, gaps: Sequence[Tuple[float, float]]):
    """Seconds of ``gaps`` under each span name that is innermost there
    (the latest-started of the spans open at that instant), and under no
    span (key None)."""
    edges = sorted({t for s in host for t in (s.t0, s.t1)}
                   | {t for g in gaps for t in g})
    starts = sorted(host, key=lambda s: s.t0)
    t0s = [s.t0 for s in starts]
    out = {}
    for a, b in gaps:
        i = bisect.bisect_left(edges, a)
        while i + 1 < len(edges) and edges[i] < b:
            lo, hi = edges[i], min(edges[i + 1], b)
            mid = (lo + hi) / 2
            # the latest-started span open at mid
            name = None
            j = bisect.bisect_right(t0s, mid) - 1
            while j >= 0:
                if starts[j].t1 > mid:
                    name = starts[j].name
                    break
                j -= 1
            out[name] = out.get(name, 0.0) + (hi - lo)
            i += 1
    return out


def _idle_by_span(records):
    tr = _traced(records)
    if tr is None:
        return None, None
    lo, hi = slice_bounds(tr)
    host = [s for s in _host(records) if s.t1 > lo and s.t0 < hi]
    if not host:
        return None, None
    return innermost_idle(host, tr["gaps"]), tr


def idle_share_bookkeeping(records):
    """The slice's share, in %, with the card idle while the host's
    innermost span is the pump's, the engine's admission, a phase's prep,
    the decode's emission, or ``engine.step`` itself."""
    idle, tr = _idle_by_span(records)
    if idle is None:
        return None
    return 100.0 * sum(v for k, v in idle.items()
                       if k in BOOKKEEPING) / tr["window_s"]


def idle_share_dispatch(records):
    """The slice's share, in %, with the card idle while the host's
    innermost span is the runner's or an op's: the model's forward being
    launched."""
    idle, tr = _idle_by_span(records)
    if idle is None:
        return None
    return 100.0 * sum(v for k, v in idle.items()
                       if k is not None and k.startswith(DISPATCH_PREFIXES)
                       ) / tr["window_s"]


def _overlap(spans: List[Tuple[float, float]],
             gaps: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of ``spans`` that falls inside ``gaps``
    (disjoint and sorted)."""
    merged: List[List[float]] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    out, j = 0.0, 0
    for a, b in merged:
        while j < len(gaps) and gaps[j][1] <= a:
            j += 1
        k = j
        while k < len(gaps) and gaps[k][0] < b:
            out += max(0.0, min(b, gaps[k][1]) - max(a, gaps[k][0]))
            k += 1
    return out


def mlp_device_share(records):
    """The slice's busy time inside ``op.mlp`` device intervals (their
    union within the slice, less its overlap with the idle gaps), as a
    share of the slice's busy time, in %."""
    tr = _traced(records)
    if tr is None or not tr["busy_s"]:
        return None
    lo, hi = slice_bounds(tr)
    mlp = [(max(s.t0, lo), min(s.t1, hi))
           for s in records["spans"].get("device") or ()
           if s.name == "op.mlp" and s.t1 > lo and s.t0 < hi]
    if not mlp:
        return None
    busy = trace.union_length(mlp) - _overlap(mlp, sorted(tr["gaps"]))
    return 100.0 * busy / tr["busy_s"]
