"""Statistics over a measured window: percentiles and rates.

A rate is taken over all the work and all the time of the window: a stall
inside the window lowers it, and a tail is the tail of every request.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default, Python's ``method="inclusive"``).
    None for an empty sample."""
    xs = sorted(values)
    if not xs:
        return None
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile {q} outside [0, 100]")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def prorated_rate(spans: Iterable[Tuple[float, float, float]], t0: float,
                  t1: float) -> float:
    """Work per second of the window [t0, t1] for work done in spans
    ``(start, end, amount)``: a span's amount accrues evenly over it, so a
    span that straddles an edge counts for the part inside. Time in no
    span counts, with no work: a stall lowers the rate."""
    if t1 <= t0:
        raise ValueError("empty window")
    done = 0.0
    for a, b, amount in spans:
        inside = min(b, t1) - max(a, t0)
        if inside > 0:
            done += amount * inside / (b - a)
    return done / (t1 - t0)
