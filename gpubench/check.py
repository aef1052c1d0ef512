"""The comparison that decides ``correct``.

Each number compared has a limit of its own (the cell's workload file
gives them, with the readings they were set from in PERF.md); ``correct``
holds when every number is finite and at most its limit. A run prints each
number beside its limit as its last lines on standard error, and under the
result line's last key, ``checks``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

Checks = Dict[str, Dict[str, float]]


def served_gaps(ref_logits: torch.Tensor, served: Sequence[int]) -> torch.Tensor:
    """How far each served token's reference logit lies below the
    reference's best at that position."""
    tok = torch.as_tensor(list(served), device=ref_logits.device)
    chosen = ref_logits.gather(1, tok[:, None])[:, 0]
    return ref_logits.max(dim=1).values - chosen


def control_gaps(ref_logits: torch.Tensor, ctl_logits: torch.Tensor) -> torch.Tensor:
    """The gap, in the reference's logits, of the token that the control's
    lower precision puts first at each position."""
    return served_gaps(ref_logits, ctl_logits.argmax(dim=1).tolist())


def sample_requests(done: List[dict], n: int, seed: int) -> List[dict]:
    """``n`` of the requests ``done``: the one with the most served tokens,
    and the rest drawn from ``seed``."""
    if not done:
        return []
    order = sorted(done, key=lambda r: (-len(r["tokens"]), r["index"]))
    rest = order[1:]
    rng = np.random.default_rng([int(seed), 7])
    pick = rng.permutation(len(rest))[:max(0, n - 1)]
    return [order[0]] + [rest[i] for i in sorted(pick)]


def sequences(sample: List[dict]) -> Tuple[list, list]:
    """Each sampled request's prompt and served tokens but the last, and
    the positions whose logits predict its served tokens."""
    seqs, pos = [], []
    for r in sample:
        p, toks = r["prompt_ids"], r["tokens"]
        seqs.append(list(p) + list(toks[:-1]))
        pos.append(range(len(p) - 1, len(p) - 1 + len(toks)))
    return seqs, pos


def gap_readings(gaps: torch.Tensor) -> Dict[str, float]:
    """How a run's gaps spread: the widest, high quantiles, the mean and
    the share of positions whose served token is not the reference's
    best."""
    g = gaps.double()
    q = torch.quantile(g, torch.tensor([0.9, 0.99], dtype=g.dtype,
                                       device=g.device)).tolist()
    return {"max": float(g.max()), "p99": q[1], "p90": q[0],
            "mean": float(g.mean()),
            "off_best_share": float((g > 0).double().mean()),
            "positions": int(g.numel())}


def check(value: float, limit: float) -> Dict[str, float]:
    return {"value": float(value), "limit": float(limit)}


def verdict(checks: Checks) -> bool:
    return bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())


def check_lines(checks: Checks) -> List[str]:
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r})"
            for name, c in checks.items()]
