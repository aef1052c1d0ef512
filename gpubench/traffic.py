"""The one traffic generator: it turns a mix's parameters (a
``traffic/<name>.json`` file) and a seed into the requests a cell sends.

Every seed gets the same sizes, and its own token ids: lengths come in
blocks of ``strata`` requests, and a block holds one length from each of
``strata`` equal-probability slices of the distribution (the slice's
middle quantile), so any run of whole blocks has the same lengths and a
window holds about the same work whatever the seed. The order inside each
block is drawn from the run's seed, or, where the mix sets ``order_seed``
to a number, from that number, so that every seed sends the same lengths
in the same order; prompt and output lengths are shuffled apart.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

TRAFFIC_DIR = Path(__file__).parent / "traffic"


@dataclasses.dataclass
class Request:
    index: int
    prompt_ids: List[int]
    max_tokens: int


def load_traffic(name: str) -> Dict[str, Any]:
    path = TRAFFIC_DIR / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    return json.loads(path.read_text())


def quantile(dist: Dict[str, Any], u: float) -> int:
    """The ``u`` quantile of a length distribution, rounded and clipped
    to [min, max]. ``lognormal``: median * exp(sigma * z_u)."""
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    z = statistics.NormalDist().inv_cdf(u)
    x = round(float(dist["median"]) * math.exp(float(dist["sigma"]) * z))
    return int(min(max(x, int(dist["min"])), int(dist["max"])))


def stratified_lengths(rng: np.random.Generator, dist: Dict[str, Any],
                       n: int, strata: int) -> List[int]:
    """``n`` lengths in blocks of ``strata``, each block the same set of
    slice quantiles in an order drawn from ``rng``."""
    block = [quantile(dist, (i + 0.5) / strata) for i in range(strata)]
    out: List[int] = []
    while len(out) < n:
        out.extend(block[i] for i in rng.permutation(strata))
    return out[:n]


def make_requests(traffic: Dict[str, Any], seed: int,
                  vocab: int) -> List[Request]:
    """The mix's ``requests`` requests for ``seed``: lengths by
    :func:`stratified_lengths`, in an order drawn from the mix's
    ``order_seed`` or, where that is null, from ``seed``; prompt ids
    uniform in [0, vocab) from ``seed``."""
    fixed = traffic.get("order_seed")
    order = np.random.default_rng(
        [int(seed), 1] if fixed is None else int(fixed))
    n, strata = int(traffic["requests"]), int(traffic["strata"])
    prompts = stratified_lengths(order, traffic["prompt_tokens"], n, strata)
    outputs = stratified_lengths(order, traffic["output_tokens"], n, strata)
    ids = np.random.default_rng(seed).integers(0, vocab, size=sum(prompts),
                                               dtype=np.int64)
    reqs, at = [], 0
    for i, (p, o) in enumerate(zip(prompts, outputs)):
        reqs.append(Request(i, ids[at:at + p].tolist(), o))
        at += p
    return reqs
