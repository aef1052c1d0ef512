"""Counter / Gauge / Histogram with tags, recorded in this process
(counterpart of ``ray_tpu/util/metrics.py``).

The port keeps the parts that ``llm/serve.py`` and ``util/hbm.py`` use: the
three metric kinds with ``set_default_tags``, ``inc``, ``set`` and
``observe``, ``LATENCY_BUCKETS`` and :func:`snapshot_local`, whose keys are
the reference's (``name{k=v,...}``, histograms as per-bucket counts plus
``__stat__=count`` and ``__stat__=sum``). Values are recorded locally only:
there is no flusher and no export. A caller that wants the reference's
pipeline passes ``ray_tpu.util.metrics`` to the server as its ``metrics``
hook instead.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

# request latencies: sub-ms cache-hit TTFTs to multi-second generations
LATENCY_BUCKETS = [0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0]

_registry_lock = threading.Lock()
_registry: List["_Metric"] = []


def _tag_key(tags: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((tags or {}).items()))


class _Metric:
    kind = "base"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Tuple[str, ...] = ()):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}
        self._values: Dict[Tuple, float] = defaultdict(float)
        self._lock = threading.Lock()
        with _registry_lock:
            # re-creating a metric aliases the existing storage, as the
            # reference does; histograms only with the same boundaries
            for existing in _registry:
                if (existing.name == name and existing.kind == self.kind
                        and getattr(existing, "boundaries", None)
                        == getattr(self, "boundaries", None)):
                    self._values = existing._values
                    self._lock = existing._lock
                    break
            else:
                _registry.append(self)

    def set_default_tags(self, tags: Dict[str, str]) -> "_Metric":
        self._default_tags = dict(tags)
        return self

    def _merged(self, tags: Optional[Dict[str, str]]) -> Dict[str, str]:
        merged = dict(self._default_tags)
        merged.update(tags or {})
        return merged

    def _snapshot(self) -> List[Tuple[Tuple, float]]:
        with self._lock:
            return list(self._values.items())


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        if value < 0:
            raise ValueError("Counter can only increase")
        with self._lock:
            self._values[_tag_key(self._merged(tags))] += value


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._values[_tag_key(self._merged(tags))] = value


class Histogram(_Metric):
    """Bucketed observations: per-bucket counts (``le``) plus sum/count."""

    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[List[float]] = None,
                 tag_keys: Tuple[str, ...] = ()):
        # set before registration so the dedupe can compare layouts
        self.boundaries = sorted(boundaries or
                                 [0.001, 0.01, 0.1, 1, 10, 100, 1000])
        super().__init__(name, description, tag_keys)

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        merged = self._merged(tags)
        with self._lock:
            for bound in self.boundaries:
                if value <= bound:
                    self._values[_tag_key({**merged, "le": str(bound)})] += 1
            for stat in (("le", "+Inf"), ("__stat__", "count")):
                self._values[_tag_key({**merged, stat[0]: stat[1]})] += 1
            self._values[_tag_key({**merged, "__stat__": "sum"})] += value


def snapshot_local(prefix: str = "") -> Dict[str, float]:
    """Current values of every metric registered in this process:
    ``{"name" | "name{k=v,...}": value}``, the reference's keys."""
    with _registry_lock:
        metrics = list(_registry)
    out: Dict[str, float] = {}
    for metric in metrics:
        if prefix and not metric.name.startswith(prefix):
            continue
        for key, value in metric._snapshot():
            name = metric.name if not key else metric.name + "{" + ",".join(
                f"{k}={v}" for k, v in key) + "}"
            out[name] = out.get(name, 0.0) + value
    return out
