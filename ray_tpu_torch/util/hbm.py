"""Per-card memory accounting (counterpart of ``ray_tpu/util/hbm.py``),
read from PyTorch's caching allocator.

``bytes_in_use`` and its peak are the allocator's live bytes
(``allocated_bytes.all.{current,peak}``), the counterpart of PJRT's
live-buffer view; memory the allocator holds in its cache is not in use.
``bytes_limit`` is the card's total memory. The largest free block is the
larger of the card's free memory and the largest free block in the
allocator's cache.

Reading stats never initializes CUDA, and it touches no card this
process has not used: the stats cover the cards on which the caching
allocator has reserved memory, so that asking a card with no context for
its free memory does not open one there. With no card, or before this
process has used one, :func:`collect_hbm_stats` returns ``[]``, as the
reference does on its CPU backend. :func:`publish_hbm_gauges` sets the
reference's four ``hbm_*`` gauges from them through the port's
``util/metrics.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from . import metrics

# gauge name, stats key, description (the reference's hbm_* family)
_GAUGES = (
    ("hbm_bytes_in_use", "bytes_in_use", "live HBM buffer bytes per chip"),
    ("hbm_bytes_limit", "bytes_limit", "HBM capacity per chip"),
    ("hbm_peak_bytes_in_use", "peak_bytes_in_use",
     "peak live HBM bytes per chip"),
    ("hbm_fragmentation", "fragmentation",
     "fraction of free HBM not in the largest free block"),
)


def stats_from_torch(memory_stats: Dict[str, int], free: int, total: int,
                     largest_cached_free: int) -> Dict[str, int]:
    """The reference's ``memory_stats()`` keys from
    ``torch.cuda.memory_stats``, ``torch.cuda.mem_get_info`` (free, total)
    and the largest free block in the allocator's cache."""
    return {"bytes_in_use": int(memory_stats.get("allocated_bytes.all.current",
                                                 0)),
            "peak_bytes_in_use": int(memory_stats.get(
                "allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total),
            "largest_free_block_bytes": int(max(free, largest_cached_free))}


class CudaDevice:
    """One card as the reference's ``devices`` entries look: ``id``,
    ``platform`` and ``memory_stats()``."""

    platform = "gpu"

    def __init__(self, index: int):
        self.id = index

    def memory_stats(self) -> Dict[str, int]:
        cached_free = [b["size"] for seg in torch.cuda.memory_snapshot()
                       if seg["device"] == self.id for b in seg["blocks"]
                       if b["state"] == "inactive"]
        free, total = torch.cuda.mem_get_info(self.id)
        return stats_from_torch(torch.cuda.memory_stats(self.id), free,
                                total, max(cached_free, default=0))


def used_cards() -> List[int]:
    """The cards on which this process's caching allocator has reserved
    memory (and so holds a context); none before CUDA is initialized."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return []
    return [i for i in range(torch.cuda.device_count())
            if torch.cuda.memory_stats(i).get("reserved_bytes.all.peak", 0)]


def collect_hbm_stats(devices: Optional[list] = None) -> List[dict]:
    """Per-device live-buffer stats: ``[{device, platform, bytes_in_use,
    bytes_limit, peak_bytes_in_use, fragmentation}, ...]`` for the cards
    this process has used (:func:`used_cards`). Empty when there is no
    card or CUDA is not initialized in this process. ``devices`` is the
    test injection point: objects exposing ``memory_stats()`` /
    ``platform`` / ``id`` duck-type fine."""
    if devices is None:
        devices = [CudaDevice(i) for i in used_cards()]
    out: List[dict] = []
    for dev in devices:
        try:
            stats = dev.memory_stats()
        except Exception:
            stats = None
        if not stats:
            continue
        in_use = int(stats.get("bytes_in_use", 0))
        limit = int(stats.get("bytes_limit", 0) or 0)
        peak = int(stats.get("peak_bytes_in_use", in_use))
        # fragmentation: fraction of FREE memory not usable as one
        # contiguous block (0 when the allocator doesn't report it)
        free = max(0, limit - in_use)
        largest = int(stats.get("largest_free_block_bytes", free) or 0)
        frag = (1.0 - largest / free) if free > 0 else 0.0
        out.append({
            "device": str(getattr(dev, "id", len(out))),
            "platform": str(getattr(dev, "platform", "?")),
            "bytes_in_use": in_use,
            "bytes_limit": limit,
            "peak_bytes_in_use": peak,
            "fragmentation": max(0.0, min(1.0, frag)),
        })
    return out


def publish_hbm_gauges(node: str = "",
                       devices: Optional[list] = None) -> List[dict]:
    """Set the hbm_* gauge family from the current allocator state and
    return the collected stats. Tags carry the node and the device ordinal
    so that an aggregate stays per card."""
    stats = collect_hbm_stats(devices)
    for st in stats:
        tags = {"node": node, "device": st["device"],
                "platform": st["platform"]}
        for name, key, desc in _GAUGES:
            # re-creating a gauge aliases the registered series
            metrics.Gauge(name, desc).set(st[key], tags=tags)
    return stats
