"""Device utilities of the port: per-card memory stats (``hbm``), the
profiler and the port's one span API (``tracing``) and process-local
metrics (``metrics``)."""

from .hbm import collect_hbm_stats, publish_hbm_gauges
from .tracing import profile, span

__all__ = ["collect_hbm_stats", "profile", "publish_hbm_gauges", "span"]
