"""Device utilities of the port: per-card memory stats (``hbm``) and the
profiler (``tracing``)."""

from .hbm import collect_hbm_stats
from .tracing import profile, span

__all__ = ["collect_hbm_stats", "profile", "span"]
