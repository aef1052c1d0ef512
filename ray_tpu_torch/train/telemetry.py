"""The pieces of ``ray_tpu/train/telemetry.py`` the port's train step needs:
the flops estimate, the compile classifier and the step instrumenter.

They are stdlib-only and clock-injectable, as in the reference; the port
keeps its own copies. The step timelines and the goodput ledger stay in
the host plane (``ray_tpu.train``), whose session the instrumented step
reports to (``make_train_step(session=...)``)."""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional


def estimate_flops_per_token(n_params: int) -> float:
    """Standard training-flops estimate: ~6 flops per parameter per
    token (fwd 2 + bwd 4; Kaplan et al. accounting)."""
    return 6.0 * float(n_params)


def classify_compile(duration_s: float, wrote_cache_entries: int,
                     hit_threshold_s: float = 0.5) -> str:
    """Cold compile vs cache hit for a first call per batch signature.

    A first call that wrote new entries into the cache did real compile
    work: "cold". With no new entries the duration decides: a load from
    the cache is well under the threshold, and a fast first call that
    wrote nothing is as cheap as one, so calling it a hit costs the
    ledger nothing."""
    if wrote_cache_entries > 0:
        return "cold"
    return "cache_hit" if duration_s < hit_threshold_s else "cold"


class StepInstrumenter:
    """Compile/compute attribution for a step callable.

    The first call per batch signature is a compile (cold vs cache hit by
    :func:`classify_compile` on the cache's entry count before and after,
    and the duration); later calls with a known signature are compute. A
    new signature after the first is a recompile."""

    def __init__(self, clock: Callable[[], float] = time.time,
                 cache_entries: Callable[[], int] = lambda: 0,
                 hit_threshold_s: float = 0.5,
                 on_recompile: Optional[Callable[[str, str], None]] = None):
        self._clock = clock
        self._cache_entries = cache_entries
        self._hit_threshold_s = hit_threshold_s
        self._on_recompile = on_recompile
        self._seen: Dict[str, bool] = {}
        self._last_sig: Optional[str] = None
        self.last: Dict[str, Any] = {}

    def run(self, fn: Callable[[], Any], signature: str,
            block: Callable[[Any], Any] = lambda r: r) -> Any:
        new = signature not in self._seen
        recompile = new and bool(self._seen)
        before = self._cache_entries() if new else 0
        t0 = self._clock()
        out = block(fn())
        t1 = self._clock()
        if new:
            wrote = max(0, self._cache_entries() - before)
            kind = classify_compile(t1 - t0, wrote, self._hit_threshold_s)
            phase = "compile"
            self._seen[signature] = True
            if recompile and self._on_recompile is not None:
                self._on_recompile(self._last_sig or "", signature)
        else:
            kind, phase = "", "compute"
        self.last = {"phase": phase, "t0": t0, "t1": t1,
                     "compile_kind": kind, "recompile": recompile,
                     "signature": signature}
        self._last_sig = signature
        return out
