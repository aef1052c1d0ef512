"""The piece of ``ray_tpu/train/telemetry.py`` the port's trainer needs.

The rest of that module (step timelines, the badput ledger) belongs to
the host plane, which is not ported."""

from __future__ import annotations


def estimate_flops_per_token(n_params: int) -> float:
    """Standard training-flops estimate: ~6 flops per parameter per
    token (fwd 2 + bwd 4; Kaplan et al. accounting)."""
    return 6.0 * float(n_params)
