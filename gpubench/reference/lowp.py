"""The control's lower precision: a weight's round trip through fp8.

FP8 E4M3 (3 mantissa bits, largest finite 448) with one scale for each
output channel (the maximum magnitude over the contracted axis, over 448),
back to float32: weight-only fp8, the step below the configurations'
bfloat16 that would tempt a later change to a mixture's experts on this
card. The reference run with it in place of float32 weights is the
control, which the comparison has to fail.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8_round_trip(w: torch.Tensor, contract: int) -> torch.Tensor:
    s = w.abs().amax(dim=contract, keepdim=True).clamp_min(1e-12) / E4M3_MAX
    return (w / s).to(torch.float8_e4m3fn).to(torch.float32) * s
