"""APPO: asynchronous PPO (counterpart of ``ray_tpu/rllib/appo.py``) —
IMPALA's actor-learner loop and V-trace with PPO's clipped surrogate
(``clip_param > 0``); see impala.py for the update."""

from __future__ import annotations

from dataclasses import dataclass

from .._private.device import DeviceLike
from .impala import IMPALA, IMPALAConfig

__all__ = ["APPO", "APPOConfig"]


@dataclass
class APPOConfig(IMPALAConfig):
    clip_param: float = 0.3
    lr: float = 5e-4

    def build(self, device: DeviceLike = None) -> "APPO":
        return APPO(self, device=device)


class APPO(IMPALA):
    """IMPALA's train loop with the clipped update."""
