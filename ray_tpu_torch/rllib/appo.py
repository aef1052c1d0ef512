"""APPO: asynchronous PPO (counterpart of ``ray_tpu/rllib/appo.py``) —
IMPALA's actor-learner loop and V-trace with PPO's clipped surrogate
(``clip_param > 0``); see impala.py for the update and for where the
runners run."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .._private.device import DeviceLike
from .impala import IMPALA, IMPALAConfig
from .runners import RunnerHooks

__all__ = ["APPO", "APPOConfig"]


@dataclass
class APPOConfig(IMPALAConfig):
    clip_param: float = 0.3
    lr: float = 5e-4

    def build(self, device: DeviceLike = None,
              hooks: Optional[RunnerHooks] = None) -> "APPO":
        return APPO(self, device=device, hooks=hooks)


class APPO(IMPALA):
    """IMPALA's train loop with the clipped update."""
