"""Training on one device: the train-step factory and AdamW with optax's
semantics (counterpart of ``ray_tpu/train/step.py``)."""

from .optim import AdamState, AdamW, adamw
from .step import TrainState, make_eval_step, make_train_step
from .telemetry import estimate_flops_per_token

__all__ = ["AdamState", "AdamW", "TrainState", "adamw",
           "estimate_flops_per_token", "make_eval_step", "make_train_step"]
