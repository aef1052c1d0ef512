"""Training: the train-step factory (one device, or a mesh; reporting to
a training session when given one), AdamW with optax's semantics, and a
gang's process-group bring-up (counterpart of ``ray_tpu/train/step.py``,
of ``telemetry.py``'s step instrumenter and of ``worker_group.py``'s
bring-up)."""

from .optim import AdamState, AdamW, adamw
from .step import TrainState, make_eval_step, make_train_step
from .telemetry import (StepInstrumenter, classify_compile,
                        estimate_flops_per_token)
from .worker_group import init_torch_distributed

__all__ = ["AdamState", "AdamW", "StepInstrumenter", "TrainState", "adamw",
           "classify_compile", "estimate_flops_per_token",
           "init_torch_distributed", "make_eval_step", "make_train_step"]
