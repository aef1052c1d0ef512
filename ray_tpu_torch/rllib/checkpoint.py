"""Algorithm checkpointing (counterpart of ``ray_tpu/rllib/checkpoint.py``:
save_to_path/restore_from_path/from_checkpoint on an Algorithm), and the
tree helpers the algorithms share.

A checkpoint is one pickle file written atomically: the learner's params
and AdamW moments as numpy trees, the step count, the iteration, the
config and each algorithm's extra state (a target network). It uses the
standard ``pickle``, not ``cloudpickle`` as the reference does: a config
that holds a lambda or a local function as its env factory cannot be
saved and raises a ``ValueError`` that says so; a module-level function
pickles by reference.
"""

from __future__ import annotations

import contextvars
import os
import pickle
from typing import Any, Dict

import torch

from .._private.device import DeviceLike, resolve_device
from .._private.tree import tree_map
from ..train.optim import AdamState

# set while from_checkpoint constructs the algorithm: the constructor's
# first broadcast of random weights would be overwritten at once by the
# restored ones
_RESTORING: contextvars.ContextVar = contextvars.ContextVar(
    "rtpu_torch_rllib_restoring", default=False)


def broadcast_suppressed() -> bool:
    return _RESTORING.get()


def to_numpy(tree):
    """A tree of tensors (dicts and lists kept) -> the same tree of numpy
    arrays, copies (bf16 leaves as f32, exactly)."""
    def leaf(t):
        t = t.detach().to("cpu", copy=True)
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(leaf, tree)


def host_copy(tree):
    """Detached CPU copies of a tree's tensors: the weights an env runner
    acts with (the reference hands its runners numpy params)."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def on_device(tree, device: torch.device, *, grad: bool = False):
    """A tree of tensors or numpy arrays -> fresh tensors on ``device``;
    ``grad`` makes them leaves that require grad (a learner's params)."""
    def leaf(a):
        t = torch.as_tensor(a).detach().to(device, copy=True)
        return t.requires_grad_() if grad else t

    return tree_map(leaf, tree)


class CheckpointableAlgorithm:
    """Mixin: save/restore the learner state (params, AdamW state,
    iteration, extra state). The env runners are rebuilt from the config
    and get the restored weights through the algorithm's broadcast."""

    device: torch.device

    def _extra_state(self) -> Dict[str, Any]:
        return {}

    def _apply_extra_state(self, state: Dict[str, Any]) -> None:
        pass

    def _broadcast(self) -> None:
        pass

    def save_to_path(self, path: str) -> str:
        os.makedirs(path, exist_ok=True)
        state = {
            "params": to_numpy(self.params),
            "opt_state": {"count": self.opt_state.count,
                          "mu": to_numpy(self.opt_state.mu),
                          "nu": to_numpy(self.opt_state.nu)},
            "iteration": self.iteration,
            "config": self.config,
            **self._extra_state(),
        }
        try:
            blob = pickle.dumps(state)
        except (pickle.PicklingError, AttributeError, TypeError) as e:
            raise ValueError(
                "cannot checkpoint: the config holds an object that pickle "
                "cannot save (a lambda or a local function as the env "
                "factory?); use a registered env name or a module-level "
                f"factory function ({e})") from e
        # atomic: a crash mid-write must not destroy the previous
        # checkpoint at the same path
        final = os.path.join(path, "algorithm_state.pkl")
        tmp = final + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, final)
        return path

    def _apply_state(self, state: Dict[str, Any]) -> None:
        self.params = on_device(state["params"], self.device, grad=True)
        opt = state["opt_state"]
        self.opt_state = AdamState(int(opt["count"]),
                                   on_device(opt["mu"], self.device),
                                   on_device(opt["nu"], self.device))
        self.iteration = state["iteration"]
        self._apply_extra_state(state)
        self._broadcast()

    def restore_from_path(self, path: str) -> None:
        with open(os.path.join(path, "algorithm_state.pkl"), "rb") as f:
            state = pickle.load(f)
        self._apply_state(state)

    @classmethod
    def from_checkpoint(cls, path: str, device: DeviceLike = None,
                        hooks=None):
        """Rebuild the algorithm from a saved state's config on ``device``
        (default: the card), its runners placed by ``hooks`` (a
        ``runners.RunnerHooks``; default: in this process), then restore
        it; the constructor's first broadcast is skipped. The runners
        start afresh from their seeds, as the reference's rebuilt runner
        actors do."""
        with open(os.path.join(path, "algorithm_state.pkl"), "rb") as f:
            state = pickle.load(f)
        kwargs = {} if hooks is None else {"hooks": hooks}
        token = _RESTORING.set(True)
        try:
            algo = cls(state["config"], device=resolve_device(device),
                       **kwargs)
        finally:
            _RESTORING.reset(token)
        algo._apply_state(state)
        return algo
