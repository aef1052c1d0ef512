"""IMPALA: V-trace off-policy correction (counterpart of
``ray_tpu/rllib/impala.py``; Espeholt et al. 2018 defines the v-trace
targets used here).

One ``sample()`` stays in flight on every runner, and fragments are taken
in the order the hooks' ``wait`` reports them (``runners.RunnerHooks``).
Each fragment updates the learner at once; only the runner just drained
gets the new weights, and it is relaunched. With ``ray_tpu``'s functions
as the hooks the runners are actors and a slow one never holds back a
fast one, as in the reference. With the default hooks the runners are
held in this process: a launch samples at once and ``wait`` reports the
launches in order, so the runners are drained in turn, each sampling with
the weights it got when it was last drained.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .._private.device import DeviceLike, resolve_device
from ..train.optim import adamw
from .checkpoint import (CheckpointableAlgorithm, broadcast_suppressed,
                         host_copy, on_device)
from .env import make_env
from .runners import (BROADCAST_TIMEOUT_S, LOCAL, REFRESH_TIMEOUT_S,
                      SAMPLE_TIMEOUT_S, RunnerHooks)
from .ppo import (EnvRunner, adam_step, batch_to, init_policy, log_probs,
                  policy_forward)


def vtrace(deltas, coefs):
    """vs - V by the reverse recursion acc_t = delta_t + coef_t acc_{t+1},
    acc_T = 0 (coef_t = gamma (1 - done_t) c_t), a loop over the
    fragment as the reference's reverse ``lax.scan``."""
    acc = torch.zeros((), dtype=deltas.dtype, device=deltas.device)
    out = [None] * len(deltas)
    for t in range(len(deltas) - 1, -1, -1):
        acc = deltas[t] + coefs[t] * acc
        out[t] = acc
    return torch.stack(out)


def _impala_loss(params, batch, gamma, vf_coef, ent_coef, rho_bar, c_bar,
                 clip_param):
    logits, values = policy_forward(params, batch["obs"])
    logp_all, logp = log_probs(logits, batch["actions"])
    # importance ratios against the behaviour policy that sampled
    rhos = torch.exp(logp - batch["logp"])
    nonterminal = 1.0 - batch["dones"]
    with torch.no_grad():
        # every target is held fixed (the reference's stop_gradient)
        clipped_rho = torch.clamp(rhos, max=rho_bar)
        clipped_c = torch.clamp(rhos, max=c_bar)
        v = values.detach()
        v_next = torch.cat([v[1:], batch["bootstrap_value"][None]])
        deltas = clipped_rho * (batch["rewards"] + gamma * nonterminal
                                * v_next - v)
        vs = v + vtrace(deltas, gamma * nonterminal * clipped_c)
        vs_next = torch.cat([vs[1:], v_next[-1:]])
        adv = clipped_rho * (batch["rewards"] + gamma * nonterminal
                             * vs_next - v)
    if clip_param > 0.0:
        # APPO: PPO's clipped surrogate on the v-trace advantages
        surr = torch.minimum(
            rhos * adv,
            torch.clamp(rhos, 1.0 - clip_param, 1.0 + clip_param) * adv)
        pi_loss = -surr.mean()
    else:
        pi_loss = -(adv * logp).mean()
    vf_loss = (values - vs).square().mean()
    entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
    total = pi_loss + vf_coef * vf_loss - ent_coef * entropy
    return total, (pi_loss, vf_loss, entropy, rhos.mean())


def impala_update(params, opt_state, batch, lr, *, gamma: float,
                  vf_coef: float, ent_coef: float, rho_bar: float,
                  c_bar: float, clip_param: float = 0.0):
    """One V-trace policy-gradient step on one fragment, in place.
    Returns (params, opt_state, metrics as 0-d tensors)."""
    loss, aux = _impala_loss(params, batch, gamma, vf_coef, ent_coef,
                             rho_bar, c_bar, clip_param)
    adam_step(params, opt_state, loss, lr)
    return params, opt_state, {
        "total_loss": loss.detach(), "policy_loss": aux[0].detach(),
        "vf_loss": aux[1].detach(), "entropy": aux[2].detach(),
        "mean_rho": aux[3].detach()}


@dataclass
class IMPALAConfig:
    env: Any = "CartPole-v1"
    num_env_runners: int = 2
    rollout_fragment_length: int = 256
    lr: float = 6e-4
    gamma: float = 0.99
    vf_loss_coeff: float = 0.5
    entropy_coeff: float = 0.01
    vtrace_rho_clip: float = 1.0
    vtrace_c_clip: float = 1.0
    # fragments one train() call consumes, each one update
    fragments_per_iter: int = 4
    hidden: Tuple[int, ...] = (64, 64)
    seed: int = 0
    # 0 = the v-trace policy gradient (IMPALA); > 0 = PPO's clipped
    # surrogate on the v-trace advantages (APPO)
    clip_param: float = 0.0

    def environment(self, env) -> "IMPALAConfig":
        self.env = env
        return self

    def env_runners(self, *, num_env_runners: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None
                    ) -> "IMPALAConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kwargs) -> "IMPALAConfig":
        for key, val in kwargs.items():
            if not hasattr(self, key):
                raise ValueError(f"unknown training option {key!r}")
            setattr(self, key, val)
        return self

    def build(self, device: DeviceLike = None,
              hooks: Optional[RunnerHooks] = None) -> "IMPALA":
        return IMPALA(self, device=device, hooks=hooks)


class IMPALA(CheckpointableAlgorithm):
    """Actor-learner: one sample in flight on every runner; fragments taken
    in completion order, each updating the learner and refreshing only its
    runner's weights."""

    def __init__(self, config: IMPALAConfig, device: DeviceLike = None,
                 hooks: Optional[RunnerHooks] = None):
        self.config = config
        self.device = resolve_device(device)
        self.hooks = hooks or LOCAL
        probe = make_env(config.env, seed=0)
        self.obs_dim = probe.observation_dim
        self.act_dim = probe.action_dim
        self.params = on_device(init_policy(
            torch.Generator().manual_seed(config.seed), self.obs_dim,
            self.act_dim, config.hidden), self.device, grad=True)
        self.opt_state = adamw(config.lr, weight_decay=0.0).init(self.params)
        self.iteration = 0
        self.runners = self.hooks.place(
            EnvRunner, config.env, config.hidden,
            [config.seed + 100 + i for i in range(config.num_env_runners)])
        self._inflight: Dict[Any, Any] = {}  # ref -> runner
        if not broadcast_suppressed():
            self._broadcast()

    def _broadcast(self) -> None:
        self.hooks.call_all(self.runners, "set_params",
                            host_copy(self.params),
                            timeout=BROADCAST_TIMEOUT_S)

    def _launch(self, runner) -> None:
        ref = runner.sample.remote(self.config.rollout_fragment_length)
        self._inflight[ref] = runner

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        for runner in self.runners:
            if not any(r is runner for r in self._inflight.values()):
                self._launch(runner)
        losses: Dict[str, Any] = {}
        ep_returns: list = []
        for _ in range(cfg.fragments_per_iter):
            ready, _ = self.hooks.wait(list(self._inflight), num_returns=1,
                                       timeout=SAMPLE_TIMEOUT_S)
            if not ready:
                raise TimeoutError(
                    f"no fragment arrived within {SAMPLE_TIMEOUT_S} s")
            runner = self._inflight.pop(ready[0])
            frag = self.hooks.get(ready[0], timeout=SAMPLE_TIMEOUT_S)
            batch = batch_to({k: frag[k] for k in (
                "obs", "actions", "rewards", "dones", "logp",
                "bootstrap_value")}, self.device)
            self.params, self.opt_state, losses = impala_update(
                self.params, self.opt_state, batch, cfg.lr,
                gamma=cfg.gamma, vf_coef=cfg.vf_loss_coeff,
                ent_coef=cfg.entropy_coeff,
                rho_bar=cfg.vtrace_rho_clip, c_bar=cfg.vtrace_c_clip,
                clip_param=cfg.clip_param)
            ep_returns.extend(frag["episode_returns"].tolist())
            # fresh weights to the runner just drained, then relaunch it
            self.hooks.get(runner.set_params.remote(host_copy(self.params)),
                           timeout=REFRESH_TIMEOUT_S)
            self._launch(runner)
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "episode_reward_mean": (float(np.mean(ep_returns))
                                    if ep_returns else float("nan")),
            "episodes_this_iter": len(ep_returns),
            "timesteps_this_iter": (cfg.fragments_per_iter
                                    * cfg.rollout_fragment_length),
            **{k: float(v) for k, v in losses.items()},
        }

    def stop(self) -> None:
        self.hooks.stop(self.runners)
        self.runners = []
        self._inflight.clear()
