"""Offline RL: rollout recording and reading, BC and MARWIL (counterpart
of ``ray_tpu/rllib/offline.py``).

  * BC — behaviour cloning: maximise log pi(a|s) over the dataset.
  * MARWIL — advantage-weighted BC (Wang et al. 2018): a value baseline
    is regressed on Monte-Carlo returns and the imitation term is
    weighted exp(beta * normalised advantage). beta=0 is exactly BC.

The dataset is npz shards, read whole by :func:`read_rollouts`, or handed
as step rows to a Dataset constructor of the caller's by
:func:`rollout_dataset` (``ray_tpu.data.from_items`` gives the
reference's Dataset). The learner runs on the algorithm's device (the
card unless ``device="cpu"``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from .._private.device import DeviceLike, resolve_device
from ..train.optim import adamw
from .checkpoint import CheckpointableAlgorithm, host_copy, on_device
from .env import make_env
from .ppo import adam_step, batch_to, init_policy, log_probs, policy_forward

__all__ = ["record_rollouts", "read_rollouts", "rollout_dataset", "BC", "BCConfig", "MARWIL",
           "MARWILConfig"]


def record_rollouts(env_spec: Any, path: str, *, num_steps: int,
                    policy_params=None, hidden=(64, 64), seed: int = 0,
                    shard_steps: int = 4096) -> List[str]:
    """Roll a policy (``policy_params``, a tree of tensors, acted on the
    CPU; random when None) and write npz shards. Returns their paths."""
    env = make_env(env_spec, seed=seed)
    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)
    host = None if policy_params is None else host_copy(policy_params)
    obs, _ = env.reset(seed=seed)
    shards: List[str] = []
    buf: Dict[str, list] = {k: [] for k in
                            ("obs", "actions", "rewards", "dones")}

    def flush():
        if not buf["obs"]:
            return
        shard_path = os.path.join(path, f"shard_{len(shards):05d}.npz")
        np.savez(shard_path,
                 obs=np.asarray(buf["obs"], np.float32),
                 actions=np.asarray(buf["actions"], np.int32),
                 rewards=np.asarray(buf["rewards"], np.float32),
                 dones=np.asarray(buf["dones"], np.float32))
        shards.append(shard_path)
        for v in buf.values():
            v.clear()

    for _ in range(num_steps):
        if host is None:
            action = int(rng.integers(env.action_dim))
        else:
            with torch.no_grad():
                logits, _ = policy_forward(host, torch.from_numpy(
                    obs[None, :]))
            logits = logits.numpy()[0].astype(np.float64)
            probs = np.exp(logits - logits.max())
            probs /= probs.sum()
            action = int(rng.choice(len(probs), p=probs))
        nxt, reward, terminated, truncated, _ = env.step(action)
        buf["obs"].append(obs)
        buf["actions"].append(action)
        buf["rewards"].append(reward)
        buf["dones"].append(float(terminated or truncated))
        obs = nxt
        if terminated or truncated:
            obs, _ = env.reset()
        if len(buf["obs"]) >= shard_steps:
            flush()
    flush()
    return shards


def read_rollouts(path: str) -> Dict[str, np.ndarray]:
    """All shards under ``path``, concatenated."""
    shards = sorted(
        os.path.join(path, f) for f in os.listdir(path)
        if f.endswith(".npz"))
    if not shards:
        raise FileNotFoundError(f"no .npz rollout shards under {path}")
    parts = [np.load(s) for s in shards]
    return {k: np.concatenate([p[k] for p in parts])
            for k in ("obs", "actions", "rewards", "dones")}


def rollout_dataset(path: str, from_items: Callable[[List[dict]], Any]):
    """The shards under ``path`` as ``from_items(rows)``: one dict a step
    with the keys obs, actions, rewards and dones, each value that step's
    numpy row or scalar (float32, int32, float32, float32), the list the
    reference's ``rollout_dataset`` hands ``ray_tpu.data.from_items``."""
    rows = read_rollouts(path)
    n = len(rows["actions"])
    return from_items([{k: rows[k][i] for k in rows} for i in range(n)])


def _mc_returns(rewards: np.ndarray, dones: np.ndarray,
                gamma: float) -> np.ndarray:
    """Monte-Carlo return-to-go per step, cut at episode bounds."""
    out = np.zeros_like(rewards)
    acc = 0.0
    for t in range(len(rewards) - 1, -1, -1):
        acc = rewards[t] + gamma * acc * (1.0 - dones[t])
        out[t] = acc
    return out


def _marwil_loss(params, batch, beta, vf_coef):
    logits, values = policy_forward(params, batch["obs"])
    _, logp = log_probs(logits, batch["actions"])
    adv = batch["returns"] - values.detach()
    if beta > 0.0:
        norm = torch.sqrt(adv.square().mean() + 1e-8)
        weight = torch.exp(torch.clamp(beta * adv / norm, -5.0, 5.0))
    else:
        weight = torch.ones_like(adv)  # pure BC
    imitation = -(weight * logp).mean()
    vf_loss = (values - batch["returns"]).square().mean()
    total = imitation + vf_coef * vf_loss
    return total, (imitation, vf_loss, logp.mean())


def _marwil_update(params, opt_state, batch, lr, *, beta: float,
                   vf_coef: float):
    """One MARWIL (BC at beta=0) step in place. Returns (params,
    opt_state, metrics as 0-d tensors)."""
    loss, aux = _marwil_loss(params, batch, beta, vf_coef)
    adam_step(params, opt_state, loss, lr)
    return params, opt_state, {
        "total_loss": loss.detach(), "imitation_loss": aux[0].detach(),
        "vf_loss": aux[1].detach(), "mean_logp": aux[2].detach()}


@dataclass
class MARWILConfig:
    env: Any = "CartPole-v1"          # for obs/act dims + eval
    input_path: str = ""              # rollout shard directory
    beta: float = 1.0                 # 0.0 == behavior cloning
    lr: float = 1e-3
    gamma: float = 0.99
    vf_loss_coeff: float = 1.0
    train_batch_size: int = 512
    hidden: Tuple[int, ...] = (64, 64)
    seed: int = 0

    def environment(self, env) -> "MARWILConfig":
        self.env = env
        return self

    def offline_data(self, input_path: str) -> "MARWILConfig":
        self.input_path = input_path
        return self

    def training(self, **kwargs) -> "MARWILConfig":
        for key, val in kwargs.items():
            if not hasattr(self, key):
                raise ValueError(f"unknown training option {key!r}")
            setattr(self, key, val)
        return self

    def build(self, device: DeviceLike = None) -> "MARWIL":
        return MARWIL(self, device=device)


class MARWIL(CheckpointableAlgorithm):
    def __init__(self, config: MARWILConfig, device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)
        probe = make_env(config.env, seed=0)
        self.obs_dim = probe.observation_dim
        self.act_dim = probe.action_dim
        self.params = on_device(init_policy(
            torch.Generator().manual_seed(config.seed), self.obs_dim,
            self.act_dim, config.hidden), self.device, grad=True)
        self.opt_state = adamw(config.lr, weight_decay=0.0).init(self.params)
        self.iteration = 0
        rows = read_rollouts(config.input_path)
        self._data = {
            "obs": rows["obs"],
            "actions": rows["actions"],
            "returns": _mc_returns(rows["rewards"], rows["dones"],
                                   config.gamma),
        }
        self._rng = np.random.default_rng(config.seed)

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        n = len(self._data["actions"])
        idx = self._rng.integers(0, n, min(cfg.train_batch_size, n))
        batch = batch_to({k: v[idx] for k, v in self._data.items()},
                         self.device)
        self.params, self.opt_state, losses = _marwil_update(
            self.params, self.opt_state, batch, cfg.lr,
            beta=cfg.beta, vf_coef=cfg.vf_loss_coeff)
        self.iteration += 1
        return {"training_iteration": self.iteration,
                "timesteps_this_iter": int(len(idx)),
                **{k: float(v) for k, v in losses.items()}}

    def evaluate(self, episodes: int = 5) -> Dict[str, float]:
        """Greedy rollouts in a live env, acted on the CPU from a host copy
        of the weights."""
        host = host_copy(self.params)
        env = make_env(self.config.env, seed=self.config.seed + 999)
        returns = []
        for ep in range(episodes):
            obs, _ = env.reset(seed=self.config.seed + 1000 + ep)
            total, done = 0.0, False
            while not done:
                with torch.no_grad():
                    logits, _ = policy_forward(host, torch.from_numpy(
                        obs[None, :]))
                action = int(logits[0].argmax())
                obs, reward, terminated, truncated, _ = env.step(action)
                total += reward
                done = terminated or truncated
            returns.append(total)
        return {"episode_reward_mean": float(np.mean(returns)),
                "episodes": episodes}

    def stop(self) -> None:
        pass


@dataclass
class BCConfig(MARWILConfig):
    """Behaviour cloning: MARWIL with beta pinned to 0."""

    beta: float = 0.0

    def build(self, device: DeviceLike = None) -> "BC":
        return BC(self, device=device)


class BC(MARWIL):
    pass
