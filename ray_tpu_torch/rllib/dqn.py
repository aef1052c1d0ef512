"""DQN in PyTorch (counterpart of ``ray_tpu/rllib/dqn.py``):
epsilon-greedy env runners feed a replay buffer; the learner's double-DQN
TD update, AdamW (optax's adam) and the periodic target sync run on the
algorithm's device (the card unless ``device="cpu"``). The runners act
on the CPU from host copies of the weights, where the ``hooks`` place
them (``runners.RunnerHooks``; default: in this process).

    algo = (DQNConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2)
            .training(lr=1e-3, train_batch_size=64)).build()
    for _ in range(20):
        metrics = algo.train()

The target network is a copy of the params (``clone``): the reference's
``jax.tree.map(lambda a: a, params)`` shares immutable buffers, but the
port updates in place, so a shared tensor would move the target too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._private.device import DeviceLike, resolve_device
from .._private.tree import tree_map
from ..train.optim import adamw
from .checkpoint import (CheckpointableAlgorithm, broadcast_suppressed,
                         host_copy, on_device, to_numpy)
from .env import make_env
from .runners import (BROADCAST_TIMEOUT_S, LOCAL, SAMPLE_TIMEOUT_S,
                      RunnerHooks)
from .ppo import adam_step, batch_to, init_policy  # the pi head is Q


def q_forward(params, obs):
    """Q-values per action: the MLP's 'pi' head read as Q(s, .)."""
    x = obs
    for layer in params["layers"]:
        x = torch.tanh(x @ layer["w"] + layer["b"])
    return x @ params["pi"]["w"] + params["pi"]["b"]


class ReplayBuffer:
    """Uniform ring replay (numpy, as the reference's).

    ``act_shape``/``act_dtype`` cover both action spaces: DQN stores
    scalar int32 actions, SAC stores float32 vectors."""

    def __init__(self, capacity: int, obs_dim: int,
                 act_shape: tuple = (), act_dtype=np.int32):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.actions = np.zeros((capacity, *act_shape), act_dtype)
        self.rewards = np.zeros(capacity, np.float32)
        self.dones = np.zeros(capacity, np.float32)
        self.size = 0
        self._next = 0

    def add_batch(self, frag: Dict[str, np.ndarray]) -> None:
        n = len(frag["actions"])
        for i in range(n):
            j = self._next
            self.obs[j] = frag["obs"][i]
            self.next_obs[j] = frag["next_obs"][i]
            self.actions[j] = frag["actions"][i]
            self.rewards[j] = frag["rewards"][i]
            self.dones[j] = frag["dones"][i]
            self._next = (self._next + 1) % self.capacity
            self.size = min(self.size + 1, self.capacity)

    def sample(self, rng: np.random.Generator, batch: int):
        idx = rng.integers(0, self.size, batch)
        return {"obs": self.obs[idx], "next_obs": self.next_obs[idx],
                "actions": self.actions[idx], "rewards": self.rewards[idx],
                "dones": self.dones[idx]}


class DQNEnvRunner:
    """Epsilon-greedy sampling worker (placed by the algorithm's hooks)."""

    def __init__(self, env_spec, hidden: Tuple[int, ...], seed: int):
        self.env = make_env(env_spec, seed=seed)
        self.rng = np.random.default_rng(seed)
        self._params = None
        self._obs, _ = self.env.reset(seed=seed)
        self._episode_return = 0.0
        self._completed: List[float] = []

    def set_params(self, params) -> bool:
        self._params = params
        return True

    def sample(self, num_steps: int,
               epsilon: float) -> Dict[str, np.ndarray]:
        obs_dim = len(self._obs)
        out = {k: np.zeros((num_steps, obs_dim), np.float32)
               for k in ("obs", "next_obs")}
        out["actions"] = np.zeros(num_steps, np.int32)
        out["rewards"] = np.zeros(num_steps, np.float32)
        out["dones"] = np.zeros(num_steps, np.float32)
        for t in range(num_steps):
            if self.rng.random() < epsilon:
                action = int(self.rng.integers(self.env.action_dim))
            else:
                with torch.no_grad():
                    q = q_forward(self._params,
                                  torch.from_numpy(self._obs[None, :]))
                action = int(q[0].argmax())
            nxt, reward, terminated, truncated, _ = self.env.step(action)
            done = terminated or truncated
            out["obs"][t] = self._obs
            out["next_obs"][t] = nxt
            out["actions"][t] = action
            out["rewards"][t] = reward
            out["dones"][t] = float(terminated)  # truncation bootstraps
            self._episode_return += reward
            if done:
                self._completed.append(self._episode_return)
                self._episode_return = 0.0
                nxt, _ = self.env.reset()
            self._obs = nxt
        completed, self._completed = self._completed, []
        out["episode_returns"] = np.asarray(completed, np.float32)
        return out


def _dqn_loss(params, target_params, batch, sl, gamma):
    q = q_forward(params, batch["obs"][sl])
    q_sel = q.gather(1, batch["actions"][sl].long()[:, None])[:, 0]
    with torch.no_grad():
        # double DQN: the online net picks the argmax, the target net
        # scores it
        best = q_forward(params, batch["next_obs"][sl]).argmax(dim=1)
        q_next = q_forward(target_params, batch["next_obs"][sl])
        q_best = q_next.gather(1, best[:, None])[:, 0]
        target = (batch["rewards"][sl]
                  + gamma * (1.0 - batch["dones"][sl]) * q_best)
    td = q_sel - target
    return td.square().mean(), td.abs().mean()


def dqn_update(params, target_params, opt_state, batch, lr, *,
               gamma: float, n_updates: int):
    """``n_updates`` double-DQN steps in place, step i on the batch's i-th
    slice of N // n_updates rows. Returns (params, opt_state, metrics as
    0-d tensors, means over the steps)."""
    N = batch["obs"].shape[0]
    mb = N // n_updates
    losses, tds = [], []
    for i in range(n_updates):
        sl = slice(i * mb, (i + 1) * mb)
        loss, td_abs = _dqn_loss(params, target_params, batch, sl, gamma)
        adam_step(params, opt_state, loss, lr)
        losses.append(loss.detach())
        tds.append(td_abs.detach())
    return params, opt_state, {"td_loss": torch.stack(losses).mean(),
                               "td_abs": torch.stack(tds).mean()}


@dataclass
class DQNConfig:
    env: Any = "CartPole-v1"
    num_env_runners: int = 1
    rollout_fragment_length: int = 128
    train_batch_size: int = 64
    lr: float = 1e-3
    gamma: float = 0.99
    hidden: Tuple[int, ...] = (64, 64)
    buffer_capacity: int = 50_000
    learning_starts: int = 500
    updates_per_iter: int = 8
    target_update_interval: int = 4      # iterations between target syncs
    epsilon_initial: float = 1.0
    epsilon_final: float = 0.05
    epsilon_decay_iters: int = 30
    seed: int = 0

    def environment(self, env) -> "DQNConfig":
        self.env = env
        return self

    def env_runners(self, *, num_env_runners: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None
                    ) -> "DQNConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kwargs) -> "DQNConfig":
        for key, val in kwargs.items():
            if not hasattr(self, key):
                raise ValueError(f"unknown training option {key!r}")
            setattr(self, key, val)
        return self

    def build(self, device: DeviceLike = None,
              hooks: Optional[RunnerHooks] = None) -> "DQN":
        return DQN(self, device=device, hooks=hooks)


def _copy(params):
    return tree_map(lambda t: t.detach().clone(), params)


class DQN(CheckpointableAlgorithm):
    """Sample -> replay add -> minibatch updates -> periodic target sync
    -> broadcast."""

    def __init__(self, config: DQNConfig, device: DeviceLike = None,
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
        self.target_params = _copy(self.params)
        self.opt_state = adamw(config.lr, weight_decay=0.0).init(self.params)
        self.buffer = ReplayBuffer(config.buffer_capacity, self.obs_dim)
        self.np_rng = np.random.default_rng(config.seed)
        self.iteration = 0
        self.runners = self.hooks.place(
            DQNEnvRunner, config.env, config.hidden,
            [config.seed + 200 + i for i in range(config.num_env_runners)])
        if not broadcast_suppressed():  # from_checkpoint restores first
            self._broadcast()

    def _extra_state(self):
        # the replay buffer is left out (sampling refills it); the target
        # net is learner state
        return {"target_params": to_numpy(self.target_params)}

    def _apply_extra_state(self, state):
        if "target_params" in state:
            self.target_params = on_device(state["target_params"],
                                           self.device)

    def _broadcast(self) -> None:
        self.hooks.call_all(self.runners, "set_params",
                            host_copy(self.params),
                            timeout=BROADCAST_TIMEOUT_S)

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self.iteration / max(1, cfg.epsilon_decay_iters))
        return cfg.epsilon_initial + frac * (cfg.epsilon_final
                                             - cfg.epsilon_initial)

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        eps = self._epsilon()
        frags = self.hooks.call_all(self.runners, "sample",
                                    cfg.rollout_fragment_length, eps,
                                    timeout=SAMPLE_TIMEOUT_S)
        ep_returns: List[float] = []
        for frag in frags:
            ep_returns.extend(frag.pop("episode_returns").tolist())
            self.buffer.add_batch(frag)

        losses = {"td_loss": float("nan"), "td_abs": float("nan")}
        if self.buffer.size >= max(cfg.learning_starts,
                                   cfg.train_batch_size):
            batch = batch_to(self.buffer.sample(
                self.np_rng, cfg.train_batch_size * cfg.updates_per_iter),
                self.device)
            self.params, self.opt_state, metrics = dqn_update(
                self.params, self.target_params, self.opt_state, batch,
                cfg.lr, gamma=cfg.gamma, n_updates=cfg.updates_per_iter)
            losses = {k: float(v) for k, v in metrics.items()}
            if self.iteration % cfg.target_update_interval == 0:
                self.target_params = _copy(self.params)
            self._broadcast()

        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "epsilon": eps,
            "buffer_size": self.buffer.size,
            "episode_reward_mean": (float(np.mean(ep_returns))
                                    if ep_returns else float("nan")),
            "episodes_this_iter": len(ep_returns),
            **losses,
        }

    def stop(self) -> None:
        self.hooks.stop(self.runners)
        self.runners = []
