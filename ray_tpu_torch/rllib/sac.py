"""SAC in PyTorch (counterpart of ``ray_tpu/rllib/sac.py``): stochastic
env runners feed a replay buffer; the learner update (twin soft Q
critics, a tanh-squashed Gaussian actor, the auto-tuned entropy
temperature, Polyak target tracking of the critics) runs on the
algorithm's device (the card unless ``device="cpu"``).

    algo = (SACConfig().environment("Pendulum-v1")
            .env_runners(num_env_runners=2)
            .training(lr=3e-4)).build()
    for _ in range(20):
        metrics = algo.train()

The reparameterisation noise is drawn by :func:`sac_update` from a
``torch.Generator`` and handed to :func:`sac_update_with_noise`, so that a
caller (a test) can feed any draws, the reference's ``jax.random.normal``
ones included. The target critics are copies (``clone``) updated in
place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._private.device import DeviceLike, resolve_device
from .._private.tree import tree_leaves, tree_map
from ..train.optim import adamw
from .checkpoint import (CheckpointableAlgorithm, broadcast_suppressed,
                         host_copy, on_device, to_numpy)
from .dqn import ReplayBuffer
from .env import make_env
from .runners import (BROADCAST_TIMEOUT_S, LOCAL, SAMPLE_TIMEOUT_S,
                      RunnerHooks)
from .ppo import adam_step, batch_to

_LOG_STD_MIN, _LOG_STD_MAX = -10.0, 2.0


# ---------------------------------------------------------------- networks


def _init_mlp(gen: torch.Generator, sizes):
    return [{"w": torch.randn((n_in, n_out), generator=gen)
             * (2.0 / n_in) ** 0.5,
             "b": torch.zeros(n_out)}
            for n_in, n_out in zip(sizes[:-1], sizes[1:])]


def _mlp(layers, x, *, final_linear: bool = True):
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1 or not final_linear:
            x = torch.tanh(x)
    return x


def init_sac_params(gen: torch.Generator, obs_dim: int, act_dim: int,
                    hidden: Tuple[int, ...]):
    """On the CPU, drawn from ``gen``: actor, then q1, then q2; the values
    differ from JAX's (another generator)."""
    return {
        # the actor emits [mu | log_std]
        "actor": _init_mlp(gen, (obs_dim, *hidden, 2 * act_dim)),
        "q1": _init_mlp(gen, (obs_dim + act_dim, *hidden, 1)),
        "q2": _init_mlp(gen, (obs_dim + act_dim, *hidden, 1)),
        # log alpha, the learnable entropy temperature
        "log_alpha": torch.zeros(()),
    }


def actor_dist(params, obs):
    mu, log_std = _mlp(params["actor"], obs).chunk(2, dim=-1)
    return mu, torch.clamp(log_std, _LOG_STD_MIN, _LOG_STD_MAX)


def sample_action(params, obs, eps):
    """The reparameterised tanh-squashed Gaussian sample for the standard
    normal draws ``eps`` (mu's shape), and its log-prob."""
    mu, log_std = actor_dist(params, obs)
    std = torch.exp(log_std)
    pre = mu + std * eps
    act = torch.tanh(pre)
    # log N(pre; mu, std) less the tanh change of variables
    logp = (-0.5 * (((pre - mu) / std) ** 2
                    + 2 * log_std + math.log(2 * math.pi))).sum(-1)
    logp = logp - (2 * (math.log(2.0) - pre
                        - F.softplus(-2 * pre))).sum(-1)
    return act, logp


def _q(params_q, obs, act):
    return _mlp(params_q, torch.cat([obs, act], dim=-1))[..., 0]


# ---------------------------------------------------------------- learner


def _sac_loss(p, tgt, batch, sl, eps1, eps2, gamma, target_entropy):
    obs, nxt = batch["obs"][sl], batch["next_obs"][sl]
    act = batch["actions"][sl]
    alpha = torch.exp(p["log_alpha"])

    # critic target: the soft Bellman backup through both target critics
    with torch.no_grad():
        nact, nlogp = sample_action(p, nxt, eps1)
        tq = torch.minimum(_q(tgt["q1"], nxt, nact), _q(tgt["q2"], nxt, nact))
        backup = batch["rewards"][sl] + gamma * (
            1.0 - batch["dones"][sl]) * (tq - alpha * nlogp)
    q1 = _q(p["q1"], obs, act)
    q2 = _q(p["q2"], obs, act)
    critic_loss = ((q1 - backup).square() + (q2 - backup).square()).mean()

    # actor: maximise min-Q + entropy, the critics held fixed
    pact, plogp = sample_action(p, obs, eps2)
    fixed = {k: tree_map(torch.detach, p[k]) for k in ("q1", "q2")}
    qpi = torch.minimum(_q(fixed["q1"], obs, pact),
                        _q(fixed["q2"], obs, pact))
    actor_loss = (alpha.detach() * plogp - qpi).mean()

    # temperature: drive the entropy toward target_entropy
    alpha_loss = (-torch.exp(p["log_alpha"])
                  * (plogp + target_entropy).detach()).mean()
    total = critic_loss + actor_loss + alpha_loss
    return total, (critic_loss, actor_loss, alpha, -plogp.mean())


def sac_update_with_noise(params, target, opt_state, batch, noise, *,
                          lr: float, gamma: float, tau: float,
                          target_entropy: float):
    """``len(noise)`` SAC steps in place, step i on the batch's i-th slice
    of N // n rows with ``noise[i] = (eps for the next action, eps for the
    policy's action)``, each [N // n, act_dim]. After each step the target
    critics track the critics (Polyak, ``tau``). Returns (params, target,
    opt_state, metrics as 0-d tensors)."""
    n_updates = len(noise)
    mb = batch["obs"].shape[0] // n_updates
    aux_steps = []
    for i in range(n_updates):
        sl = slice(i * mb, (i + 1) * mb)
        loss, aux = _sac_loss(params, target, batch, sl, noise[i][0],
                              noise[i][1], gamma, target_entropy)
        adam_step(params, opt_state, loss, lr)
        with torch.no_grad():
            for k in ("q1", "q2"):
                for t, o in zip(tree_leaves(target[k]),
                                tree_leaves(params[k])):
                    t.mul_(1 - tau).add_(tau * o)
        aux_steps.append(torch.stack([a.detach() for a in aux]))
    aux = torch.stack(aux_steps)
    return params, target, opt_state, {
        "critic_loss": aux[:, 0].mean(), "actor_loss": aux[:, 1].mean(),
        "alpha": aux[-1, 2], "entropy": aux[:, 3].mean()}


def sac_update(params, target, opt_state, batch, gen: torch.Generator, *,
               lr: float, gamma: float, tau: float, target_entropy: float,
               n_updates: int):
    """``n_updates`` SAC steps, the noise drawn from ``gen`` (a CPU
    generator, so the card and the CPU draw alike)."""
    mb = batch["obs"].shape[0] // n_updates
    act_dim = batch["actions"].shape[-1]
    noise = torch.randn((n_updates, 2, mb, act_dim), generator=gen).to(
        batch["obs"].device)
    return sac_update_with_noise(params, target, opt_state, batch, noise,
                                 lr=lr, gamma=gamma, tau=tau,
                                 target_entropy=target_entropy)


# ---------------------------------------------------------------- sampling


class SACEnvRunner:
    """Stochastic-policy sampling worker over a continuous env (placed
    by the algorithm's hooks); its noise comes from a CPU generator
    seeded with its seed."""

    def __init__(self, env_spec, hidden: Tuple[int, ...], seed: int):
        self.env = make_env(env_spec, seed=seed)
        self.max_torque = getattr(self.env, "MAX_TORQUE", 1.0)
        self.seed = seed
        self._params = None
        self._gen = torch.Generator().manual_seed(seed)
        self._obs, _ = self.env.reset(seed=seed)
        self._episode_return = 0.0
        self._completed: List[float] = []

    def set_params(self, params) -> bool:
        self._params = params
        return True

    def _eps(self, act_dim: int) -> torch.Tensor:
        """One step's reparameterisation noise, [1, act_dim]."""
        return torch.randn((1, act_dim), generator=self._gen)

    def sample(self, num_steps: int) -> Dict[str, np.ndarray]:
        obs_dim = self.env.observation_dim
        act_dim = self.env.action_dim
        out = {"obs": np.zeros((num_steps, obs_dim), np.float32),
               "next_obs": np.zeros((num_steps, obs_dim), np.float32),
               "actions": np.zeros((num_steps, act_dim), np.float32),
               "rewards": np.zeros(num_steps, np.float32),
               "dones": np.zeros(num_steps, np.float32)}
        for t in range(num_steps):
            eps = self._eps(act_dim)
            with torch.no_grad():
                act, _ = sample_action(self._params,
                                       torch.from_numpy(self._obs[None, :]),
                                       eps)
            act = act.numpy()[0]
            nxt, reward, terminated, truncated, _ = self.env.step(
                act * self.max_torque)
            out["obs"][t] = self._obs
            out["next_obs"][t] = nxt
            out["actions"][t] = act
            out["rewards"][t] = reward
            out["dones"][t] = float(terminated)
            self._episode_return += reward
            if terminated or truncated:
                self._completed.append(self._episode_return)
                self._episode_return = 0.0
                nxt, _ = self.env.reset()
            self._obs = nxt
        completed, self._completed = self._completed, []
        out["episode_returns"] = np.asarray(completed, np.float32)
        return out


# ---------------------------------------------------------------- algorithm


@dataclass
class SACConfig:
    env: Any = "Pendulum-v1"
    num_env_runners: int = 1
    rollout_fragment_length: int = 200
    train_batch_size: int = 256
    lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.01
    hidden: Tuple[int, ...] = (64, 64)
    buffer_capacity: int = 50_000
    learning_starts: int = 400
    updates_per_iter: int = 16
    target_entropy: Optional[float] = None   # default: -act_dim
    seed: int = 0

    def environment(self, env) -> "SACConfig":
        self.env = env
        return self

    def env_runners(self, *, num_env_runners: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None
                    ) -> "SACConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kwargs) -> "SACConfig":
        for key, val in kwargs.items():
            if not hasattr(self, key):
                raise ValueError(f"unknown training option {key!r}")
            setattr(self, key, val)
        return self

    def build(self, device: DeviceLike = None,
              hooks: Optional[RunnerHooks] = None) -> "SAC":
        return SAC(self, device=device, hooks=hooks)


class SAC(CheckpointableAlgorithm):
    """Sample -> replay add -> n soft-actor-critic updates -> broadcast."""

    def __init__(self, config: SACConfig, device: DeviceLike = None,
                 hooks: Optional[RunnerHooks] = None):
        self.config = config
        self.device = resolve_device(device)
        self.hooks = hooks or LOCAL
        probe = make_env(config.env, seed=0)
        if not getattr(probe, "continuous", False):
            raise ValueError(
                "SAC here targets continuous-action envs (e.g. "
                "Pendulum-v1); use DQN/PPO/IMPALA for discrete ones")
        self.obs_dim = probe.observation_dim
        self.act_dim = probe.action_dim
        self.target_entropy = (config.target_entropy
                               if config.target_entropy is not None
                               else -float(self.act_dim))
        self.params = on_device(init_sac_params(
            torch.Generator().manual_seed(config.seed), self.obs_dim,
            self.act_dim, config.hidden), self.device, grad=True)
        self.target = {k: on_device(self.params[k], self.device)
                       for k in ("q1", "q2")}
        self.opt_state = adamw(config.lr, weight_decay=0.0).init(self.params)
        self.buffer = ReplayBuffer(
            config.buffer_capacity, self.obs_dim,
            act_shape=(self.act_dim,), act_dtype=np.float32)
        self.np_rng = np.random.default_rng(config.seed)
        self._gen = torch.Generator().manual_seed(config.seed + 1)
        self.iteration = 0
        self.runners = self.hooks.place(
            SACEnvRunner, config.env, config.hidden,
            [config.seed + 300 + i for i in range(config.num_env_runners)])
        if not broadcast_suppressed():
            self._broadcast()

    def _extra_state(self):
        return {"target": to_numpy(self.target)}

    def _apply_extra_state(self, state):
        if "target" in state:
            self.target = on_device(state["target"], self.device)

    def _broadcast(self) -> None:
        self.hooks.call_all(self.runners, "set_params",
                            host_copy(self.params),
                            timeout=BROADCAST_TIMEOUT_S)

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        frags = self.hooks.call_all(self.runners, "sample",
                                    cfg.rollout_fragment_length,
                                    timeout=SAMPLE_TIMEOUT_S)
        returns: List[float] = []
        for frag in frags:
            returns.extend(frag.pop("episode_returns").tolist())
            self.buffer.add_batch(frag)

        metrics: Dict[str, Any] = {}
        if self.buffer.size >= cfg.learning_starts:
            batch = batch_to(self.buffer.sample(
                self.np_rng, cfg.train_batch_size * cfg.updates_per_iter),
                self.device)
            self.params, self.target, self.opt_state, metrics = sac_update(
                self.params, self.target, self.opt_state, batch, self._gen,
                lr=cfg.lr, gamma=cfg.gamma, tau=cfg.tau,
                target_entropy=self.target_entropy,
                n_updates=cfg.updates_per_iter)
            metrics = {k: float(v) for k, v in metrics.items()}
            self._broadcast()
        self.iteration += 1
        metrics.update({
            "iteration": self.iteration,
            "buffer_size": self.buffer.size,
            "episode_return_mean": (float(np.mean(returns))
                                    if returns else float("nan")),
            "episodes_this_iter": len(returns),
        })
        return metrics

    def stop(self) -> None:
        self.hooks.stop(self.runners)
        self.runners = []
