"""PPO in PyTorch (counterpart of ``ray_tpu/rllib/ppo.py``).

    config = (PPOConfig().environment("CartPole-v1")
              .env_runners(num_env_runners=2)
              .training(lr=3e-4, train_batch_size=2000))
    algo = config.build()              # the learner on the card
    for _ in range(10):
        metrics = algo.train()

The learner's params, AdamW state and update live on the algorithm's
device (the card unless ``device="cpu"``); the update is plain tensor
code (an MLP: its products are ``torch.matmul``, as the reference leaves
them to XLA). The env runners take the reference's seeds and act on the
CPU from host copies of the weights, so a fragment is the reference
runner's, draw for draw. Where they run is the ``hooks``' choice
(``runners.RunnerHooks``): in this process by default, sampled in turn;
``ray_tpu`` actors sampling at once when the hooks are ``ray_tpu``'s.
Each epoch's shuffle is a permutation from a CPU ``torch.Generator``
seeded from the algorithm's seed, so the card and the CPU shuffle alike.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._private.device import DeviceLike, resolve_device
from .._private.tree import tree_leaves
from ..train.optim import adamw
from .checkpoint import (CheckpointableAlgorithm, broadcast_suppressed,
                         host_copy, on_device)
from .env import make_env
from .runners import (BROADCAST_TIMEOUT_S, LOCAL, SAMPLE_TIMEOUT_S,
                      RunnerHooks)

# ---------------------------------------------------------------------------
# Policy/value network: a functional MLP.
# ---------------------------------------------------------------------------


def init_policy(gen: torch.Generator, obs_dim: int, act_dim: int,
                hidden: Tuple[int, ...]):
    """The reference's init (He-normal trunk, pi head * 0.01, vf head * 1,
    zero biases) on the CPU, drawn from ``gen`` in layer order; the values
    differ from JAX's (another generator)."""
    sizes = (obs_dim,) + tuple(hidden)

    def normal(*shape):
        return torch.randn(shape, generator=gen)

    params = {"layers": [
        {"w": normal(sizes[i], sizes[i + 1]) * (2.0 / sizes[i]) ** 0.5,
         "b": torch.zeros(sizes[i + 1])} for i in range(len(hidden))]}
    params["pi"] = {"w": normal(sizes[-1], act_dim) * 0.01,
                    "b": torch.zeros(act_dim)}
    params["vf"] = {"w": normal(sizes[-1], 1) * 1.0, "b": torch.zeros(1)}
    return params


def policy_forward(params, obs):
    x = obs
    for layer in params["layers"]:
        x = torch.tanh(x @ layer["w"] + layer["b"])
    logits = x @ params["pi"]["w"] + params["pi"]["b"]
    value = (x @ params["vf"]["w"] + params["vf"]["b"])[..., 0]
    return logits, value


def adam_step(params, opt_state, loss, lr: float) -> None:
    """One ``optax.adam(lr)`` step in place: the gradient of ``loss`` with
    respect to every leaf (0 where it does not reach, as in JAX)."""
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    adamw(lr, weight_decay=0.0).update_(params, grads, opt_state)


def log_probs(logits, actions):
    """(log_softmax over the actions, log prob of ``actions``)."""
    logp_all = torch.log_softmax(logits, dim=-1)
    return logp_all, logp_all.gather(1, actions.long()[:, None])[:, 0]


# ---------------------------------------------------------------------------
# Env runner: one sampling worker (placed by the algorithm's hooks).
# ---------------------------------------------------------------------------


class EnvRunner:
    def __init__(self, env_spec, hidden: Tuple[int, ...], seed: int):
        self.env = make_env(env_spec, seed=seed)
        self.hidden = tuple(hidden)
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self._params = None
        self._obs, _ = self.env.reset(seed=seed)
        self._episode_return = 0.0
        self._completed: List[float] = []

    def set_params(self, params) -> bool:
        """``params``: CPU tensors (``checkpoint.host_copy``)."""
        self._params = params
        return True

    def _act(self, obs: np.ndarray) -> Tuple[int, float, float]:
        with torch.no_grad():
            logits, value = policy_forward(self._params,
                                           torch.from_numpy(obs[None, :]))
        logits = logits.numpy()[0].astype(np.float64)
        logits -= logits.max()
        probs = np.exp(logits)
        probs /= probs.sum()
        action = int(self.rng.choice(len(probs), p=probs))
        return action, float(np.log(probs[action])), float(value[0])

    def sample(self, num_steps: int) -> Dict[str, np.ndarray]:
        """A fixed-size rollout fragment (episodes continue across calls;
        the fragment carries its bootstrap value)."""
        obs_buf = np.zeros((num_steps, len(self._obs)), np.float32)
        act_buf = np.zeros(num_steps, np.int32)
        rew_buf = np.zeros(num_steps, np.float32)
        done_buf = np.zeros(num_steps, np.float32)
        logp_buf = np.zeros(num_steps, np.float32)
        val_buf = np.zeros(num_steps, np.float32)
        for t in range(num_steps):
            action, logp, value = self._act(self._obs)
            obs_buf[t] = self._obs
            act_buf[t] = action
            logp_buf[t] = logp
            val_buf[t] = value
            obs, reward, terminated, truncated, _ = self.env.step(action)
            rew_buf[t] = reward
            self._episode_return += reward
            done = terminated or truncated
            done_buf[t] = float(done)
            if done:
                self._completed.append(self._episode_return)
                self._episode_return = 0.0
                obs, _ = self.env.reset()
            self._obs = obs
        _, bootstrap = self._act(self._obs)[1:]
        completed, self._completed = self._completed, []
        return {"obs": obs_buf, "actions": act_buf, "rewards": rew_buf,
                "dones": done_buf, "logp": logp_buf, "values": val_buf,
                "bootstrap_value": np.float32(bootstrap),
                "episode_returns": np.asarray(completed, np.float32)}


# ---------------------------------------------------------------------------
# Learner.
# ---------------------------------------------------------------------------


def _gae(rewards, values, dones, bootstrap, gamma, lam):
    """Generalized advantage estimation over one fragment (host side)."""
    T = len(rewards)
    adv = np.zeros(T, np.float32)
    last = 0.0
    next_value = bootstrap
    for t in range(T - 1, -1, -1):
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        last = delta + gamma * lam * nonterminal * last
        adv[t] = last
        next_value = values[t]
    return adv, adv + values


def _ppo_loss(params, batch, idx, clip, vf_coef, ent_coef):
    logits, value = policy_forward(params, batch["obs"][idx])
    logp_all, logp = log_probs(logits, batch["actions"][idx])
    ratio = torch.exp(logp - batch["logp"][idx])
    adv = batch["advantages"][idx]
    # the population std, as jnp's .std()
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    surr = torch.minimum(ratio * adv,
                         torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv)
    pi_loss = -surr.mean()
    vf_loss = (value - batch["returns"][idx]).square().mean()
    entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
    total = pi_loss + vf_coef * vf_loss - ent_coef * entropy
    return total, (pi_loss, vf_loss, entropy)


def ppo_update(params, opt_state, batch, gen: torch.Generator, lr, *,
               clip: float, vf_coef: float, ent_coef: float,
               n_minibatches: int, n_epochs: int):
    """All epochs and minibatches of one PPO iteration, in place: each
    epoch shuffles the batch with a permutation from ``gen`` (a CPU
    generator) and takes ``n_minibatches`` slices of N // n_minibatches
    rows (the tail is dropped, as the reference's dynamic slices do).
    Returns (params, opt_state, metrics as 0-d tensors, each the mean over
    every minibatch step)."""
    N = batch["obs"].shape[0]
    mb = N // n_minibatches
    dev = batch["obs"].device
    steps = []
    for _ in range(n_epochs):
        perm = torch.randperm(N, generator=gen).to(dev)
        for i in range(n_minibatches):
            idx = perm[i * mb:(i + 1) * mb]
            loss, aux = _ppo_loss(params, batch, idx, clip, vf_coef,
                                  ent_coef)
            adam_step(params, opt_state, loss, lr)
            steps.append(torch.stack([loss.detach(), *map(torch.detach,
                                                          aux)]))
    m = torch.stack(steps).mean(0)
    return params, opt_state, {"total_loss": m[0], "policy_loss": m[1],
                               "vf_loss": m[2], "entropy": m[3]}


# ---------------------------------------------------------------------------
# Config + Algorithm.
# ---------------------------------------------------------------------------


@dataclass
class PPOConfig:
    env: Any = "CartPole-v1"
    num_env_runners: int = 2
    rollout_fragment_length: int = 512
    train_batch_size: int = 1024          # derived check only
    lr: float = 3e-4
    gamma: float = 0.99
    lambda_: float = 0.95
    clip_param: float = 0.2
    vf_loss_coeff: float = 0.5
    entropy_coeff: float = 0.01
    num_epochs: int = 8
    num_minibatches: int = 8
    hidden: Tuple[int, ...] = (64, 64)
    seed: int = 0

    def environment(self, env) -> "PPOConfig":
        self.env = env
        return self

    def env_runners(self, *, num_env_runners: Optional[int] = None,
                    rollout_fragment_length: Optional[int] = None
                    ) -> "PPOConfig":
        if num_env_runners is not None:
            self.num_env_runners = num_env_runners
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kwargs) -> "PPOConfig":
        for key, val in kwargs.items():
            if not hasattr(self, key):
                raise ValueError(f"unknown training option {key!r}")
            setattr(self, key, val)
        return self

    def build(self, device: DeviceLike = None,
              hooks: Optional[RunnerHooks] = None) -> "PPO":
        return PPO(self, device=device, hooks=hooks)


def batch_to(arrays: Dict[str, np.ndarray], device) -> Dict[str, Any]:
    return {k: torch.as_tensor(v).to(device) for k, v in arrays.items()}


class PPO(CheckpointableAlgorithm):
    """The runners sample, the learner updates on ``device``, the new
    weights go back to the runners as host copies. ``hooks`` place the
    runners (default: in this process)."""

    def __init__(self, config: PPOConfig, device: DeviceLike = None,
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
        self._gen = torch.Generator().manual_seed(config.seed + 1)
        self.iteration = 0
        self.runners = self.hooks.place(
            EnvRunner, config.env, config.hidden,
            [config.seed + 100 + i for i in range(config.num_env_runners)])
        if not broadcast_suppressed():  # from_checkpoint restores first
            self._broadcast()

    def _broadcast(self) -> None:
        self.hooks.call_all(self.runners, "set_params",
                            host_copy(self.params),
                            timeout=BROADCAST_TIMEOUT_S)

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        frags = self.hooks.call_all(self.runners, "sample",
                                    cfg.rollout_fragment_length,
                                    timeout=SAMPLE_TIMEOUT_S)
        obs, acts, logps, advs, rets, ep_returns = [], [], [], [], [], []
        for frag in frags:
            adv, ret = _gae(frag["rewards"], frag["values"], frag["dones"],
                            frag["bootstrap_value"], cfg.gamma, cfg.lambda_)
            obs.append(frag["obs"])
            acts.append(frag["actions"])
            logps.append(frag["logp"])
            advs.append(adv)
            rets.append(ret)
            ep_returns.extend(frag["episode_returns"].tolist())
        batch = batch_to({"obs": np.concatenate(obs),
                          "actions": np.concatenate(acts),
                          "logp": np.concatenate(logps),
                          "advantages": np.concatenate(advs),
                          "returns": np.concatenate(rets)}, self.device)
        self.params, self.opt_state, losses = ppo_update(
            self.params, self.opt_state, batch, self._gen, cfg.lr,
            clip=cfg.clip_param, vf_coef=cfg.vf_loss_coeff,
            ent_coef=cfg.entropy_coeff,
            n_minibatches=cfg.num_minibatches, n_epochs=cfg.num_epochs)
        self._broadcast()
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "episode_reward_mean": (float(np.mean(ep_returns))
                                    if ep_returns else float("nan")),
            "episodes_this_iter": len(ep_returns),
            "timesteps_this_iter": int(batch["obs"].shape[0]),
            **{k: float(v) for k, v in losses.items()},
        }

    def stop(self) -> None:
        self.hooks.stop(self.runners)
        self.runners = []
