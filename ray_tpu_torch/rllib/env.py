"""Built-in environments (counterpart of ``ray_tpu/rllib/env.py``, numpy
only: the same seed gives the same trajectories bit for bit).

gym is not a dependency, so the classic control tasks are implemented
directly. The API mirrors gymnasium: reset() -> (obs, info), step(a) ->
(obs, reward, terminated, truncated, info).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import numpy as np


class CartPole:
    """Classic cart-pole balancing (the CartPole-v1 task: physics per
    Barto, Sutton & Anderson 1983; episode caps at 500 steps)."""

    GRAVITY = 9.8
    CART_MASS = 1.0
    POLE_MASS = 0.1
    POLE_HALF_LEN = 0.5
    FORCE = 10.0
    DT = 0.02
    THETA_LIMIT = 12 * math.pi / 180
    X_LIMIT = 2.4
    MAX_STEPS = 500

    observation_dim = 4
    action_dim = 2

    def __init__(self, seed: Optional[int] = None):
        self.rng = np.random.default_rng(seed)
        self.state = np.zeros(4, np.float64)
        self.steps = 0

    def reset(self, seed: Optional[int] = None) -> Tuple[np.ndarray, Dict]:
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.state = self.rng.uniform(-0.05, 0.05, size=4)
        self.steps = 0
        return self.state.astype(np.float32), {}

    def step(self, action: int):
        x, x_dot, theta, theta_dot = self.state
        force = self.FORCE if action == 1 else -self.FORCE
        total_mass = self.CART_MASS + self.POLE_MASS
        pole_ml = self.POLE_MASS * self.POLE_HALF_LEN
        cos_t, sin_t = math.cos(theta), math.sin(theta)
        temp = (force + pole_ml * theta_dot ** 2 * sin_t) / total_mass
        theta_acc = (self.GRAVITY * sin_t - cos_t * temp) / (
            self.POLE_HALF_LEN
            * (4.0 / 3.0 - self.POLE_MASS * cos_t ** 2 / total_mass))
        x_acc = temp - pole_ml * theta_acc * cos_t / total_mass
        x += self.DT * x_dot
        x_dot += self.DT * x_acc
        theta += self.DT * theta_dot
        theta_dot += self.DT * theta_acc
        self.state = np.array([x, x_dot, theta, theta_dot])
        self.steps += 1
        terminated = bool(abs(x) > self.X_LIMIT
                          or abs(theta) > self.THETA_LIMIT)
        truncated = self.steps >= self.MAX_STEPS
        return (self.state.astype(np.float32), 1.0, terminated, truncated,
                {})


class Pendulum:
    """Classic pendulum swing-up (the Pendulum-v1 task: torque-limited
    continuous control; reward = -(theta² + 0.1·theta_dot² + 0.001·u²)).
    The continuous-action counterpart to the discrete CartPole — SAC's
    native habitat."""

    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    DT = 0.05
    G = 10.0
    M = 1.0
    L = 1.0
    MAX_STEPS = 200

    observation_dim = 3
    action_dim = 1          # continuous: u in [-MAX_TORQUE, MAX_TORQUE]
    continuous = True

    def __init__(self, seed: Optional[int] = None):
        self.rng = np.random.default_rng(seed)
        self.theta = 0.0
        self.theta_dot = 0.0
        self.steps = 0

    def _obs(self) -> np.ndarray:
        return np.array([math.cos(self.theta), math.sin(self.theta),
                         self.theta_dot], np.float32)

    def reset(self, seed: Optional[int] = None) -> Tuple[np.ndarray, Dict]:
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.theta = self.rng.uniform(-math.pi, math.pi)
        self.theta_dot = self.rng.uniform(-1.0, 1.0)
        self.steps = 0
        return self._obs(), {}

    def step(self, action):
        u = float(np.clip(np.asarray(action).reshape(-1)[0],
                          -self.MAX_TORQUE, self.MAX_TORQUE))
        th, thd = self.theta, self.theta_dot
        norm_th = ((th + math.pi) % (2 * math.pi)) - math.pi
        cost = norm_th ** 2 + 0.1 * thd ** 2 + 0.001 * u ** 2
        thd = thd + (3 * self.G / (2 * self.L) * math.sin(th)
                     + 3.0 / (self.M * self.L ** 2) * u) * self.DT
        thd = float(np.clip(thd, -self.MAX_SPEED, self.MAX_SPEED))
        th = th + thd * self.DT
        self.theta, self.theta_dot = th, thd
        self.steps += 1
        truncated = self.steps >= self.MAX_STEPS
        return self._obs(), -cost, False, truncated, {}


_REGISTRY = {"CartPole-v1": CartPole, "Pendulum-v1": Pendulum}


def make_env(name_or_fn: Any, seed: Optional[int] = None):
    if callable(name_or_fn):
        # pass the per-runner seed through when the factory accepts one —
        # otherwise every runner would sample identical episodes
        import inspect

        try:
            sig = inspect.signature(name_or_fn)
            if "seed" in sig.parameters:
                return name_or_fn(seed=seed)
        except (TypeError, ValueError):
            pass
        return name_or_fn()
    cls = _REGISTRY.get(name_or_fn)
    if cls is None:
        raise ValueError(f"unknown env {name_or_fn!r}; register a factory "
                         f"callable or use one of {sorted(_REGISTRY)}")
    return cls(seed=seed)
