"""Actor classes for tests/test_torch_dag.py, in a module of their own:
a ray_tpu worker imports the module of each actor class it hosts, and
this one imports numpy only (torch and jax inside the methods that use
them)."""

import numpy as np


class Adder:
    def __init__(self, inc):
        self.inc = inc
        self.calls = 0

    def add(self, x):
        self.calls += 1
        return x + self.inc

    def add2(self, x, y):
        return x + y

    def pair(self, x):
        return {"a": x, "b": x * 10}

    def make(self, x):
        return {"outer": {"inner": x * 2}}

    def count(self):
        return self.calls


class Boom:
    def go(self, x):
        if float(np.asarray(x).reshape(-1)[0]) == 3:
            raise ValueError("kaboom")
        return x


class JaxBoom(Boom):
    """Boom whose result is a jax array: ray_tpu's DeviceChannel carries
    jax leaves only."""

    def go(self, x):
        import jax.numpy as jnp

        return jnp.asarray(super().go(x))


class TorchWorker:
    """The port's device-edge stage: computes on torch tensors and reports
    this process's DeviceChannel counters."""

    def scale(self, x):
        import torch

        return torch.as_tensor(x) * 2.0

    def shift(self, x):
        return x + 1.0

    def counters(self):
        from ray_tpu_torch.experimental import DeviceChannel

        return (DeviceChannel.ipc_transfers, DeviceChannel.host_lane_bytes)


class JaxWorker:
    """ray_tpu's device-edge stage (tests/test_dag.py's TensorWorker)."""

    def scale(self, x):
        import jax.numpy as jnp

        return jnp.asarray(x) * 2.0

    def shift(self, x):
        return x + 1.0
