"""Where an algorithm's env runners live: the runner-placement hooks
(counterpart of the reference's ``ray_tpu.remote(EnvRunner)`` placement in
``ray_tpu/rllib/{ppo,impala,dqn,sac}.py``).

The reference makes every env runner a ``ray_tpu`` actor, sends the
weights with ``ray_tpu.get([r.set_params.remote(host)])``, takes IMPALA's
fragments in the order ``ray_tpu.wait`` reports them and kills the actors
on ``stop()``. The port takes those four functions as a
:class:`RunnerHooks`, so that it imports nothing of ``ray_tpu``:

    import ray_tpu
    hooks = RunnerHooks(remote=ray_tpu.remote, get=ray_tpu.get,
                        wait=ray_tpu.wait, kill=ray_tpu.kill)
    algo = PPOConfig().build(device="cpu", hooks=hooks)

Any implementation of the same four calls will do (``chip_smoke.py`` has
one over ``multiprocessing``):

  * ``remote(cls).remote(*args)`` places a runner, returns its handle;
  * ``handle.method.remote(*args)`` starts a call, returns a ref;
  * ``get(ref or [refs], timeout=s)`` returns the value(s);
  * ``wait(refs, num_returns=1, timeout=s)`` returns (ready, not ready),
    the ready ones in the order they finished;
  * ``kill(handle)`` ends the runner.

Every ``get`` and ``wait`` an algorithm makes carries a timeout, so that
a lost result raises instead of hanging.

The default, :data:`LOCAL`, holds every runner in this process:
``.remote()`` runs the call at once and returns a finished ref, ``wait``
reports the refs in the order given, and ``kill`` drops nothing. A local
handle is also the runner for a plain call or attribute
(``handle.sample(n)``, ``handle._params``), and pickles as one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Sequence

__all__ = ["RunnerHooks", "LOCAL", "LocalRunner"]

# the reference's bounds: a weight broadcast, one fragment, the weights
# sent to one drained runner
BROADCAST_TIMEOUT_S = 120.0
SAMPLE_TIMEOUT_S = 300.0
REFRESH_TIMEOUT_S = 60.0


class _Done:
    """A finished local call: its value, or the exception it raised
    (raised again by ``get``, as a remote call's error is)."""

    __slots__ = ("value", "error")

    def __init__(self, fn, args, kwargs):
        self.value, self.error = None, None
        try:
            self.value = fn(*args, **kwargs)
        except Exception as e:  # handed to the caller by get()
            self.error = e


class _LocalMethod:
    def __init__(self, bound):
        self._bound = bound

    def __call__(self, *args, **kwargs):
        return self._bound(*args, **kwargs)

    def remote(self, *args, **kwargs) -> _Done:
        return _Done(self._bound, args, kwargs)


class LocalRunner:
    """A runner held in this process behind an actor's handle: its
    methods take ``.remote(...)``, which runs at once."""

    def __init__(self, runner):
        self._runner = runner

    def __getattr__(self, name: str):
        if name.startswith("__") or name == "_runner":
            raise AttributeError(name)
        attr = getattr(self._runner, name)
        return _LocalMethod(attr) if callable(attr) else attr


class _LocalClass:
    def __init__(self, cls):
        self._cls = cls

    def remote(self, *args, **kwargs) -> LocalRunner:
        return LocalRunner(self._cls(*args, **kwargs))


def _local_get(refs, timeout=None):
    if isinstance(refs, (list, tuple)):
        return [_local_get(r) for r in refs]
    if refs.error is not None:
        raise refs.error
    return refs.value


def _local_wait(refs, num_returns=1, timeout=None):
    refs = list(refs)
    return refs[:num_returns], refs[num_returns:]


def _local_kill(handle) -> None:
    pass


@dataclass(frozen=True)
class RunnerHooks:
    """How an algorithm places its runners and talks to them (see the
    module docstring). The defaults hold the runners in this process."""

    remote: Callable[[type], Any] = _LocalClass
    get: Callable[..., Any] = _local_get
    wait: Callable[..., Any] = _local_wait
    kill: Callable[[Any], None] = _local_kill

    def place(self, cls, env, hidden, seeds: Sequence[int]) -> List[Any]:
        """One runner ``cls(env, hidden, seed)`` for each seed."""
        actor = self.remote(cls)
        return [actor.remote(env, hidden, seed) for seed in seeds]

    def call_all(self, runners, method: str, *args,
                 timeout: float) -> List[Any]:
        """``method(*args)`` on every runner at once; their results."""
        return self.get([getattr(r, method).remote(*args) for r in runners],
                        timeout=timeout)

    def stop(self, runners) -> None:
        for runner in runners:
            self.kill(runner)


LOCAL = RunnerHooks()
