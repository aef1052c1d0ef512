"""ray_tpu_torch.rllib's runners placed as ray_tpu actors, against
ray_tpu.rllib's algorithms on the same local cluster.

The port's algorithms take ``RunnerHooks(remote=ray_tpu.remote,
get=ray_tpu.get, wait=ray_tpu.wait, kill=ray_tpu.kill)``; the reference
places its runners with the same functions. Each port algorithm starts
from the reference's initial params (the two packages draw their inits
from different generators), with a fresh AdamW state, and both run on
the CPU. The fragments each learner takes (recorded through ``get``) are
equal exactly (obs, actions, rewards, dones: the actions are drawn from
the policy's probabilities by the runner's numpy generator, or taken by
argmax); losses and params at F32 (1e-5 absolute and relative, as in
tests/test_torch_rllib.py). SAC's actions are the actor's f32 outputs,
which the env integrates, so its obs, actions and rewards are held at
F32 and its dones exactly. PPO runs
one minibatch (the two packages shuffle with different generators);
SAC's runners and learner draw the reference's noise (a runner subclass
and a patched ``sac_update``, carried to the actors by cloudpickle).
IMPALA and APPO run one runner, whose completion order is fixed.

Also: IMPALA's completion order under a scripted ``wait`` with two
in-process runners, ``from_checkpoint`` with remote runners, ``stop()``,
``rollout_dataset`` through ``ray_tpu.data.from_items``, and the
multiprocessing hooks of ``chip_smoke.py``'s ``rl`` phase on the CPU.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import ray_tpu
from ray_tpu import data as rdata
from ray_tpu.exceptions import ActorDiedError
from ray_tpu.rllib import appo as j_appo
from ray_tpu.rllib import dqn as j_dqn
from ray_tpu.rllib import impala as j_impala
from ray_tpu.rllib import offline as j_offline
from ray_tpu.rllib import ppo as j_ppo
from ray_tpu.rllib import sac as j_sac

from ray_tpu_torch._private.tree import tree_leaves
from ray_tpu_torch.models import params_from_jax
from ray_tpu_torch.rllib import (LOCAL, APPOConfig, DQNConfig,
                                 IMPALAConfig, PPOConfig, RunnerHooks,
                                 SACConfig, rollout_dataset)
from ray_tpu_torch.rllib import impala, offline, ppo, sac
from ray_tpu_torch.rllib.checkpoint import on_device, to_numpy
from ray_tpu_torch.rllib.ppo import PPO
from ray_tpu_torch.rllib.runners import LocalRunner
from ray_tpu_torch.train import adamw

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# six xdist workers share the machine's cores
torch.set_num_threads(2)

F32 = dict(atol=1e-5, rtol=1e-5)
HIDDEN = (32, 32)
FRAG_KEYS = ("obs", "actions", "rewards", "dones")


@pytest.fixture(scope="module")
def cluster():
    # the runner actors import torch: one thread each
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        ray_tpu.init(num_cpus=4)
        try:
            yield
        finally:
            ray_tpu.shutdown()


_GET = ray_tpu.get


def _recording_get(frags):
    """``ray_tpu.get`` that keeps every fragment it returns."""
    def get(refs, timeout=None):
        out = _GET(refs, timeout=timeout)
        for v in out if isinstance(out, list) else [out]:
            if isinstance(v, dict) and "obs" in v:
                frags.append({k: np.array(v[k]) for k in FRAG_KEYS})
        return out
    return get


def _ray_hooks(get=None, kill=None, remote=None):
    return RunnerHooks(remote=remote or ray_tpu.remote, get=get or _GET,
                       wait=ray_tpu.wait, kill=kill or ray_tpu.kill)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cpu(j_tree):
    return on_device(params_from_jax(_np(j_tree), device="cpu"),
                     torch.device("cpu"), grad=True)


def _adopt(algo, j_params, lr):
    """The reference's initial params and a fresh AdamW state in the
    port's algorithm."""
    algo.params = _cpu(j_params)
    algo.opt_state = adamw(lr, weight_decay=0.0).init(algo.params)


def _assert_trees_close(port_tree, ref_tree):
    got = tree_leaves(to_numpy(port_tree))
    want = jax.tree.leaves(_np(ref_tree))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **F32)


def _assert_same_fragments(got, want, continuous=False):
    """Exactly; with ``continuous`` actions (the actor's f32 output, fed
    to the env) obs, actions and rewards at F32 and dones exactly."""
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        for k in FRAG_KEYS:
            if continuous and k != "dones":
                np.testing.assert_allclose(a[k], b[k], err_msg=f"{i} {k}",
                                           **F32)
            else:
                assert np.array_equal(a[k], b[k]), (i, k)


def _assert_metrics_close(got, want, keys):
    for m, jm in zip(got, want):
        for k in keys:
            np.testing.assert_allclose(m[k], jm[k], err_msg=k, **F32)


def _assert_killed(handles):
    for h in handles:
        with pytest.raises(ActorDiedError):
            _GET(h.set_params.remote(None), timeout=60)


def _run_reference(monkeypatch, config, n_iter):
    """The reference algorithm on the cluster: its first params, its
    metrics, its fragments, its final params."""
    frags = []
    monkeypatch.setattr(ray_tpu, "get", _recording_get(frags))
    algo = config.build()
    p0 = _np(algo.params)
    metrics = [algo.train() for _ in range(n_iter)]
    params = algo.params
    for runner in algo.runners:     # the reference's SAC has no stop()
        ray_tpu.kill(runner)
    monkeypatch.setattr(ray_tpu, "get", _GET)
    return p0, metrics, frags, params


def _run_port(config, n_iter, j_p0, adopt_extra=None, remote=None):
    frags = []
    algo = config.build(device="cpu", hooks=_ray_hooks(
        get=_recording_get(frags), remote=remote))
    assert not any(isinstance(r, LocalRunner) for r in algo.runners)
    handles = list(algo.runners)
    try:
        _adopt(algo, j_p0, config.lr)
        if adopt_extra:
            adopt_extra(algo)
        algo._broadcast()
        metrics = [algo.train() for _ in range(n_iter)]
    finally:
        algo.stop()
    _assert_killed(handles)
    return metrics, frags, algo.params


def test_ppo_with_remote_runners_matches_the_reference(cluster, monkeypatch):
    kw = dict(num_minibatches=1, num_epochs=2, hidden=HIDDEN, seed=4)
    j_cfg = j_ppo.PPOConfig().env_runners(
        num_env_runners=2, rollout_fragment_length=64).training(**kw)
    p0, j_m, j_frags, j_params = _run_reference(monkeypatch, j_cfg, 2)
    cfg = PPOConfig().env_runners(num_env_runners=2,
                                  rollout_fragment_length=64).training(**kw)
    m, frags, params = _run_port(cfg, 2, p0)
    # two fragments an iteration, in runner order
    assert len(frags) == 4
    _assert_same_fragments(frags, j_frags)
    _assert_metrics_close(m, j_m, ("total_loss", "policy_loss", "vf_loss",
                                   "entropy"))
    assert [x["episodes_this_iter"] for x in m] == [
        x["episodes_this_iter"] for x in j_m]
    _assert_trees_close(params, j_params)


def test_dqn_with_remote_runners_matches_the_reference(cluster, monkeypatch):
    kw = dict(learning_starts=64, train_batch_size=32, updates_per_iter=2,
              target_update_interval=1, hidden=HIDDEN, seed=6)
    j_cfg = j_dqn.DQNConfig().env_runners(
        num_env_runners=2, rollout_fragment_length=64).training(**kw)
    p0, j_m, j_frags, j_params = _run_reference(monkeypatch, j_cfg, 2)
    cfg = DQNConfig().env_runners(num_env_runners=2,
                                  rollout_fragment_length=64).training(**kw)

    def target(algo):
        algo.target_params = _cpu(p0)

    m, frags, params = _run_port(cfg, 2, p0, target)
    assert len(frags) == 4
    _assert_same_fragments(frags, j_frags)
    _assert_metrics_close(m, j_m, ("td_loss", "td_abs", "epsilon"))
    assert [x["buffer_size"] for x in m] == [128, 256]
    _assert_trees_close(params, j_params)


def _reference_sac_noise(key, n_updates, mb, act_dim):
    """The draws the reference's scan makes: k, sub = split(k) per step,
    then k1, k2 = split(sub) for the next action and the policy's."""
    noise = []
    for _ in range(n_updates):
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        noise.append([np.asarray(jax.random.normal(k, (mb, act_dim)))
                      for k in (k1, k2)])
    return torch.from_numpy(np.asarray(noise))


def test_sac_with_remote_runners_matches_the_reference(cluster, monkeypatch):
    kw = dict(learning_starts=64, train_batch_size=32, updates_per_iter=2,
              hidden=HIDDEN, seed=8)
    j_cfg = j_sac.SACConfig().env_runners(
        num_env_runners=2, rollout_fragment_length=64).training(**kw)
    p0, j_m, j_frags, j_params = _run_reference(monkeypatch, j_cfg, 2)

    class ReferenceNoiseRunner(sac.SACEnvRunner):
        """Draws the reference runner's noise: a jax key from its seed,
        split once a step."""

        def _eps(self, act_dim):
            import jax

            if not hasattr(self, "_key"):
                self._key = jax.random.PRNGKey(self.seed)
            self._key, sub = jax.random.split(self._key)
            return torch.from_numpy(np.asarray(
                jax.random.normal(sub, (1, act_dim))))

    keys = [jax.random.PRNGKey(kw["seed"] + 1)]

    def update_with_reference_noise(params, target, opt_state, batch, gen,
                                    *, n_updates, **kw):
        keys[0], sub = jax.random.split(keys[0])
        noise = _reference_sac_noise(sub, n_updates,
                                     batch["obs"].shape[0] // n_updates,
                                     batch["actions"].shape[-1])
        return sac.sac_update_with_noise(params, target, opt_state, batch,
                                         noise, **kw)

    def remote(cls):
        # the hooks place the reference-noise runner in SAC's runner's stead
        assert cls is sac.SACEnvRunner
        return ray_tpu.remote(ReferenceNoiseRunner)

    monkeypatch.setattr(sac, "sac_update", update_with_reference_noise)
    cfg = SACConfig().env_runners(num_env_runners=2,
                                  rollout_fragment_length=64).training(**kw)

    def target(algo):
        algo.target = {k: on_device(algo.params[k], algo.device)
                       for k in ("q1", "q2")}

    m, frags, params = _run_port(cfg, 2, p0, target, remote)
    assert len(frags) == 4
    _assert_same_fragments(frags, j_frags, continuous=True)
    _assert_metrics_close(m, j_m, ("critic_loss", "actor_loss", "alpha",
                                   "entropy"))
    _assert_trees_close(params, j_params)


@pytest.mark.parametrize("name", ["impala", "appo"])
def test_impala_and_appo_with_a_remote_runner_match_the_reference(
        cluster, monkeypatch, name):
    j_cls, cls = {"impala": (j_impala.IMPALAConfig, IMPALAConfig),
                  "appo": (j_appo.APPOConfig, APPOConfig)}[name]
    kw = dict(fragments_per_iter=3, hidden=HIDDEN, seed=9)
    j_cfg = j_cls().env_runners(num_env_runners=1,
                                rollout_fragment_length=32).training(**kw)
    p0, j_m, j_frags, j_params = _run_reference(monkeypatch, j_cfg, 2)
    cfg = cls().env_runners(num_env_runners=1,
                            rollout_fragment_length=32).training(**kw)
    m, frags, params = _run_port(cfg, 2, p0)
    assert len(frags) == 6
    _assert_same_fragments(frags, j_frags)
    _assert_metrics_close(m, j_m, ("total_loss", "policy_loss", "vf_loss",
                                   "entropy", "mean_rho"))
    _assert_trees_close(params, j_params)


def test_impala_takes_fragments_in_wait_order_and_refreshes_the_drained(
        monkeypatch):
    """Two in-process runners and a scripted ``wait``: the learner takes
    the fragment ``wait`` reports, the oldest in flight on that runner;
    only that runner gets the new weights, and it is relaunched."""
    log = []

    class LoggingRunner(ppo.EnvRunner):
        def set_params(self, params):
            log.append(("set", self.seed))
            return super().set_params(params)

        def sample(self, num_steps):
            frag = super().sample(num_steps)
            log.append(("sample", self.seed, frag["obs"].copy()))
            return frag

    consumed = []
    update = impala.impala_update

    def recording_update(params, opt_state, batch, lr, **kw):
        consumed.append(batch["obs"].numpy().copy())
        return update(params, opt_state, batch, lr, **kw)

    monkeypatch.setattr(impala, "impala_update", recording_update)
    script = [101, 101, 100, 101, 100, 100]
    timeouts = []
    holder = {}

    def scripted_wait(refs, num_returns=1, timeout=None):
        timeouts.append(timeout)
        want = script[len(timeouts) - 1]
        pick = next(r for r in refs
                    if holder["algo"]._inflight[r].seed == want)
        return [pick], [r for r in refs if r is not pick]

    cfg = IMPALAConfig().env_runners(rollout_fragment_length=16).training(
        fragments_per_iter=3, hidden=HIDDEN)
    algo = cfg.build(device="cpu", hooks=RunnerHooks(
        remote=lambda cls: LOCAL.remote(LoggingRunner), wait=scripted_wait))
    holder["algo"] = algo
    for _ in range(2):
        algo.train()
    assert all(t is not None and t > 0 for t in timeouts)
    assert len(consumed) == 6
    # the initial broadcast, then one refresh a drain, to the drained one
    sets = [e[1] for e in log if e[0] == "set"]
    assert sets == [100, 101] + script
    # launches: one a runner, then a relaunch after each drain
    samples = [e for e in log if e[0] == "sample"]
    assert [e[1] for e in samples] == [100, 101] + script
    # each update took the oldest fragment in flight on the drained runner
    pending = {100: [], 101: []}
    it = iter(samples)
    for seed in (100, 101):
        pending[seed].append(next(it)[2])
    for got, seed in zip(consumed, script):
        assert np.array_equal(got, pending[seed].pop(0))
        pending[seed].append(next(it)[2])
    algo.stop()


def test_from_checkpoint_rebuilds_remote_runners(cluster, tmp_path):
    """Restored with the hooks filled, the runners are actors again; a
    checkpoint taken before the first iteration, restored, gives the
    uninterrupted run's next two iterations bit for bit (the runners of a
    restored algorithm start afresh from their seeds, as the reference's
    do); one taken after two iterations restores the learner exactly and
    trains on."""
    hooks = _ray_hooks()
    cfg = PPOConfig().env_runners(num_env_runners=2,
                                  rollout_fragment_length=32).training(
        num_epochs=2, num_minibatches=2, hidden=HIDDEN, seed=12)
    algo = cfg.build(device="cpu", hooks=hooks)
    first = algo.save_to_path(str(tmp_path / "it0"))
    restored = PPO.from_checkpoint(first, device="cpu", hooks=hooks)
    assert restored.hooks is hooks
    assert not any(isinstance(r, LocalRunner) for r in restored.runners)
    want = [algo.train() for _ in range(2)]
    got = [restored.train() for _ in range(2)]
    np.testing.assert_equal(got, want)
    for a, b in zip(tree_leaves(restored.params), tree_leaves(algo.params)):
        assert torch.equal(a, b)
    second = algo.save_to_path(str(tmp_path / "it2"))
    handles = list(algo.runners) + list(restored.runners)
    algo.stop()
    restored.stop()
    again = PPO.from_checkpoint(second, device="cpu", hooks=hooks)
    assert again.iteration == 2
    for a, b in zip(tree_leaves(again.params), tree_leaves(algo.params)):
        assert torch.equal(a, b)
    assert again.train()["training_iteration"] == 3
    handles += list(again.runners)
    again.stop()
    _assert_killed(handles)
    # without hooks the restored runners are in this process
    local = PPO.from_checkpoint(second, device="cpu")
    assert all(isinstance(r, LocalRunner) for r in local.runners)


def test_stop_kills_every_actor(cluster):
    killed = []

    def kill(handle):
        killed.append(handle)
        ray_tpu.kill(handle)

    algo = DQNConfig().env_runners(num_env_runners=2).training(
        hidden=HIDDEN).build(device="cpu", hooks=_ray_hooks(kill=kill))
    handles = list(algo.runners)
    assert len(handles) == 2
    algo.stop()
    assert killed == handles and algo.runners == []
    _assert_killed(handles)


def test_rollout_dataset_rows_equal_the_reference(cluster, tmp_path):
    offline.record_rollouts("CartPole-v1", str(tmp_path / "port"),
                            num_steps=300, seed=3, shard_steps=128)
    j_offline.record_rollouts("CartPole-v1", str(tmp_path / "ref"),
                              num_steps=300, seed=3, shard_steps=128)
    for path in ("port", "ref"):
        ds = rollout_dataset(str(tmp_path / path), rdata.from_items)
        ref = j_offline.rollout_dataset(str(tmp_path / path))
        got, want = ds.take_all(), ref.take_all()
        assert len(got) == len(want) == 300
        for a, b in zip(got, want):
            assert a.keys() == b.keys() == set(FRAG_KEYS)
            for k in FRAG_KEYS:
                assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
                assert np.array_equal(a[k], b[k])
    # the rows handed to the constructor: numpy values, the reference's
    # dtypes
    rows = rollout_dataset(str(tmp_path / "port"), list)
    assert [np.asarray(rows[0][k]).dtype for k in FRAG_KEYS] == [
        np.float32, np.int32, np.float32, np.float32]
    assert rows[0]["obs"].shape == (4,)


# --- chip_smoke.py's multiprocessing hooks, on the CPU ---------------------

@pytest.mark.parametrize("name", ["ppo", "impala", "dqn", "sac"])
def test_spawned_runner_hooks_give_the_in_process_run(name):
    import chip_smoke

    config = {
        "ppo": PPOConfig().env_runners(rollout_fragment_length=64).training(
            num_epochs=2, num_minibatches=2, hidden=HIDDEN),
        "impala": IMPALAConfig().env_runners(
            rollout_fragment_length=32).training(fragments_per_iter=3,
                                                  hidden=HIDDEN),
        "dqn": DQNConfig().env_runners(
            num_env_runners=2, rollout_fragment_length=64).training(
            learning_starts=64, train_batch_size=32, updates_per_iter=2,
            hidden=HIDDEN),
        "sac": SACConfig().env_runners(
            num_env_runners=2, rollout_fragment_length=64).training(
            learning_starts=64, train_batch_size=32, updates_per_iter=2,
            hidden=HIDDEN)}[name]
    runs, cuda_flags = chip_smoke.rl_in_process_and_spawned(torch, config, 2,
                                                            "cpu")
    assert cuda_flags == [False, False]
    spawned = runs["spawned"]
    assert any(not torch.equal(a, b) for a, b in zip(spawned[1], spawned[3]))
    if name != "impala":
        # IMPALA's order is the processes' completion order
        assert chip_smoke.rl_same_run(torch, runs["in_process"], spawned)
