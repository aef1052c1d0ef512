"""ray_tpu_torch.rllib against ray_tpu.rllib on the CPU: the envs, the
networks, every learner update from the same params and batch, the
optimizer, PPO's train loop against the reference's pieces run
in-process, and checkpoints.

JAX runs on the CPU; the port with ``device="cpu"``. Params cross over
with ``params_from_jax`` (JAX init) or go the other way as numpy (port
init). Tolerances: 1e-5 absolute and relative on f32 params and losses
after a few Adam steps of a small MLP (sums taken in another order; Adam
scales each step to about lr, so a difference in a gradient's last bits
moves a param by far less than 1e-5), 1e-6 on one forward.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rllib import appo as j_appo
from ray_tpu.rllib import dqn as j_dqn
from ray_tpu.rllib import env as j_env
from ray_tpu.rllib import impala as j_impala
from ray_tpu.rllib import offline as j_offline
from ray_tpu.rllib import ppo as j_ppo
from ray_tpu.rllib import sac as j_sac

from ray_tpu_torch._private.tree import tree_leaves, unstack_layers
from ray_tpu_torch.models import opt_state_from_jax, params_from_jax
from ray_tpu_torch.rllib import (APPOConfig, BCConfig, DQNConfig,
                                 IMPALAConfig, MARWILConfig, PPOConfig,
                                 SACConfig, make_env, record_rollouts)
from ray_tpu_torch.rllib import dqn, env, impala, offline, ppo, sac
from ray_tpu_torch.rllib.checkpoint import host_copy, on_device, to_numpy
from ray_tpu_torch.rllib.dqn import DQN
from ray_tpu_torch.rllib.ppo import PPO
from ray_tpu_torch.train import adamw

# six xdist workers share the machine's cores
torch.set_num_threads(2)

F32 = dict(atol=1e-5, rtol=1e-5)
HIDDEN = (32, 32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cpu(np_tree, grad=True):
    return on_device(params_from_jax(np_tree, device="cpu"),
                     torch.device("cpu"), grad=grad)


def _assert_trees_close(port_tree, ref_tree, **tol):
    got = tree_leaves(to_numpy(port_tree))
    want = jax.tree.leaves(_np(ref_tree))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **(tol or F32))


def _assert_metrics_close(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   err_msg=k, **(tol or F32))


# --- envs -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["CartPole-v1", "Pendulum-v1"])
def test_env_trajectories_bit_equal(name):
    ours, ref = env.make_env(name, seed=5), j_env.make_env(name, seed=5)
    rng = np.random.default_rng(0)
    a, b = ours.reset(seed=5)[0], ref.reset(seed=5)[0]
    assert a.dtype == b.dtype and np.array_equal(a, b)
    for _ in range(700):       # past CartPole's and Pendulum's caps
        act = (int(rng.integers(2)) if name == "CartPole-v1"
               else rng.uniform(-2.5, 2.5, 1))
        got, want = ours.step(act), ref.step(act)
        assert np.array_equal(got[0], want[0])
        assert got[1:4] == want[1:4]
        if got[2] or got[3]:
            assert np.array_equal(ours.reset()[0], ref.reset()[0])


def test_make_env_passes_the_seed_to_a_factory():
    def factory(seed=None):
        return env.CartPole(seed=seed)

    a, b = make_env(factory, seed=3), j_env.make_env(factory, seed=3)
    assert np.array_equal(a.reset()[0], b.reset()[0])
    with pytest.raises(ValueError):
        make_env("NoSuchEnv-v0")


# --- networks ----------------------------------------------------------------

def _j_policy(seed=0, obs_dim=4, act_dim=2):
    return j_ppo.init_policy(jax.random.PRNGKey(seed), obs_dim, act_dim,
                             HIDDEN)


def test_policy_and_q_forward_match():
    jp = _j_policy()
    tp = _cpu(_np(jp), grad=False)
    obs = np.random.default_rng(1).standard_normal((16, 4)).astype(
        np.float32)
    logits, value = ppo.policy_forward(tp, torch.from_numpy(obs))
    jl, jv = j_ppo.policy_forward(jp, jnp.asarray(obs))
    np.testing.assert_allclose(logits.numpy(), jl, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(value.numpy(), jv, atol=1e-6, rtol=1e-6)
    q = dqn.q_forward(tp, torch.from_numpy(obs))
    np.testing.assert_allclose(q.numpy(), j_dqn.q_forward(jp, obs),
                               atol=1e-6, rtol=1e-6)


def test_sac_networks_match():
    jp = j_sac.init_sac_params(jax.random.PRNGKey(2), 3, 1, HIDDEN)
    tp = _cpu(_np(jp), grad=False)
    assert tp["log_alpha"].dtype == torch.float32
    rng = np.random.default_rng(2)
    obs = rng.standard_normal((8, 3)).astype(np.float32)
    act = rng.uniform(-1, 1, (8, 1)).astype(np.float32)
    mu, log_std = sac.actor_dist(tp, torch.from_numpy(obs))
    jmu, jls = j_sac.actor_dist(jp, obs)
    np.testing.assert_allclose(mu.numpy(), jmu, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(log_std.numpy(), jls, atol=1e-6, rtol=1e-6)
    q = sac._q(tp["q1"], torch.from_numpy(obs), torch.from_numpy(act))
    np.testing.assert_allclose(q.numpy(), j_sac._q(jp["q1"], obs, act),
                               atol=1e-6, rtol=1e-6)
    # the reparameterised sample with the reference's own draws
    key = jax.random.PRNGKey(7)
    ja, jlogp = j_sac.sample_action(jp, obs, key)
    eps = jax.random.normal(key, jmu.shape)
    a, logp = sac.sample_action(tp, torch.from_numpy(obs),
                                torch.from_numpy(np.array(eps)))
    np.testing.assert_allclose(a.numpy(), ja, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(logp.numpy(), jlogp, atol=1e-5, rtol=1e-5)


def test_gae_vtrace_and_mc_returns_match():
    rng = np.random.default_rng(3)
    T = 40
    rew = rng.standard_normal(T).astype(np.float32)
    val = rng.standard_normal(T).astype(np.float32)
    done = (rng.random(T) < 0.1).astype(np.float32)
    for got, want in zip(ppo._gae(rew, val, done, np.float32(0.3), 0.99,
                                  0.95),
                         j_ppo._gae(rew, val, done, np.float32(0.3), 0.99,
                                    0.95)):
        assert np.array_equal(got, want)
    assert np.array_equal(offline._mc_returns(rew, done, 0.9),
                          j_offline._mc_returns(rew, done, 0.9))
    # the reference's reverse scan, written out
    deltas, coefs = rng.standard_normal(T), rng.random(T)
    want, acc = np.zeros(T), 0.0
    for t in range(T - 1, -1, -1):
        acc = deltas[t] + coefs[t] * acc
        want[t] = acc
    got = impala.vtrace(torch.from_numpy(deltas), torch.from_numpy(coefs))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)


# --- the optimizer -----------------------------------------------------------

def test_adamw_without_decay_is_optax_adam():
    rng = np.random.default_rng(4)
    params = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "layers": [{"w": rng.standard_normal(4).astype(np.float32)}]}
    jp, jopt = params, optax.adam(1e-2).init(params)
    tp = on_device(params, torch.device("cpu"))
    opt = adamw(1e-2, weight_decay=0.0)
    state = opt.init(tp)
    for step in range(3):
        grads = jax.tree.map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32), jp)
        upd, jopt = optax.adam(1e-2).update(grads, jopt, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update_(tp, [torch.from_numpy(g)
                         for g in jax.tree.leaves(grads)], state)
        _assert_trees_close(tp, jp, atol=1e-7, rtol=1e-6)
    assert state.count == int(jopt[0].count) == 3


# --- updates -----------------------------------------------------------------

def _ppo_batch(n=64, seed=5):
    rng = np.random.default_rng(seed)
    return {"obs": rng.standard_normal((n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n).astype(np.int32),
            "logp": np.log(rng.uniform(0.3, 0.7, n)).astype(np.float32),
            "advantages": rng.standard_normal(n).astype(np.float32),
            "returns": rng.standard_normal(n).astype(np.float32)}


@pytest.mark.parametrize("n_epochs", [1, 3])
def test_ppo_update_matches(n_epochs):
    """At one minibatch the shuffle only reorders the batch: the update
    is the reference's whatever the permutation."""
    jp = _j_policy(6)
    batch = _ppo_batch()
    tp = _cpu(_np(jp))
    kw = dict(clip=0.2, vf_coef=0.5, ent_coef=0.01, n_minibatches=1,
              n_epochs=n_epochs)
    jp2, jopt, jm = j_ppo.ppo_update(
        jp, optax.adam(3e-3).init(jp), {k: jnp.asarray(v) for k, v in
                                        batch.items()},
        jax.random.PRNGKey(0), 3e-3, **kw)
    opt = adamw(3e-3, weight_decay=0.0).init(tp)
    tp, opt, m = ppo.ppo_update(tp, opt, ppo.batch_to(batch, "cpu"),
                                torch.Generator().manual_seed(0), 3e-3, **kw)
    _assert_trees_close(tp, jp2)
    _assert_metrics_close(m, jm)
    assert opt.count == n_epochs


def test_ppo_update_shuffles_from_its_generator():
    """At several minibatches the order matters; the same generator seed
    gives the same update, another seed another one."""
    jp = _j_policy(6)
    batch = ppo.batch_to(_ppo_batch(), "cpu")
    kw = dict(clip=0.2, vf_coef=0.5, ent_coef=0.01, n_minibatches=4,
              n_epochs=2)
    runs = []
    for seed in (1, 1, 2):
        tp = _cpu(_np(jp))
        ppo.ppo_update(tp, adamw(3e-3, weight_decay=0.0).init(tp), batch,
                       torch.Generator().manual_seed(seed), 3e-3, **kw)
        runs.append(tree_leaves(to_numpy(tp)))
    assert all(np.array_equal(a, b) for a, b in zip(runs[0], runs[1]))
    assert not all(np.array_equal(a, b) for a, b in zip(runs[0], runs[2]))


def _frag(n=48, seed=7):
    rng = np.random.default_rng(seed)
    return {"obs": rng.standard_normal((n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n).astype(np.int32),
            "rewards": rng.standard_normal(n).astype(np.float32),
            "dones": (rng.random(n) < 0.1).astype(np.float32),
            "logp": np.log(rng.uniform(0.3, 0.7, n)).astype(np.float32),
            "bootstrap_value": np.float32(0.4)}


@pytest.mark.parametrize("clip_param", [0.0, 0.3])
def test_impala_and_appo_updates_match(clip_param):
    jp = _j_policy(8)
    frag = _frag()
    kw = dict(gamma=0.99, vf_coef=0.5, ent_coef=0.01, rho_bar=1.0,
              c_bar=0.9, clip_param=clip_param)
    tp = _cpu(_np(jp))
    opt = adamw(1e-3, weight_decay=0.0).init(tp)
    jopt = optax.adam(1e-3).init(jp)
    for _ in range(2):
        jp, jopt, jm = j_impala.impala_update(
            jp, jopt, {k: jnp.asarray(v) for k, v in frag.items()}, 1e-3,
            **kw)
        tp, opt, m = impala.impala_update(tp, opt, ppo.batch_to(frag, "cpu"),
                                          1e-3, **kw)
        _assert_metrics_close(m, jm)
    _assert_trees_close(tp, jp)
    assert j_appo.APPOConfig().clip_param == APPOConfig().clip_param > 0


def test_dqn_update_matches():
    jp = _j_policy(9)
    jt = _j_policy(10)
    rng = np.random.default_rng(9)
    n = 64
    batch = {"obs": rng.standard_normal((n, 4)).astype(np.float32),
             "next_obs": rng.standard_normal((n, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, n).astype(np.int32),
             "rewards": rng.standard_normal(n).astype(np.float32),
             "dones": (rng.random(n) < 0.2).astype(np.float32)}
    tp, tt = _cpu(_np(jp)), _cpu(_np(jt), grad=False)
    jp2, _, jm = j_dqn.dqn_update(
        jp, jt, optax.adam(1e-3).init(jp),
        {k: jnp.asarray(v) for k, v in batch.items()}, 1e-3, gamma=0.99,
        n_updates=4)
    _, _, m = dqn.dqn_update(tp, tt, adamw(1e-3, weight_decay=0.0).init(tp),
                             ppo.batch_to(batch, "cpu"), 1e-3, gamma=0.99,
                             n_updates=4)
    _assert_trees_close(tp, jp2)
    _assert_metrics_close(m, jm)


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


def test_sac_update_matches_with_the_reference_noise():
    jp = j_sac.init_sac_params(jax.random.PRNGKey(11), 3, 1, HIDDEN)
    jtgt = {"q1": jp["q1"], "q2": jp["q2"]}
    rng = np.random.default_rng(11)
    n, n_updates = 64, 4
    batch = {"obs": rng.standard_normal((n, 3)).astype(np.float32),
             "next_obs": rng.standard_normal((n, 3)).astype(np.float32),
             "actions": rng.uniform(-1, 1, (n, 1)).astype(np.float32),
             "rewards": rng.standard_normal(n).astype(np.float32),
             "dones": (rng.random(n) < 0.1).astype(np.float32)}
    kw = dict(lr=3e-3, gamma=0.99, tau=0.05, target_entropy=-1.0)
    key = jax.random.PRNGKey(12)
    jp2, jt2, _, jm = j_sac.sac_update(
        jp, jtgt, optax.adam(3e-3).init(jp),
        {k: jnp.asarray(v) for k, v in batch.items()}, key,
        n_updates=n_updates, **kw)
    tp = _cpu(_np(jp))
    tt = {k: _cpu(_np(jp[k]), grad=False) for k in ("q1", "q2")}
    _, tt, _, m = sac.sac_update_with_noise(
        tp, tt, adamw(3e-3, weight_decay=0.0).init(tp),
        ppo.batch_to(batch, "cpu"),
        _reference_sac_noise(key, n_updates, n // n_updates, 1), **kw)
    _assert_trees_close(tp, jp2)
    _assert_trees_close(tt, jt2)
    _assert_metrics_close(m, jm)


@pytest.mark.parametrize("beta", [0.0, 1.0])
def test_marwil_and_bc_updates_match(beta):
    jp = _j_policy(13)
    rng = np.random.default_rng(13)
    n = 64
    batch = {"obs": rng.standard_normal((n, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, n).astype(np.int32),
             "returns": (rng.standard_normal(n) * 5).astype(np.float32)}
    tp = _cpu(_np(jp))
    opt = adamw(1e-3, weight_decay=0.0).init(tp)
    jopt = optax.adam(1e-3).init(jp)
    for _ in range(2):
        jp, jopt, jm = j_offline._marwil_update(
            jp, jopt, {k: jnp.asarray(v) for k, v in batch.items()}, 1e-3,
            beta=beta, vf_coef=1.0)
        tp, opt, m = offline._marwil_update(
            tp, opt, ppo.batch_to(batch, "cpu"), 1e-3, beta=beta,
            vf_coef=1.0)
        _assert_metrics_close(m, jm)
    _assert_trees_close(tp, jp)
    assert BCConfig().beta == j_offline.BCConfig().beta == 0.0


# --- algorithms --------------------------------------------------------------

def test_ppo_train_matches_the_reference_sequence():
    """PPO.train() twice against the reference's own pieces run
    in-process: its EnvRunner sampling with the same seeds and weights,
    _gae, then ppo_update at one minibatch."""
    cfg = PPOConfig().env_runners(num_env_runners=2,
                                  rollout_fragment_length=64).training(
        num_minibatches=1, num_epochs=2, hidden=HIDDEN, seed=4)
    algo = cfg.build(device="cpu")
    jp = jax.tree.map(jnp.asarray, to_numpy(algo.params))
    jopt = optax.adam(cfg.lr).init(jp)
    runners = [j_ppo.EnvRunner(cfg.env, cfg.hidden, cfg.seed + 100 + i)
               for i in range(cfg.num_env_runners)]
    for it in range(2):
        for r in runners:
            r.set_params(_np(jp))
        frags = [r.sample(cfg.rollout_fragment_length) for r in runners]
        ours = [r.sample(cfg.rollout_fragment_length)
                for r in _runner_twins(algo)]
        for a, b in zip(ours, frags):
            for k in ("obs", "actions", "rewards", "dones"):
                assert np.array_equal(a[k], b[k]), (it, k)
            for k in ("logp", "values"):
                # f32 forwards of an MLP in two frameworks (and, in the
                # second iteration, of params updated by each)
                np.testing.assert_allclose(a[k], b[k], **F32)
        parts = [j_ppo._gae(f["rewards"], f["values"], f["dones"],
                            f["bootstrap_value"], cfg.gamma, cfg.lambda_)
                 for f in frags]
        batch = {"obs": np.concatenate([f["obs"] for f in frags]),
                 "actions": np.concatenate([f["actions"] for f in frags]),
                 "logp": np.concatenate([f["logp"] for f in frags]),
                 "advantages": np.concatenate([p[0] for p in parts]),
                 "returns": np.concatenate([p[1] for p in parts])}
        jp, jopt, jm = j_ppo.ppo_update(
            jp, jopt, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(it), cfg.lr, clip=cfg.clip_param,
            vf_coef=cfg.vf_loss_coeff, ent_coef=cfg.entropy_coeff,
            n_minibatches=1, n_epochs=cfg.num_epochs)
        m = algo.train()
        assert m["timesteps_this_iter"] == 128
        for k in ("total_loss", "policy_loss", "vf_loss", "entropy"):
            np.testing.assert_allclose(m[k], float(jm[k]), err_msg=k, **F32)
        _assert_trees_close(algo.params, jp)


def _runner_twins(algo):
    """Copies of the algorithm's runners as they stand (env state, rng,
    weights), sampled here without touching the originals."""
    return [pickle.loads(pickle.dumps(r)) for r in algo.runners]


@pytest.mark.parametrize("make", [
    lambda: PPOConfig().env_runners(rollout_fragment_length=32).training(
        num_epochs=2, num_minibatches=2, hidden=HIDDEN),
    lambda: IMPALAConfig().env_runners(rollout_fragment_length=32).training(
        fragments_per_iter=3, hidden=HIDDEN),
    lambda: APPOConfig().env_runners(rollout_fragment_length=32).training(
        fragments_per_iter=3, hidden=HIDDEN),
    lambda: DQNConfig().env_runners(rollout_fragment_length=64).training(
        learning_starts=64, train_batch_size=32, updates_per_iter=2,
        target_update_interval=1, hidden=HIDDEN),
    lambda: SACConfig().env_runners(rollout_fragment_length=64).training(
        learning_starts=64, train_batch_size=32, updates_per_iter=2,
        hidden=HIDDEN),
], ids=["ppo", "impala", "appo", "dqn", "sac"])
def test_algorithms_train_and_move_their_params(make):
    algo = make().build(device="cpu")
    before = tree_leaves(to_numpy(algo.params))
    for _ in range(2):
        m = algo.train()
    losses = [v for k, v in m.items() if "loss" in k]
    assert losses and np.isfinite(losses).all()
    after = tree_leaves(to_numpy(algo.params))
    assert any(not np.array_equal(a, b) for a, b in zip(before, after))
    # every runner acts with the learner's current weights (or, for
    # IMPALA, with those it got when it was last drained)
    assert all(r._params is not None for r in algo.runners)
    if hasattr(algo, "target_params"):
        # a copy: the online net's updates do not move it
        assert all(a.data_ptr() != b.data_ptr() for a, b in zip(
            tree_leaves(algo.target_params), tree_leaves(algo.params)))
    algo.stop()


def test_offline_bc_and_marwil_train_on_recorded_rollouts(tmp_path):
    teacher = ppo.init_policy(torch.Generator().manual_seed(0), 4, 2, HIDDEN)
    shards = record_rollouts("CartPole-v1", str(tmp_path), num_steps=600,
                             policy_params=teacher, hidden=HIDDEN,
                             seed=1, shard_steps=256)
    assert len(shards) == 3
    ours = offline.read_rollouts(str(tmp_path))
    j_offline.record_rollouts("CartPole-v1", str(tmp_path / "ref"),
                              num_steps=600, seed=1, shard_steps=256)
    ref = j_offline.read_rollouts(str(tmp_path / "ref"))
    rnd = offline.record_rollouts("CartPole-v1", str(tmp_path / "rnd"),
                                  num_steps=600, seed=1, shard_steps=256)
    assert len(rnd) == 3
    rnd = offline.read_rollouts(str(tmp_path / "rnd"))
    # a random policy's rollouts are the reference's, bit for bit
    for k in ref:
        assert np.array_equal(rnd[k], ref[k])
    assert len(ours["actions"]) == 600
    for cfg_cls in (BCConfig, MARWILConfig):
        algo = (cfg_cls().offline_data(str(tmp_path)).training(
            hidden=HIDDEN, train_batch_size=128).build(device="cpu"))
        ms = [algo.train() for _ in range(2)]
        assert np.isfinite(ms[-1]["total_loss"])
        assert algo.evaluate(episodes=1)["episodes"] == 1


# --- checkpoints and the optimizer state carried over ----------------------

def test_checkpoint_roundtrip(tmp_path):
    algo = (DQNConfig().env_runners(rollout_fragment_length=64).training(
        learning_starts=32, train_batch_size=32, updates_per_iter=2,
        seed=11, hidden=HIDDEN)).build(device="cpu")
    for _ in range(3):
        algo.train()
    path = algo.save_to_path(str(tmp_path / "ck"))
    algo2 = DQN.from_checkpoint(path, device="cpu")
    assert algo2.iteration == algo.iteration == 3
    for name in ("params", "target_params"):
        for a, b in zip(tree_leaves(getattr(algo, name)),
                        tree_leaves(getattr(algo2, name))):
            assert torch.equal(a, b)
    assert algo2.opt_state.count == algo.opt_state.count
    for a, b in zip(tree_leaves([algo.opt_state.mu, algo.opt_state.nu]),
                    tree_leaves([algo2.opt_state.mu, algo2.opt_state.nu])):
        assert torch.equal(a, b)
    assert all(p.requires_grad for p in tree_leaves(algo2.params))
    assert algo2.train()["training_iteration"] == 4
    # restore in place, over a fresh algorithm
    algo3 = PPOConfig().training(hidden=HIDDEN).build(device="cpu")
    algo3.save_to_path(str(tmp_path / "ppo"))
    p0 = to_numpy(algo3.params)
    algo3.train()
    algo3.restore_from_path(str(tmp_path / "ppo"))
    for a, b in zip(tree_leaves(to_numpy(algo3.params)), tree_leaves(p0)):
        assert np.array_equal(a, b)
    assert algo3.iteration == 0


def _module_level_factory(seed=None):
    return env.CartPole(seed=seed)


def test_checkpoint_refuses_a_lambda_env_factory(tmp_path):
    algo = PPOConfig().environment(
        lambda seed=None: env.CartPole(seed=seed)).training(
        hidden=HIDDEN).build(device="cpu")
    with pytest.raises(ValueError, match="lambda"):
        algo.save_to_path(str(tmp_path / "ck"))
    assert not (tmp_path / "ck" / "algorithm_state.pkl").exists()
    # a module-level factory pickles by reference
    algo = PPOConfig().environment(_module_level_factory).training(
        hidden=HIDDEN).build(device="cpu")
    path = algo.save_to_path(str(tmp_path / "ok"))
    assert PPO.from_checkpoint(path, device="cpu").iteration == 0


def test_reference_learner_state_resumes_in_the_port():
    """A reference PPO learner's params and optax adam state, one update
    in, carried over (lists in the tree, adam's chain, its count): the
    next update matches the reference's."""
    jp = _j_policy(14)
    batch = _ppo_batch(seed=14)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    kw = dict(clip=0.2, vf_coef=0.5, ent_coef=0.01, n_minibatches=1,
              n_epochs=1)
    jp, jopt, _ = j_ppo.ppo_update(jp, optax.adam(1e-3).init(jp), jb,
                                   jax.random.PRNGKey(0), 1e-3, **kw)
    tp = _cpu(_np(jp))
    assert isinstance(tp["layers"], list) and len(tp["layers"]) == 2
    opt = opt_state_from_jax(_np(jopt), tp, device="cpu")
    assert opt.count == 1
    jp, jopt, _ = j_ppo.ppo_update(jp, jopt, jb, jax.random.PRNGKey(1),
                                   1e-3, **kw)
    ppo.ppo_update(tp, opt, ppo.batch_to(batch, "cpu"),
                   torch.Generator().manual_seed(1), 1e-3, **kw)
    _assert_trees_close(tp, jp)
    assert opt.count == 2
    # SAC's tree: no "layers" key, lists under "actor"/"q1"/"q2", a
    # scalar log_alpha
    js = j_sac.init_sac_params(jax.random.PRNGKey(15), 3, 1, HIDDEN)
    ts = _cpu(_np(js))
    sopt = opt_state_from_jax(_np(optax.adam(1e-3).init(js)), ts,
                              device="cpu")
    assert len(tree_leaves(sopt.mu)) == len(tree_leaves(ts))


def test_unstack_layers_leaves_a_list_of_layers_alone():
    tree = {"layers": [{"w": torch.zeros(4, 8)}, {"w": torch.zeros(8, 8)}],
            "pi": {"w": torch.zeros(8, 2)}}
    out = unstack_layers(tree)
    assert out["layers"] is tree["layers"]


def test_runners_act_on_host_copies():
    algo = PPOConfig().training(hidden=HIDDEN).build(device="cpu")
    host = algo.runners[0]._params
    assert all(a.device.type == "cpu" and not a.requires_grad
               and a.data_ptr() != b.data_ptr()
               for a, b in zip(tree_leaves(host), tree_leaves(algo.params)))
    assert all(torch.equal(a, b.detach()) for a, b in zip(
        tree_leaves(host_copy(algo.params)), tree_leaves(algo.params)))
