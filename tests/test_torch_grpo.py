"""ray_tpu_torch.rllib.grpo against ray_tpu.rllib.grpo on the CPU, on
``tiny`` in f32 with JAX's weights carried over.

At temperature 0 the G rows of a group are the same tokens, so the policy
gradient sum_i adv_i grad log p_i has advantages summing to 0 over equal
terms: it is 0 up to rounding, and Adam, which divides by |g| + 1e-8,
turns that rounding into moves of up to lr either way, differently in
each framework. So ``GRPO.train`` at temperature 0 is compared where it
is defined (the tokens, rewards, and the first iteration's losses), and
the update itself on a batch of distinct rows, where the gradient is
real: losses and params to 1e-5 over two steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import LLAMA_CONFIGS as J_CONFIGS
from ray_tpu.models import init_params as j_init
from ray_tpu.rllib import GRPO as JGRPO
from ray_tpu.rllib import GRPOConfig as JGRPOConfig
from ray_tpu.rllib import grpo as j_grpo
from ray_tpu.rllib.grpo import _sample_group as j_sample_group

from ray_tpu_torch._private.tree import tree_leaves, tree_map, unstack_layers
from ray_tpu_torch.models import (LLAMA_CONFIGS, forward, params_from_jax,
                                  params_to_numpy)
from ray_tpu_torch.rllib import GRPO, GRPOConfig
from ray_tpu_torch.rllib.grpo import _grpo_loss, _grpo_update, _sample_group
from ray_tpu_torch.train import adamw

# six xdist workers share the machine's cores
torch.set_num_threads(2)

TINY, J_TINY = LLAMA_CONFIGS["tiny"], J_CONFIGS["tiny"]
F32 = dict(atol=1e-5, rtol=1e-5)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9]]


def _position_reward(completions):
    return [float(i % 8) for i in range(len(completions))]


@pytest.fixture(scope="module")
def weights():
    jp = j_init(jax.random.PRNGKey(0), J_TINY)
    return jp, jax.tree.map(np.asarray, jp)


def _port(np_params):
    return params_from_jax(np_params, device="cpu")


def test_sample_group_greedy_tokens_match(weights):
    jp, npp = weights
    tp = _port(npp)
    for prompt in PROMPTS:
        want = j_sample_group(jp, J_TINY, prompt, 3, 7, 0.0,
                              jax.random.PRNGKey(0))
        got = _sample_group(tp, TINY, prompt, 3, 7, 0.0, None)
        assert got[0].dtype == np.int32
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])


@pytest.mark.parametrize("temperature", [0.7, 1.5])
def test_sample_group_matches_by_distribution(weights, temperature):
    """The first sampled token's frequencies over 6000 rows against
    softmax(logits / T) of the prompt's last position (lm_head scaled by
    4 so that the distribution has mass to compare), for both packages;
    3.4 standard deviations at p = 0.3."""
    _, npp = weights
    npp = dict(npp, lm_head=npp["lm_head"] * 4.0)
    jp = jax.tree.map(jnp.asarray, npp)
    tp = _port(npp)
    prompt, N = [5, 9, 2], 6000
    logits = forward(tp, torch.tensor([prompt]), TINY)[0, -1].double()
    want = torch.softmax(logits / temperature, -1).numpy()
    assert want.max() > 0.1
    gen = torch.Generator().manual_seed(0)
    got = _sample_group(tp, TINY, prompt, N, 1, temperature, gen)[0][:, -1]
    jgot = j_sample_group(jp, J_TINY, prompt, N, 1, temperature,
                          jax.random.PRNGKey(0))[0][:, -1]
    for draws in (got, jgot):
        freq = np.bincount(draws, minlength=TINY.vocab) / N
        np.testing.assert_allclose(freq, want, atol=0.02)


def _distinct_batch(seed=0, B=6, S=12):
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, S), np.float32)
    for i, p in enumerate(rng.integers(2, 6, B)):
        mask[i, p:S - i % 3] = 1.0
    return {"tokens": rng.integers(0, TINY.vocab, (B, S)).astype(np.int32),
            "mask": mask,
            "advantages": rng.standard_normal(B).astype(np.float32)}


def _assert_adam_params_close(got_tree, want_tree, lr, steps):
    """Params after ``steps`` Adam steps: all but 0.1% of the elements to
    1e-5, and every element within Adam's bound of 2 lr a step. Adam
    divides by |g| + 1e-8, so an element whose gradient is near 0 (a few
    in ten thousand here) moves by a share of lr set by its gradient's
    last bits, which the two frameworks round differently."""
    got, want = jax.tree.leaves(got_tree), jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    n_off = n = 0
    for g, w in zip(got, want):
        d = np.abs(g - w)
        n_off += int((d > 1e-5 + 1e-5 * np.abs(w)).sum())
        n += d.size
        assert d.max() <= 2 * lr * steps
    assert n_off <= 1e-3 * n, (n_off, n)


def test_grpo_update_matches_the_reference(weights):
    """Two updates on a batch of distinct rows: the KL is exactly 0 in
    the first (the policy is the reference) and positive in the second;
    the losses, the gradients of the first step, and the params (see
    _assert_adam_params_close) match."""
    jp, npp = weights
    batch = _distinct_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tparams = tree_map(lambda t: t.requires_grad_(),
                       unstack_layers(_port(npp)))
    tref = _port(npp)
    # the first step's gradient, through the reference's own loss
    jgrad = jax.jit(jax.grad(lambda p: j_grpo._grpo_impl(
        p, jp, optax.adam(1e-3).init(p), jb, 1e-3, 0.5, J_TINY)[2][
            "total_loss"]))(jp)
    loss, _ = _grpo_loss(tparams, tref, tb, 0.5, TINY)
    tgrad = torch.autograd.grad(loss, tree_leaves(tparams))
    for g, w in zip(jax.tree.leaves(params_to_numpy(
            _restack_like(tparams, tgrad))), jax.tree.leaves(jgrad)):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-4)
    jopt = optax.adam(1e-3).init(jp)
    topt = adamw(1e-3, weight_decay=0.0).init(tparams)
    jpol = jp
    for step in range(2):
        jpol, jopt, jm = j_grpo._grpo_update(jpol, jp, jopt, jb, 1e-3,
                                             kl_coef=0.5, cfg=J_TINY)
        tparams, topt, m = _grpo_update(tparams, tref, topt, tb, 1e-3,
                                        kl_coef=0.5, cfg=TINY)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       err_msg=k, **F32)
        if step == 0:
            assert float(m["kl"]) == float(jm["kl"]) == 0.0
        else:
            assert float(m["kl"]) > 0 and float(jm["kl"]) > 0
    _assert_adam_params_close(params_to_numpy(tparams),
                              jax.tree.map(np.asarray, jpol), 1e-3, 2)


def _restack_like(params, leaves):
    """``leaves`` (in ``tree_leaves(params)`` order) in ``params``'s
    tree."""
    by_id = {id(p): g for p, g in zip(tree_leaves(params), leaves)}
    return tree_map(lambda p: by_id[id(p)], params)


def test_grpo_train_at_temperature_zero_matches_the_reference(weights):
    """Two iterations with the group-position reward: the same greedy
    completions and rewards in both; the first iteration's KL exactly 0
    and its mean log-prob to 1e-5; the policy gradient 0 up to rounding
    (see the module's docstring), so each update moves every param by
    at most about lr (Adam's bound) in both packages."""
    jp, npp = weights
    kw = dict(model="tiny", group_size=4, max_tokens=6, temperature=0.0,
              lr=1e-4, kl_coef=0.1, seed=0)
    ref = JGRPO(JGRPOConfig(**kw), params=jp)
    algo = GRPO(GRPOConfig(**kw), params=_port(npp), device="cpu")
    seen = {"ref": [], "port": []}

    def reward(name):
        def fn(completions):
            seen[name].append(completions)
            return _position_reward(completions)
        return fn

    p0 = jax.tree.leaves(npp)
    for it in range(2):
        want = ref.train(PROMPTS, reward("ref"))
        got = algo.train(PROMPTS, reward("port"))
        assert seen["port"] == seen["ref"]
        for k in ("reward_mean", "reward_std", "num_completions"):
            assert got[k] == want[k]
        if it == 0:
            assert got["kl"] == want["kl"] == 0.0
            np.testing.assert_allclose(got["mean_logp"], want["mean_logp"],
                                       **F32)
        assert abs(got["pg_loss"]) < 1e-6 and abs(want["pg_loss"]) < 1e-6
        for name, tree in (("port", params_to_numpy(algo.params)),
                           ("ref", jax.tree.map(np.asarray, ref.params))):
            move = max(float(np.abs(a - b).max())
                       for a, b in zip(jax.tree.leaves(tree), p0))
            assert move <= 1.1 * kw["lr"] * (it + 1), (name, move)


def test_reference_policy_is_a_copy_and_params_are_not_mutated(weights):
    _, npp = weights
    p = _port(npp)
    before = [t.clone() for t in tree_leaves(p)]
    algo = GRPO(GRPOConfig(model="tiny", group_size=4, max_tokens=4,
                           lr=1e-2, kl_coef=0.5, seed=1), params=p,
                device="cpu")
    policy = {t.data_ptr() for t in tree_leaves(algo.params)}
    ref = {t.data_ptr() for t in tree_leaves(algo.ref_params)}
    caller = {t.data_ptr() for t in tree_leaves(p)}
    assert not policy & ref and not policy & caller and not ref & caller
    for _ in range(2):
        algo.train(PROMPTS, lambda cs: [float(c.count(3)) + float(c[0] % 5)
                                        for c in cs])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p), before))
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(algo.ref_params), before))
    moved = params_to_numpy(algo.params)
    assert any(not np.array_equal(a, b.numpy()) for a, b in zip(
        jax.tree.leaves(moved), before))
    assert algo.train(PROMPTS, _position_reward)["kl"] > 0


def test_grpo_increases_reward_on_token_objective():
    """The port's copy of ray_tpu's test: reward = count of a target
    token; group-relative updates must raise the mean reward."""
    target = 7

    def reward_fn(completions):
        return [float(sum(1 for t in c if t == target))
                for c in completions]

    algo = GRPOConfig(model="tiny", group_size=8, max_tokens=8,
                      lr=5e-3, kl_coef=0.0, seed=3).build(device="cpu")
    prompts = [[1, 2, 3], [4, 5, 6]]
    first = algo.train(prompts, reward_fn)
    rewards = [first["reward_mean"]]
    for _ in range(12):
        rewards.append(algo.train(prompts, reward_fn)["reward_mean"])
    assert max(rewards[-4:]) > rewards[0] + 0.5, rewards
    assert np.isfinite(rewards).all()


def test_grpo_handles_mixed_prompt_lengths():
    algo = GRPOConfig(model="tiny", group_size=4, max_tokens=4,
                      seed=9).build(device="cpu")
    res = algo.train([[1, 2], [3, 4, 5, 6], [7]],
                     lambda cs: [float(len(c)) for c in cs])
    assert res["num_completions"] == 12
    assert np.isfinite(res["total_loss"])
    assert set(res["timers"]) == {"sample_ms", "update_ms"}
