"""ray_tpu_torch's trainer against ray_tpu's on the same weights and
batches (CPU): three AdamW steps of lm_loss on ``tiny`` f32, and a run
resumed from a JAX state at ``count = 2``.

Weights and optimizer state cross over with ``params_from_jax`` and
``opt_state_from_jax``; the port runs with ``device="cpu"``, where
attention and its backward take the kernels' plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import LLAMA_CONFIGS as J_CONFIGS
from ray_tpu.models import init_params as j_init
from ray_tpu.models import lm_loss as j_lm_loss
from ray_tpu.models import param_logical_axes
from ray_tpu.parallel import MeshSpec, build_mesh
from ray_tpu.train import make_train_step as j_make_train_step

from ray_tpu_torch._private.tree import tree_leaves, unstack_layers
from ray_tpu_torch.models import (LLAMA_CONFIGS, init_params, lm_loss,
                                  opt_state_from_jax, params_from_jax,
                                  params_to_numpy)
from ray_tpu_torch.train import (AdamW, adamw, estimate_flops_per_token,
                                 make_eval_step, make_train_step)

# six xdist workers share the machine's cores
torch.set_num_threads(2)

TINY = LLAMA_CONFIGS["tiny"]
J_TINY = J_CONFIGS["tiny"]
F32 = dict(atol=1e-5, rtol=1e-5)
N_STEPS = 3


def _batch(i):
    """Step i's batch; the second one carries a mask. Adam divides by
    |g| + 1e-8, so an element whose gradient is f32 cancellation noise
    (|g| below ~1e-7, either sign on either side) moves by up to lr in
    either direction; the seeds give batches where no gradient of the
    three steps lies that low, so the params agree at 1e-5."""
    rng = np.random.default_rng(36 + i)
    batch = {"tokens": rng.integers(0, TINY.vocab, (2, 24)).astype(np.int32)}
    if i == 1:
        mask = np.ones((2, 24), np.int32)
        mask[0, 14:] = 0
        batch["mask"] = mask
    return batch


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_run():
    """ray_tpu's trainer: optax.adamw(1e-3), 3 steps on one CPU device.
    Returns the initial params, and after every step the metrics, params
    and optimizer state, as numpy."""
    cfg = J_TINY
    mesh = build_mesh(MeshSpec(), [jax.devices("cpu")[0]])
    init_fn, step_fn, place_batch = j_make_train_step(
        lambda p, b: j_lm_loss(p, b, cfg), optax.adamw(1e-3), mesh,
        param_logical_axes(cfg))
    params = j_init(jax.random.PRNGKey(0), cfg)
    run = {"params0": _np_tree(params), "steps": []}
    state = init_fn(params)
    for i in range(N_STEPS):
        state, m = step_fn(state, place_batch(
            {k: jnp.asarray(v) for k, v in _batch(i).items()}))
        run["steps"].append({"metrics": _np_tree(m),
                             "params": _np_tree(state.params),
                             "opt_state": _np_tree(state.opt_state)})
    return run


def _port_step(device="cpu"):
    return make_train_step(lambda p, b: lm_loss(p, b, TINY), adamw(1e-3),
                           device=device)


def _check_metrics(got, want, step):
    assert int(got["step"]) == int(want["step"]) == step
    np.testing.assert_allclose(got["loss"].item(), want["loss"], **F32)
    np.testing.assert_allclose(got["grad_norm"].item(), want["grad_norm"],
                               **F32)


def _check_params(got, want):
    got = params_to_numpy(got)
    for k in want:
        if k == "layers":
            for name in want[k]:
                np.testing.assert_allclose(got[k][name], want[k][name],
                                           err_msg=name, **F32)
        else:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **F32)


def test_train_steps_match_jax(jax_run):
    """loss, grad_norm and step at every step, and the params after the
    third, against ray_tpu's trainer at 1e-5."""
    init_fn, step_fn, place_batch = _port_step()
    stacked = params_from_jax(jax_run["params0"], device="cpu")
    state = init_fn(stacked)
    for i in range(N_STEPS):
        state, metrics = step_fn(state, place_batch(_batch(i)))
        assert metrics["loss"].grad_fn is None
        _check_metrics(metrics, jax_run["steps"][i]["metrics"], i + 1)
    assert state.opt_state.count == N_STEPS
    _check_params(state.params, jax_run["steps"][-1]["params"])
    # the updates landed in the stacked leaves the caller passed in
    np.testing.assert_array_equal(params_to_numpy(stacked)["layers"]["wq"],
                                  params_to_numpy(state.params)["layers"]
                                  ["wq"])


def test_resume_from_jax_state_at_count_2(jax_run):
    """The JAX params and optax state after two steps, carried over with
    opt_state_from_jax: the third step (bias correction at count 3)
    matches ray_tpu's."""
    init_fn, step_fn, place_batch = _port_step()
    after2 = jax_run["steps"][1]
    state = init_fn(params_from_jax(after2["params"], device="cpu"))
    opt = opt_state_from_jax(after2["opt_state"], state.params, "cpu")
    assert opt.count == 2
    assert len(opt.mu["layers"]) == TINY.n_layers
    state = state._replace(step=torch.tensor(2, dtype=torch.int32),
                           opt_state=opt)
    state, metrics = step_fn(state, place_batch(_batch(2)))
    _check_metrics(metrics, jax_run["steps"][2]["metrics"], 3)
    _check_params(state.params, jax_run["steps"][2]["params"])
    # the carried moments match optax's after its third update too
    want_mu = after2["opt_state"][0].mu
    mu = params_to_numpy(opt.mu)
    assert not np.allclose(mu["layers"]["wq"], want_mu["layers"]["wq"])
    np.testing.assert_allclose(
        mu["layers"]["wq"],
        jax_run["steps"][2]["opt_state"][0].mu["layers"]["wq"], **F32)


def test_opt_state_from_jax_refuses_a_mismatched_state(jax_run):
    init_fn, _, _ = _port_step()
    state = init_fn(params_from_jax(jax_run["params0"], device="cpu"))
    with pytest.raises(ValueError):
        opt_state_from_jax((optax.EmptyState(),), state.params, "cpu")
    wider = dataclasses.replace(J_TINY, mlp_dim=2 * J_TINY.mlp_dim)
    bad = _np_tree(optax.adamw(1e-3).init(j_init(jax.random.PRNGKey(0),
                                                 wider)))
    with pytest.raises(ValueError):
        opt_state_from_jax(bad, state.params, "cpu")


def test_adamw_matches_optax_on_one_tensor():
    """optax's defaults (weight_decay 1e-4, not torch's 1e-2) and update,
    weight decay and bias correction included, over four steps."""
    assert AdamW(1e-3) == adamw(1e-3) and adamw(1e-3).weight_decay == 1e-4
    rng = np.random.default_rng(40)
    w = rng.standard_normal((5, 7)).astype(np.float32)
    grads = rng.standard_normal((4, 5, 7)).astype(np.float32)
    tx = optax.adamw(3e-3, weight_decay=0.1)
    jw, js = jnp.asarray(w), tx.init(jnp.asarray(w))
    opt = adamw(3e-3, weight_decay=0.1)
    tw = {"w": torch.from_numpy(w.copy())}
    ts = opt.init(tw)
    for g in grads:
        upd, js = tx.update(jnp.asarray(g), js, jw)
        jw = optax.apply_updates(jw, upd)
        opt.update_(tw, [torch.from_numpy(g)], ts)
    np.testing.assert_allclose(tw["w"].numpy(), np.asarray(jw), **F32)
    np.testing.assert_allclose(ts.nu["w"].numpy(), np.asarray(js[0].nu),
                               **F32)


def test_eval_step_flops_and_place_batch():
    params = init_params(TINY, seed=5, device="cpu")
    batch = _batch(0)
    eval_fn = make_eval_step(lambda p, b: lm_loss(p, b, TINY))
    loss = eval_fn(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert loss.grad_fn is None and torch.isfinite(loss)
    init_fn, step_fn, place_batch = make_train_step(
        lambda p, b: lm_loss(p, b, TINY), adamw(1e-3), device="cpu",
        model_flops_per_token=estimate_flops_per_token(TINY.n_params()))
    assert step_fn.model_flops_per_token == 6.0 * TINY.n_params()
    placed = place_batch(batch)
    assert placed["tokens"].dtype == torch.int32
    assert placed["tokens"].device.type == "cpu"
    state = init_fn(params)
    assert isinstance(state.params["layers"], list)
    assert all(t.is_leaf and t.requires_grad
               for lp in state.params["layers"] for t in lp.values())
    # the per-layer leaves share the stacked storage
    assert (state.params["layers"][1]["wq"].data_ptr()
            == params["layers"]["wq"][1].data_ptr())
    np.testing.assert_allclose(
        eval_fn(state.params, placed).item(), loss.item(), rtol=1e-6)


def test_grad_norm_in_bf16_is_an_f32_sum_where_optax_sums_in_bf16():
    """``tiny`` in bf16, one step from the same weights and batch: the
    port's grad_norm is an f32 sum of squares over its own gradients (to
    1e-6 relative); ray_tpu reports optax.global_norm, summed in the leaf
    dtype (bf16), so the two agree only to bf16's precision (2e-2
    relative, the bf16 tolerance of the kernel tests). No update reads the
    norm."""
    jcfg = dataclasses.replace(J_TINY, dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(TINY, dtype=torch.bfloat16)
    jparams = j_init(jax.random.PRNGKey(1), jcfg)
    weights = _np_tree(jparams)
    batch = _batch(0)
    mesh = build_mesh(MeshSpec(), [jax.devices("cpu")[0]])
    init_fn, step_fn, place_batch = j_make_train_step(
        lambda p, b: j_lm_loss(p, b, jcfg), optax.adamw(1e-3), mesh,
        param_logical_axes(jcfg))
    _, m = step_fn(init_fn(jparams), place_batch(
        {k: jnp.asarray(v) for k, v in batch.items()}))
    assert m["grad_norm"].dtype == jnp.bfloat16
    want = float(m["grad_norm"])

    init_fn, step_fn, place_batch = make_train_step(
        lambda p, b: lm_loss(p, b, tcfg), adamw(1e-3), device="cpu")
    placed = place_batch(batch)
    _, metrics = step_fn(init_fn(params_from_jax(weights, device="cpu")),
                         placed)
    got = metrics["grad_norm"]
    assert got.dtype == torch.float32
    # the port's own gradients, from a fresh copy of the same weights
    state = init_fn(params_from_jax(weights, device="cpu"))
    lm_loss(state.params, placed, tcfg).backward()
    grads = [p.grad for p in tree_leaves(state.params)]
    assert all(g is not None and g.dtype == torch.bfloat16 for g in grads)
    f32 = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]))
    np.testing.assert_allclose(got.item(), f32.item(), rtol=1e-6)
    np.testing.assert_allclose(got.item(), want, rtol=2e-2)


def test_unstack_layers_splits_every_layer_group():
    """Every top-level ``"layers"`` or ``"*_layers"`` group becomes a list
    of per-layer views of its stacked leaves; other leaves stay as they
    are, and an in-place update of a layer lands in the stacked leaf."""
    tree = {"embed": torch.zeros(4, 2),
            "layers": {"w": torch.zeros(3, 2, 2), "n": torch.zeros(3, 2)},
            "attn_layers": {"wo": torch.zeros(2, 5)},
            "lm_head": torch.zeros(2, 4)}
    out = unstack_layers(tree)
    assert out["embed"] is tree["embed"] and out["lm_head"] is tree["lm_head"]
    assert [tuple(lp["w"].shape) for lp in out["layers"]] == [(2, 2)] * 3
    assert [tuple(lp["wo"].shape) for lp in out["attn_layers"]] == [(5,)] * 2
    out["attn_layers"][1]["wo"].add_(1.0)
    assert float(tree["attn_layers"]["wo"][1].sum()) == 5.0
    assert float(tree["attn_layers"]["wo"][0].sum()) == 0.0
