"""The port's model and trainer on a mesh against ``ray_tpu``'s on the
CPU: Llama's sharded forward under the reference's four layouts, the
sharded train step, expert-parallel MoE, the pipeline, the logical-axes
trees, and the training gang's process-group bring-up.

``ray_tpu`` runs in this process on its 8 virtual CPU devices
(``cpu_mesh8``); the port as 8 spawned ranks over gloo
(``torch_parallel_peer``), one group for the module, with the
reference's weights carried over as numpy (``models/convert.py``).
Tolerances are the reference tests' own: 2e-4 for the sharded Llama
forward and the pipelined Llama stage, 1e-4 for MoE and the pipeline's
gradients, 1e-5 for the pipeline's forward and the trainer (the single
device trainer's parity tolerance, ``tests/test_torch_train.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu.parallel as jpar
from ray_tpu.models import LLAMA_CONFIGS as J_CONFIGS
from ray_tpu.models import forward as j_forward
from ray_tpu.models import init_params as j_init
from ray_tpu.models import lm_loss as j_loss
from ray_tpu.models import param_logical_axes as j_axes
from ray_tpu.ops.moe import moe_mlp as j_moe
from ray_tpu.ops.moe import moe_mlp_oracle as j_oracle
from ray_tpu.parallel.sharding import with_sharding_constraint_logical
from ray_tpu.train import make_train_step as j_make_train_step

import torch_parallel_peer as peer

# six xdist workers share the machine's cores
torch.set_num_threads(2)

J_TINY = J_CONFIGS["tiny"]
F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    group = peer.RankGroup(8, tmp_path_factory.mktemp("ranks"))
    yield group
    group.close()


@pytest.fixture(scope="module")
def tiny_params():
    return jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), J_TINY))


def _jmesh(spec, devices):
    return jpar.build_mesh(jpar.MeshSpec(**spec), devices)


# --- the sharded forward (test_llama.py) ---------------------------------------

@pytest.mark.parametrize("spec", [{"dp": 8}, {"fsdp": 4, "tp": 2},
                                  {"dp": 2, "fsdp": 2, "tp": 2},
                                  {"sp": 4, "tp": 2}],
                         ids=["dp8", "fsdp4_tp2", "dp2_fsdp2_tp2", "sp4_tp2"])
def test_sharded_forward_layout(ranks, cpu_mesh8, tiny_params, spec):
    """The port's logits under the layout (sp through ring attention)
    against the reference's under the same layout and unsharded."""
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (2, 32), 0,
                                           J_TINY.vocab))
    params = jax.tree.map(jnp.asarray, tiny_params)
    ref = j_forward(params, tokens, J_TINY)
    mesh = _jmesh(spec, cpu_mesh8)
    placed = jax.device_put(params, jpar.shard_pytree(
        params, j_axes(J_TINY), mesh))
    want = jax.jit(lambda p, t: j_forward(p, t, J_TINY, mesh=mesh))(
        placed, tokens)
    np.testing.assert_allclose(np.asarray(want), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)
    for got in ranks.run("llama_forward", params=tiny_params, tokens=tokens,
                         spec=spec):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4,
                                   atol=2e-4, err_msg=str(spec))


# --- the logical-axes trees -------------------------------------------------

def test_param_axes_trees_equal_the_references():
    from ray_tpu.models import clip as jclip
    from ray_tpu.models import mamba as jmamba
    from ray_tpu.models import vision as jvision

    from ray_tpu_torch.models import (CLIP_CONFIGS, MAMBA_CONFIGS,
                                      RESNET_CONFIGS, clip_param_axes,
                                      init_resnet, mamba_param_axes,
                                      param_logical_axes, resnet_param_axes)
    from ray_tpu_torch.models.llama import LLAMA_CONFIGS

    for name in ("tiny", "8b"):
        for experts in (0, 4):
            cfg = dataclasses.replace(LLAMA_CONFIGS[name], n_experts=experts)
            jcfg = dataclasses.replace(J_CONFIGS[name], n_experts=experts)
            assert param_logical_axes(cfg) == j_axes(jcfg)
    for name in ("130m", "jamba_tiny", "jamba_350m"):
        assert mamba_param_axes(MAMBA_CONFIGS[name]) == \
            jmamba.mamba_param_axes(jmamba.MAMBA_CONFIGS[name])
    for name in ("tiny", "vit_b16"):
        assert clip_param_axes(CLIP_CONFIGS[name]) == \
            jclip.clip_param_axes(jclip.CLIP_CONFIGS[name])
    cfg = RESNET_CONFIGS["tiny"]
    jparams = jvision.init_resnet(jax.random.PRNGKey(0),
                                  jvision.RESNET_CONFIGS["tiny"])
    want = jvision.resnet_param_axes(jparams)
    got = resnet_param_axes(init_resnet(cfg, seed=0, device="cpu"))
    assert jax.tree.leaves(got, is_leaf=lambda x: x == ()) == \
        jax.tree.leaves(want, is_leaf=lambda x: x == ())
    assert jax.tree.structure(got, is_leaf=lambda x: x == ()) == \
        jax.tree.structure(want, is_leaf=lambda x: x == ())


def test_mamba_accepts_mesh_and_rules():
    from ray_tpu_torch.models import (MAMBA_CONFIGS, init_mamba,
                                      mamba_forward, mamba_lm_loss)
    from ray_tpu_torch.parallel import DEFAULT_RULES

    cfg = MAMBA_CONFIGS["jamba_tiny"]
    params = init_mamba(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        a = mamba_forward(params, tokens, cfg)
        b = mamba_forward(params, tokens, cfg, mesh=object(),
                          rules=DEFAULT_RULES)
        la = mamba_lm_loss(params, {"tokens": tokens}, cfg)
        lb = mamba_lm_loss(params, {"tokens": tokens}, cfg, mesh=object(),
                           rules=DEFAULT_RULES)
    assert torch.equal(a, b) and torch.equal(la, lb)


# --- the trainer (test_train_step.py) ----------------------------------------------

def _batch(i):
    """tests/test_torch_train.py's batches at B=4 (the reference places
    a batch only where dp * fsdp divides it), the second masked."""
    rng = np.random.default_rng(36 + i)
    batch = {"tokens": rng.integers(0, J_TINY.vocab, (4, 24)).astype(
        np.int32)}
    if i == 1:
        mask = np.ones((4, 24), np.int32)
        mask[0, 14:] = 0
        batch["mask"] = mask
    return batch


def _j_train(params, cfg, spec, batches, devices):
    mesh = _jmesh(spec, devices)
    init_fn, step_fn, place = j_make_train_step(
        lambda p, b: j_loss(p, b, cfg, mesh=mesh), optax.adamw(1e-3), mesh,
        j_axes(cfg))
    state = init_fn(jax.tree.map(jnp.asarray, params))
    metrics = []
    for b in batches:
        state, m = step_fn(state, place({k: jnp.asarray(v)
                                         for k, v in b.items()}))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def test_opt_state_mirrors_param_sharding(ranks, cpu_mesh8, tiny_params):
    """fsdp=4, tp=2: each Adam moment has its param's placements, which
    are the reference's param shardings; the step count is a host int."""
    spec = {"fsdp": 4, "tp": 2}
    got = ranks.run("train_steps", params=tiny_params, batches=[],
                    spec=spec)
    state, _ = _j_train(tiny_params, J_TINY, spec, [], cpu_mesh8)
    active = ["fsdp", "tp"]
    want = []
    for leaf_name, p in sorted(state.params.items()):
        if leaf_name == "layers":
            # the trainer's tree: one leaf per layer and name, each with
            # its stacked leaf's spec less the layers dim
            for li in range(J_TINY.n_layers):
                for k in sorted(p):
                    spec_ = tuple(p[k].sharding.spec)[1:]
                    want.append(peer.placements_of_spec(spec_, active))
        else:
            want.append(peer.placements_of_spec(tuple(p.sharding.spec), active))
    for r in got:
        placed = r["placements"]
        assert placed["mu"] == placed["params"] == placed["nu"]
        assert [_canon(s) for s in placed["params"]] == want
    mu = state.opt_state[0].mu
    assert jax.tree.map(lambda m: m.sharding, mu) == \
        jax.tree.map(lambda p: p.sharding, state.params)


def _canon(s):
    """'(Shard(dim=0), Replicate())' -> ('Shard(dim=0)', 'Replicate()')."""
    parts, depth, cur = [], 0, ""
    for ch in s.strip()[1:-1]:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append(cur.strip())
            cur = ""
        else:
            cur += ch
    if cur.strip():
        parts.append(cur.strip())
    return tuple(parts)


def test_train_step_matches_the_references_sharded_step(ranks, cpu_mesh8,
                                                        tiny_params):
    """dp=2, fsdp=2, tp=2: the losses, grad norms and params after 2 steps
    equal the reference's sharded step."""
    spec = {"dp": 2, "fsdp": 2, "tp": 2}
    batches = [_batch(0), _batch(1)]
    state, want = _j_train(tiny_params, J_TINY, spec, batches, cpu_mesh8)
    want_params = jax.tree.map(np.asarray, state.params)
    for r in ranks.run("train_steps", params=tiny_params, batches=batches,
                       spec=spec):
        for g, w in zip(r["metrics"], want):
            np.testing.assert_allclose(g["loss"], w["loss"], **F32)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], **F32)
            assert g["step"] == w["step"]
        jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, **F32),
                     r["params"], want_params)


# --- MoE (test_moe_pipeline.py) ------------------------------------------------------

def _moe_weights(key, D=8, M=16, E=4):
    ks = jax.random.split(key, 5)
    return tuple(np.asarray(a, np.float32) for a in (
        jax.random.normal(ks[0], (2, 16, D), jnp.float32),
        jax.random.normal(ks[1], (D, E)) * 0.1,
        jax.random.normal(ks[2], (E, D, M)) * 0.2,
        jax.random.normal(ks[3], (E, D, M)) * 0.2,
        jax.random.normal(ks[4], (E, M, D)) * 0.2))


def test_moe_ep_sharded_matches_unsharded(ranks, cpu_mesh8):
    x, rw, wg, wu, wd = _moe_weights(jax.random.PRNGKey(2))
    ref = np.asarray(j_oracle(x, rw, wg, wu, wd, top_k=2))
    mesh = _jmesh({"ep": 4, "dp": 2}, cpu_mesh8)
    csl = lambda a, axes: with_sharding_constraint_logical(a, axes,
                                                            mesh=mesh)
    with mesh:
        want, want_aux = jax.jit(lambda *a: j_moe(
            *a, top_k=2, capacity_factor=8.0, csl=csl))(x, rw, wg, wu, wd)
    for out, aux, placed in ranks.run("moe_ep", x=x, rw=rw, wg=wg, wu=wu,
                                      wd=wd):
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(out, np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(aux, float(want_aux), rtol=1e-5)
        # experts over ep (the active mesh's dims: dp, ep)
        assert _canon(placed) == ("Replicate()", "Shard(dim=0)")


def test_moe_llama_trains_on_ep_mesh(ranks, cpu_mesh8):
    """ep=4, dp=2, 5 steps on one batch: expert weights over ep, the loss
    falls, and each step's loss equals the reference's sharded step's."""
    cfg = dataclasses.replace(J_TINY, n_experts=4, top_k=2)
    params = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), cfg))
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 32),
                                           0, cfg.vocab, jnp.int32))
    batches = [{"tokens": tokens}] * 5
    spec = {"ep": 4, "dp": 2}
    state, want = _j_train(params, cfg, spec, batches, cpu_mesh8)
    assert "ep" in str(state.params["layers"]["w_gate"].sharding.spec)
    for r in ranks.run("train_steps", params=params, batches=batches,
                       spec=spec, n_experts=4):
        assert _canon(r["w_gate"]) == ("Replicate()", "Shard(dim=0)")
        losses = [m["loss"] for m in r["metrics"]]
        assert losses[-1] < losses[0]
        np.testing.assert_allclose(losses, [m["loss"] for m in want],
                                   rtol=1e-4)


# --- the pipeline (test_moe_pipeline.py) ------------------------------------------------

def _toy_stack(L=8, D=16):
    keys = jax.random.split(jax.random.PRNGKey(7), L)
    return {"w": np.stack([np.asarray(jax.random.normal(k, (D, D)))
                           * D ** -0.5 for k in keys]).astype(np.float32),
            "b": np.zeros((L, D), np.float32)}


def _j_stage(stage_params, x):
    def body(c, lp):
        return jnp.tanh(c @ lp["w"] + lp["b"]), None
    return jax.lax.scan(body, x, stage_params)[0]


def _j_serial(params, x):
    for i in range(params["w"].shape[0]):
        x = jnp.tanh(x @ params["w"][i] + params["b"][i])
    return x


def test_pipeline_forward_matches_serial(ranks):
    params = _toy_stack()
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(9), (16, 16)))
    want = np.asarray(_j_serial(params, x))
    for got in ranks.run("pipeline", mesh_kind="pp", params=params, x=x,
                         stages=4, microbatches=8, grad=False):
        np.testing.assert_allclose(got, want, **F32)


def test_pipeline_backward_matches_serial(ranks, cpu_mesh8):
    """Every rank's gradient of the stacked params (its stage's, summed
    over the ranks) equals the serial stack's and the reference
    pipeline's."""
    params = _toy_stack()
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(9), (16, 16)))
    mesh = _jmesh({"pp": 4, "dp": 2}, cpu_mesh8)
    gp = jax.grad(lambda s: jnp.sum(jpar.pipeline_apply(
        mesh, _j_stage, s, x, microbatches=8) ** 2))(
        jpar.split_stages(params, 4))
    gs = jax.grad(lambda p: jnp.sum(_j_serial(p, x) ** 2))(params)
    for out, grads in ranks.run("pipeline", mesh_kind="pp", params=params,
                                x=x, stages=4, microbatches=8, grad=True):
        for k in ("w", "b"):
            np.testing.assert_allclose(grads[k], np.asarray(gs[k]),
                                       rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(
                grads[k], np.asarray(gp[k]).reshape(grads[k].shape),
                rtol=1e-4, atol=1e-4)


def test_pipeline_llama_stage(ranks, tiny_params):
    """Llama tiny's layers pipelined over pp=2, dp=4 equal the plain
    forward."""
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 32),
                                           0, J_TINY.vocab, jnp.int32))
    want = np.asarray(j_forward(jax.tree.map(jnp.asarray, tiny_params),
                                tokens, J_TINY))
    for got in ranks.run("pipeline_llama", params=tiny_params,
                         tokens=tokens):
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


# --- the worker group's bring-up -----------------------------------------------

def test_worker_group_bringup_world_one_does_nothing(monkeypatch):
    import types

    import torch.distributed as dist

    from ray_tpu_torch.train import init_torch_distributed

    for world, addr in ((1, "localhost:1"), (0, "localhost:1"), (2, "")):
        ctx = types.SimpleNamespace(coordinator_address=addr,
                                    world_size=world, rank=0)
        assert init_torch_distributed(ctx, device="cpu") is False
    assert not dist.is_initialized()
    # the card is the default, and without one it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_torch_distributed(types.SimpleNamespace(
            coordinator_address="", world_size=1, rank=0))


def test_worker_group_bringup_world_two(tmp_path):
    """Two processes join from a context's address; a second call keeps
    the group; a rendezvous error is raised."""
    addr = f"file://{tmp_path / 'rendezvous'}"
    got = peer.run_once(2, tmp_path, peer.bringup, address=addr)
    for r in got:
        assert r == {"made": True, "initialized": True, "sum": 3.0,
                     "world": 2, "again": False}
    with pytest.raises(AssertionError, match="ValueError|RuntimeError"):
        peer.run_once(1, tmp_path, peer.bringup_bad)
