"""The port's multi-device plane (``ray_tpu_torch/parallel``, ring
attention) against ``ray_tpu.parallel`` on the CPU.

``ray_tpu`` runs in this process on its 8 virtual CPU devices
(``cpu_mesh8``); the port runs the same cases as 8 spawned ranks over
gloo (``torch_parallel_peer``), one group for the module, on the same
numpy inputs. Tolerances are the reference tests' own: 1e-5 for values
and 1e-4 for gradients in f32, exact for moves of data; bf16 within one
bf16 rounding (2e-2 relative); ``allreduce(op="prod")`` is
``ReduceOp.PRODUCT`` in the port and exp(sum(log)) in the reference, so
the two agree to f32 rounding (1e-5 relative) and the port equals the
product up to the order of its f32 multiplications (1e-6 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import ray_tpu.parallel as jpar
from ray_tpu.exceptions import CollectiveTimeoutError as JTimeout
from ray_tpu.models import LLAMA_CONFIGS as J_CONFIGS
from ray_tpu.models import param_logical_axes as j_axes
from ray_tpu.ops import ring_attention as j_ring
from ray_tpu.ops.attention import naive_attention as j_naive
from ray_tpu.util.jax_compat import shard_map as j_shard_map

import ray_tpu_torch.parallel as tpar
import torch_parallel_peer as peer
from ray_tpu_torch.exceptions import CollectiveTimeoutError
from ray_tpu_torch.models import param_logical_axes

# six xdist workers share the machine's cores
torch.set_num_threads(2)

F32 = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    group = peer.RankGroup(8, tmp_path_factory.mktemp("ranks"))
    yield group
    group.close()


def _rng(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _jmesh(spec, devices):
    return jpar.build_mesh(jpar.MeshSpec(**spec), devices)


# --- meshes and shardings -------------------------------------------------

def test_mesh_spec_factor_matches_the_reference():
    for n, kw in ((8, {"tp": 2}), (8, {"tp": 2, "fsdp": 2}),
                  (8, {"dp": 2}), (8, {"pp": 2, "sp": 2}), (4, {}),
                  (16, {"ep": 4, "dp": 2})):
        got = tpar.MeshSpec.for_devices(n, **kw)
        want = jpar.MeshSpec.for_devices(n, **kw)
        assert got.axis_sizes == want.axis_sizes and got.size == want.size
    for n, kw in ((8, {"tp": 3}), (8, {"dp": 3}), (8, {"fsdp": 3}),
                  (8, {"dp": 2, "fsdp": 2})):
        with pytest.raises(ValueError) as e_got:
            tpar.MeshSpec.for_devices(n, **kw)
        with pytest.raises(ValueError) as e_want:
            jpar.MeshSpec.for_devices(n, **kw)
        assert str(e_got.value) == str(e_want.value)
    assert tpar.mesh.AXIS_ORDER == jpar.mesh.AXIS_ORDER


def test_build_mesh_and_topology(ranks, cpu_mesh8):
    spec = {"dp": 2, "fsdp": 2, "tp": 2}
    want = _jmesh(spec, cpu_mesh8)
    for info in ranks.run("mesh_info", spec=spec):
        assert info["names"] == tuple(want.axis_names)
        assert info["sizes"] == dict(want.shape)
        assert np.array_equal(np.array(info["ranks"]),
                              np.vectorize(lambda d: d.id)(want.devices))
        topo = info["topology"]
        assert topo == {"n_devices": 8, "n_slices": 1, "n_hosts": 1,
                        "platform": "cpu", "ici_bbox": None}
    assert jpar.slice_topology(cpu_mesh8)["n_devices"] == 8


def test_one_process_needs_no_rendezvous(tmp_path):
    """In a process with no group, a multi-device spec raises naming
    init_process_group, and a one-device spec makes a world-1 group
    itself, over which the collectives run."""
    got = peer.run_once(1, tmp_path, peer.world_one)[0]
    assert "init_process_group" in got["error"]
    assert got["initialized"] and got["world"] == 1
    assert got["sizes"] == dict.fromkeys(tpar.mesh.AXIS_ORDER, 1)
    assert got["sum"] == [1.0, 2.0] and got["gather"] == [1.0, 2.0]


LAYOUTS = ({"dp": 8}, {"fsdp": 4, "tp": 2}, {"dp": 2, "fsdp": 2, "tp": 2},
           {"sp": 4, "tp": 2}, {"ep": 4, "dp": 2})


def test_logical_sharding_matches_partition_specs(ranks, cpu_mesh8):
    """Every leaf of param_logical_axes(tiny), dense and MoE, and the
    activation axes under each layout: the port's spec is the reference's
    PartitionSpec, and its placements shard exactly those dims."""
    import dataclasses

    trees = {
        "dense": param_logical_axes(J_CONFIGS["tiny"]),
        "moe": param_logical_axes(dataclasses.replace(
            J_CONFIGS["tiny"], n_experts=4)),
        "acts": {"x": ("batch", "seq", "embed"), "e": ("embed", "mlp"),
                 "logits": ("batch", "seq", "vocab"),
                 "tokens": ("batch", "seq"), "table": ("vocab", None)},
    }
    got = ranks.run("placements", layouts=LAYOUTS, axes_trees=trees)[0]
    assert len(got) == len(LAYOUTS) * sum(
        len(peer._leaves(t)) for t in trees.values())
    for (spec_items, name, path), (spec, placed) in got.items():
        spec_kw = dict(spec_items)
        mesh = _jmesh(spec_kw, cpu_mesh8)
        axes = trees[name]
        for k in path:
            axes = axes[k]
        want = jpar.logical_sharding(mesh, axes).spec
        assert spec == tuple(want), (spec_kw, name, path)
        active = [a for a in jpar.mesh.AXIS_ORDER if spec_kw.get(a, 1) > 1]
        assert placed == peer.placements_of_spec(want, active), (spec_kw, path)
    # the reference test's own cases
    assert got[(tuple(sorted(LAYOUTS[2].items())), "acts", ("x",))][0] == \
        (("dp", "fsdp"),)
    assert got[(tuple(sorted(LAYOUTS[2].items())), "acts", ("e",))][0] == \
        ("fsdp", "tp")
    assert got[(tuple(sorted(LAYOUTS[0].items())), "acts", ("e",))][0] == ()


def test_tuple_axes_shard_in_jaxs_order(ranks, cpu_mesh8):
    """batch over ("dp", "fsdp"), dp outermost, and the embed table under
    fsdp (embed and vocab both want a mesh axis): each rank's DTensor
    block is the block JAX puts on the device of the same index."""
    x = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    for spec, axes in (({"dp": 2, "fsdp": 2, "tp": 2}, ("batch", None)),
                       ({"fsdp": 4, "tp": 2}, ("vocab", "embed")),
                       ({"dp": 2, "fsdp": 4}, ("batch", "embed"))):
        blocks = ranks.run("local_block", spec=spec, x=x, logical_axes=axes)
        sharding = jpar.logical_sharding(_jmesh(spec, cpu_mesh8), axes)
        for dev, idx in sharding.devices_indices_map(x.shape).items():
            np.testing.assert_array_equal(blocks[dev.id], x[idx],
                                          err_msg=f"{spec} {axes}")


# --- collectives ------------------------------------------------------------

def _jax_ops(axis):
    return {
        "allreduce_sum": lambda s: jpar.allreduce(s, axis, "sum"),
        "allreduce_mean": lambda s: jpar.allreduce(s, axis, "mean"),
        "allreduce_max": lambda s: jpar.allreduce(s, axis, "max"),
        "allreduce_min": lambda s: jpar.allreduce(s, axis, "min"),
        "allreduce_prod": lambda s: jpar.allreduce(s, axis, "prod"),
        "allgather": lambda s: jpar.allgather(s, axis),
        "allgather_untiled_1": lambda s: jpar.allgather(
            s, axis, concat_axis=1, tiled=False),
        "reducescatter_sum_1": lambda s: jpar.reducescatter(
            s, axis, scatter_axis=1),
        "reducescatter_mean_1": lambda s: jpar.reducescatter(
            s, axis, scatter_axis=1, op="mean"),
        "broadcast_3": lambda s: jpar.broadcast(s, axis, root=3),
        "alltoall_1_0": lambda s: jpar.alltoall(s, axis, split_axis=1,
                                                concat_axis=0),
        "send_1": lambda s: jpar.send(s, axis, shift=1),
        "recv_2": lambda s: jpar.recv(s, axis, shift=2),
    }


def _check_every_collective(ranks, cpu_mesh8, mesh_spec, axis, dtype):
    x = _rng(0, (8, 16), 0.5) + 1.5 * np.sign(_rng(9, (8, 16)))
    x[2, 3] = 0.0       # a zero for the product
    mesh = _jmesh(mesh_spec, cpu_mesh8)
    spec = P(axis)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want, cots = {}, {}
    for i, (name, fn) in enumerate(_jax_ops(axis).items()):
        sm = j_shard_map(fn, mesh=mesh, in_specs=spec, out_specs=spec,
                         check_vma=False)
        want[name] = np.asarray(jax.jit(sm)(jnp.asarray(x, jdt)),
                                np.float32)
        cots[name] = _rng(100 + i, want[name].shape)
    got = ranks.run("every_collective", mesh_spec=mesh_spec, axis=axis, x=x,
                    cot=cots, dtype=dtype)
    for r in got:
        assert r["out"].keys() == want.keys()
        for name, w in want.items():
            tol = F32 if dtype == "float32" else BF16
            np.testing.assert_allclose(r["out"][name], w, err_msg=name, **tol)
    out = got[0]["out"]
    # prod: the port's is exact (the reference's exp(sum(log)) is not)
    xr = x.astype(np.float32) if dtype == "float32" else np.asarray(
        jnp.asarray(x, jnp.bfloat16), np.float32)
    exact = np.broadcast_to(np.prod(xr, axis=0), x.shape)
    if dtype == "float32":
        # exact up to the order of the f32 multiplications
        np.testing.assert_allclose(out["allreduce_prod"], exact, rtol=1e-6)
        assert (out["allreduce_prod"][:, 3] == 0).all()
    for name in ("allgather", "allgather_untiled_1", "alltoall_1_0",
                 "send_1", "recv_2", "broadcast_3", "allreduce_max",
                 "allreduce_min"):
        np.testing.assert_array_equal(out[name], want[name], err_msg=name)
    if dtype != "float32":
        return
    for name in peer.LINEAR_OPS:
        sm = j_shard_map(_jax_ops(axis)[name], mesh=mesh, in_specs=spec,
                         out_specs=spec, check_vma=False)
        g = jax.grad(lambda a: jnp.sum(sm(a) * cots[name]))(jnp.asarray(x))
        for r in got:
            np.testing.assert_allclose(r["grad"][name], np.asarray(g),
                                       err_msg=name, **GRAD)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_collective_matches_shard_map(ranks, cpu_mesh8, dtype):
    """Each symbolic op over dp=8 (values, and gradients in f32) equals
    the reference's inside shard_map."""
    _check_every_collective(ranks, cpu_mesh8, {"dp": 8}, "dp", dtype)


def test_every_collective_over_a_tuple_of_axes(ranks, cpu_mesh8):
    """The same over ("dp", "tp") of MeshSpec(dp=4, tp=2): the group of
    the flattened sub-mesh, ranked as JAX ranks the tuple."""
    _check_every_collective(ranks, cpu_mesh8, {"dp": 4, "tp": 2},
                            ("dp", "tp"), "float32")


def test_collectives_in_shard_map(ranks, cpu_mesh8):
    mesh = _jmesh({"dp": 4, "tp": 2}, cpu_mesh8)
    x = np.arange(8.0, dtype=np.float32).reshape(8, 1)
    want_a, want_g = jax.jit(j_shard_map(
        lambda s: (jpar.allreduce(s, "tp"), jpar.allgather(s, "dp")),
        mesh=mesh, in_specs=P(("dp", "tp")),
        out_specs=(P(("dp", "tp")), P((), None)), check_vma=False))(x)
    got = ranks.run("shard_map_pair", x=x)
    for r, (a, g) in enumerate(got):
        np.testing.assert_array_equal(a, np.asarray(want_a))
        np.testing.assert_allclose(a[:4, 0], [1, 1, 5, 5])
        # g is declared replicated over tp but is not: each rank keeps its
        # own, and JAX returns device 0's, which tp index 0 holds
        if r % 2 == 0:
            np.testing.assert_array_equal(g, np.asarray(want_g))


def test_collectives_outside_a_region_raise():
    with pytest.raises(RuntimeError, match="per-rank region"):
        tpar.allreduce(torch.ones(2), "dp")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pgroup_eager(ranks, cpu_mesh8, dtype):
    """Rank r passes row r of the reference's rank-leading array and gets
    row r of its result (allgather: the whole gathered array)."""
    mesh = _jmesh({"dp": 8}, cpu_mesh8)
    g = jpar.pgroup(mesh, "dp")
    x = np.arange(1.0, 9.0, dtype=np.float32)
    x[5] = -x[5]
    jx = jnp.asarray(x, jnp.float32 if dtype == "float32" else jnp.bfloat16)
    want = {f"allreduce_{op}": g.allreduce(jx, op=op)
            for op in ("sum", "mean", "max", "min", "prod")}
    want["allgather"] = g.allgather(jx)
    want["broadcast_3"] = g.broadcast(jx, root=3)
    want["shift_1"] = g.shift(jx, shift=1)
    g.barrier()
    want = {k: np.asarray(v, np.float32) for k, v in want.items()}
    tol = F32 if dtype == "float32" else BF16
    for r, got in enumerate(ranks.run("pgroup_ops", x=x, dtype=dtype)):
        assert got["size"] == 8 and got["rank"] == r
        for name, w in want.items():
            row = w if name == "allgather" else w[r:r + 1]
            np.testing.assert_allclose(got[name], row, err_msg=name, **tol)
    np.testing.assert_allclose(want["allreduce_sum"], [24.0] * 8, **tol)
    np.testing.assert_allclose(want["broadcast_3"], [4.0] * 8)


@pytest.mark.parametrize("op", ["sum", "mean"])
def test_pgroup_reducescatter_per_rank(ranks, cpu_mesh8, op):
    """4 ranks each contribute (4, 1); rank i keeps the sum (mean) of
    every rank's i-th chunk: 6 (1.5) in the reference's test."""
    mesh = _jmesh({"dp": 4}, cpu_mesh8[:4])
    x = np.broadcast_to(np.arange(4.0, dtype=np.float32)[:, None],
                        (4, 4)).reshape(16, 1) + _rng(3, (16, 1))
    want = np.asarray(jpar.pgroup(mesh, "dp").reducescatter(
        jnp.asarray(x), op=op))
    got = ranks.run("pgroup_reducescatter", x=x.reshape(4, 4, 1), op=op)
    for r in range(4):
        np.testing.assert_allclose(got[r], want[r:r + 1], **F32)
    assert all(g is None for g in got[4:])


def test_reducescatter_and_alltoall(ranks, cpu_mesh8):
    mesh = _jmesh({"dp": 8}, cpu_mesh8)
    ones = np.ones((8, 8), np.float32)
    grid = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    want_rs = jax.jit(j_shard_map(
        lambda s: jpar.reducescatter(s, "dp", scatter_axis=0), mesh=mesh,
        in_specs=P(), out_specs=P("dp"), check_vma=False))(ones)
    for rs, a2a in ranks.run("reducescatter_and_alltoall", ones=ones,
                             grid=grid):
        np.testing.assert_array_equal(rs, np.asarray(want_rs))
        np.testing.assert_array_equal(rs, np.full((8, 8), 8.0))
        np.testing.assert_array_equal(a2a, grid)


def test_barrier_whose_peer_never_arrives_raises(ranks):
    """Rank 1 never reaches rank 0's barriers: with store-backed hooks the
    error names rank 1; without, the local sync's deadline fires. Both
    within the timeout's second."""
    timeout_s = 1.0
    got = ranks.run("barrier_timeouts", timeout_s=timeout_s)[0]
    hooks, local = got["hooks"], got["local"]
    assert hooks["missing"] == [1] and hooks["op"] == "barrier"
    assert "missing ranks: [1]" in hooks["message"]
    assert local["missing"] == [] and local["op"] == "barrier"
    for r in (hooks, local):
        assert timeout_s <= r["seconds"] < timeout_s + 1.0


def test_collective_timeout_error_matches_the_reference():
    args = ("allreduce_sum", [1, 3], 2.5)
    kw = {"detail": "group g step 4: 2/4 ranks arrived"}
    got, want = CollectiveTimeoutError(*args, **kw), JTimeout(*args, **kw)
    assert str(got) == str(want)
    assert (got.op, got.missing_ranks, got.timeout_s) == \
        (want.op, want.missing_ranks, want.timeout_s)
    assert isinstance(got, TimeoutError)


def test_the_parallel_package_exports_the_references_names():
    assert tpar.__all__ == jpar.__all__
    for name in tpar.__all__:
        assert hasattr(tpar, name), name
    assert tpar.DEFAULT_RULES == jpar.DEFAULT_RULES
    assert tpar.MULTISLICE_RULES == jpar.MULTISLICE_RULES
    assert tpar.multislice_rules() == jpar.multislice_rules()
    assert tpar.DCN_AXIS == jpar.DCN_AXIS


# --- multislice (test_multislice.py) -------------------------------------------

def test_build_multislice_mesh_shape(ranks, cpu_mesh8):
    want = jpar.build_multislice_mesh({"dp": 2, "tp": 2}, n_slices=2,
                                      devices=cpu_mesh8)
    got = ranks.run("multislice_mesh")[0]
    assert got["names"] == tuple(want.axis_names) == ("dcn", "dp", "tp")
    assert got["shape"] == want.devices.shape == (2, 2, 2)
    ranks_ = np.array(got["ranks"])
    assert np.array_equal(ranks_, np.vectorize(lambda d: d.id)(
        want.devices))
    assert ranks_[0].max() < ranks_[1].min()


def test_group_devices_by_slice_collapses(ranks, cpu_mesh8):
    got = ranks.run("multislice_mesh")[0]["groups"]
    assert got == [list(range(8))]
    assert [[d.id for d in g] for g in
            jpar.group_devices_by_slice(cpu_mesh8)] == got


def test_two_level_psum_equals_flat(ranks, cpu_mesh8):
    mesh = jpar.build_multislice_mesh({"dp": 4}, n_slices=2,
                                      devices=cpu_mesh8)
    x = _rng(4, (8, 16))
    spec = P(("dcn", "dp"))
    want = [np.asarray(jax.jit(j_shard_map(
        lambda a, f=f: f(a, intra_axis="dp"), mesh=mesh, in_specs=spec,
        out_specs=spec, check_vma=False))(x))
        for f in (jpar.two_level_psum, jpar.two_level_pmean)]
    for psum, pmean in ranks.run("two_level", x=x):
        np.testing.assert_allclose(psum, want[0], rtol=1e-5)
        np.testing.assert_allclose(pmean, want[1], rtol=1e-5)
        np.testing.assert_allclose(psum, np.broadcast_to(x.sum(0), x.shape),
                                   rtol=1e-5)


def _tanh_params(L, D, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), L)
    return {"w": np.stack([np.asarray(jax.random.normal(k, (D, D)))
                           * D ** -0.5 for k in keys]).astype(np.float32),
            "b": np.zeros((L, D), np.float32)}


def _j_tanh_stage(sp, x):
    def body(c, lp):
        return jnp.tanh(c @ lp["w"] + lp["b"]), None
    return jax.lax.scan(body, x, sp)[0]


def test_slice_per_stage_pipeline(ranks, cpu_mesh8):
    pp_mesh = jpar.build_multislice_mesh({"dp": 4}, n_slices=2,
                                         devices=cpu_mesh8,
                                         dcn_axis_name="pp")
    params = _tanh_params(4, 16, 5)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(6), (8, 16)))
    want = jpar.pipeline_apply(pp_mesh, _j_tanh_stage,
                               jpar.split_stages(params, 2), x,
                               microbatches=4)
    for got in ranks.run("pipeline", mesh_kind="slices", params=params, x=x,
                         stages=2, microbatches=4, grad=False):
        np.testing.assert_allclose(got, np.asarray(want), **F32)


def test_multislice_train_step_matches_single_mesh(ranks):
    """2 slices of {dp: 2, tp: 2} under MULTISLICE_RULES against dp=8,
    and both against the reference's multislice step (rtol 1e-5)."""
    import optax

    from ray_tpu.models import init_params as j_init
    from ray_tpu.models import lm_loss as j_loss
    from ray_tpu.train import make_train_step as j_step

    cfg = J_CONFIGS["tiny"]
    params = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), cfg))
    tokens = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (8, 32), 0, cfg.vocab, jnp.int32))
    ms = ranks.run("train_steps", params=params, batches=[{"tokens": tokens}],
                   spec=None, multislice={"axes": {"dp": 2, "fsdp": 1,
                                                   "tp": 2},
                                          "n_slices": 2})
    flat = ranks.run("train_steps", params=params,
                     batches=[{"tokens": tokens}], spec={"dp": 8})
    mesh = jpar.build_multislice_mesh({"dp": 2, "fsdp": 1, "tp": 2},
                                      n_slices=2,
                                      devices=jax.devices("cpu")[:8])
    rules = jpar.multislice_rules()
    init_fn, step_fn, place = j_step(
        lambda p, b: j_loss(p, b, cfg, mesh=mesh, rules=rules),
        optax.adamw(1e-3), mesh, j_axes(cfg), rules=rules)
    _, m = step_fn(init_fn(jax.tree.map(jnp.asarray, params)),
                   place({"tokens": jnp.asarray(tokens)}))
    for a, b in zip(ms, flat):
        np.testing.assert_allclose(a["metrics"][0]["loss"],
                                   b["metrics"][0]["loss"], rtol=1e-5)
        np.testing.assert_allclose(a["metrics"][0]["loss"], float(m["loss"]),
                                   rtol=1e-5)


# --- ring attention (test_ops.py) ------------------------------------------------

def _qkv(seed, b, sq, skv, hq, hkv, d=32):
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    return tuple(np.asarray(jax.random.normal(k, s), np.float32)
                 for k, s in zip(ks, ((b, sq, hq, d), (b, skv, hkv, d),
                                      (b, skv, hkv, d))))


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_full(ranks, cpu_mesh8, causal):
    mesh = _jmesh({"sp": 8}, cpu_mesh8)
    q, k, v = _qkv(5, b=1, sq=64, skv=64, hq=4, hkv=2)
    want = jax.jit(j_shard_map(
        lambda a, b, c: j_ring(a, b, c, axis="sp", causal=causal),
        mesh=mesh, in_specs=(P(None, "sp"),) * 3, out_specs=P(None, "sp"),
        check_vma=False))(q, k, v)
    full = j_naive(q, k, v, causal=causal)
    for got in ranks.run("ring", q=q, k=k, v=v, causal=causal, sp=8,
                         grad=False):
        np.testing.assert_allclose(got, np.asarray(want), **F32)
        np.testing.assert_allclose(got, np.asarray(full), **F32)


def test_ring_attention_differentiable(ranks, cpu_mesh8):
    mesh = _jmesh({"sp": 4}, cpu_mesh8[:4])
    q, k, v = _qkv(6, b=1, sq=32, skv=32, hq=2, hkv=2)

    def loss(q, k, v):
        out = j_shard_map(
            lambda a, b, c: j_ring(a, b, c, axis="sp"), mesh=mesh,
            in_specs=(P(None, "sp"),) * 3, out_specs=P(None, "sp"),
            check_vma=False)(q, k, v)
        return (out ** 2).sum()

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    got = ranks.run("ring", q=q, k=k, v=v, causal=True, sp=4, grad=True)
    for r in range(4):
        _, grads = got[r]
        for g, w in zip(grads, want):
            np.testing.assert_allclose(g, np.asarray(w), **GRAD)
    assert all(g is None for g in got[4:])
