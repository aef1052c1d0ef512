"""The port's sharded train step inside a ``ray_tpu.train`` gang.

``ray_tpu.train.Trainer`` runs two workers (``ScalingConfig(
num_workers=2)``) on the CPU; ``WorkerGroup`` hands every rank the
gang's ``coordinator_address``. Each ``train_fn`` joins through the
port's ``init_torch_distributed(get_context(), device="cpu")`` (gloo),
then trains Llama ``tiny`` (f32) with ``make_train_step(mesh=
build_mesh(MeshSpec(dp=2)))``: caller-side wiring only, nothing of
``ray_tpu`` or of the port changes for it. The losses are held, at the
single-device trainer's 1e-5, against the port's single-process step and
``ray_tpu``'s sharded step under the same layout on two of
``cpu_mesh8``'s devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu
import ray_tpu.parallel as jpar
from ray_tpu.models import LLAMA_CONFIGS as J_CONFIGS
from ray_tpu.models import init_params as j_init
from ray_tpu.models import lm_loss as j_loss
from ray_tpu.models import param_logical_axes as j_axes
from ray_tpu.train import RunConfig, ScalingConfig, Trainer
from ray_tpu.train import make_train_step as j_make_train_step

# six xdist workers share the machine's cores
torch.set_num_threads(2)

J_TINY = J_CONFIGS["tiny"]
F32 = dict(rtol=1e-5, atol=1e-5)


def _batches():
    """tests/test_torch_train.py's batches at B=4, the second masked."""
    out = []
    for i in range(2):
        rng = np.random.default_rng(36 + i)
        b = {"tokens": rng.integers(0, J_TINY.vocab, (4, 24)).astype(
            np.int32)}
        if i == 1:
            mask = np.ones((4, 24), np.int32)
            mask[0, 14:] = 0
            b["mask"] = mask
        out.append(b)
    return out


def _port_single_step(params, batches):
    from ray_tpu_torch.models import (LLAMA_CONFIGS, lm_loss,
                                      params_from_jax)
    from ray_tpu_torch.train import adamw, make_train_step

    cfg = LLAMA_CONFIGS["tiny"]
    init_fn, step_fn, place = make_train_step(
        lambda p, b: lm_loss(p, b, cfg), adamw(1e-3), device="cpu")
    state = init_fn(params_from_jax(params, device="cpu"))
    out = []
    for b in batches:
        state, m = step_fn(state, place(b))
        out.append((m["loss"].item(), m["grad_norm"].item()))
    return out


def _ray_tpu_sharded_step(params, batches, devices):
    mesh = jpar.build_mesh(jpar.MeshSpec(dp=2), devices[:2])
    init_fn, step_fn, place = j_make_train_step(
        lambda p, b: j_loss(p, b, J_TINY, mesh=mesh), optax.adamw(1e-3),
        mesh, j_axes(J_TINY))
    state = init_fn(jax.tree.map(jnp.asarray, params))
    out = []
    for b in batches:
        state, m = step_fn(state, place({k: jnp.asarray(v)
                                         for k, v in b.items()}))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


@pytest.fixture
def gang_cluster(monkeypatch):
    # the workers import torch: keep them to 2 threads each
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    ray_tpu.init(num_cpus=4)
    yield
    ray_tpu.shutdown()


def test_port_sharded_step_in_a_ray_tpu_train_gang(gang_cluster, cpu_mesh8,
                                                   tmp_path):
    def gang_train_fn(config):
        """A gang worker (defined here, so that cloudpickle carries it
        to the workers by value): join the port's group from the train
        context, a second join keeps it (a gang restart on a reused
        process), then the port's sharded step on dp=2; rank 0 reports
        every rank's losses."""
        import torch
        import torch.distributed as dist

        import ray_tpu.train as train
        from ray_tpu_torch.models import (LLAMA_CONFIGS, lm_loss,
                                          param_logical_axes,
                                          params_from_jax)
        from ray_tpu_torch.parallel import MeshSpec, build_mesh
        from ray_tpu_torch.train import (adamw, init_torch_distributed,
                                         make_train_step)

        torch.set_num_threads(2)
        ctx = train.get_context()
        made = init_torch_distributed(ctx, device="cpu", timeout_s=120)
        again = init_torch_distributed(ctx, device="cpu")
        cfg = LLAMA_CONFIGS["tiny"]
        mesh = build_mesh(MeshSpec(dp=2), device="cpu")
        init_fn, step_fn, place = make_train_step(
            lambda p, b: lm_loss(p, b, cfg, mesh=mesh), adamw(1e-3),
            device="cpu", mesh=mesh, param_axes=param_logical_axes(cfg))
        state = init_fn(params_from_jax(config["params"], device="cpu"))
        metrics = []
        for b in config["batches"]:
            state, m = step_fn(state, place(b))
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, {
            "rank": ctx.rank, "metrics": metrics, "made": made,
            "again": again, "world": dist.get_world_size(),
            "coordinator": ctx.coordinator_address})
        dist.destroy_process_group()
        train.report({"ranks": every})

    params = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), J_TINY))
    batches = _batches()
    result = Trainer(
        gang_train_fn,
        train_loop_config={"params": params, "batches": batches},
        scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="port_gang", storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None, result.error
    ranks = result.metrics["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        # the group came from the gang's coordinator; a second join kept it
        assert r["made"] is True and r["again"] is False
        assert r["world"] == 2 and r["coordinator"]
    single = _port_single_step(params, batches)
    reference = _ray_tpu_sharded_step(params, batches, cpu_mesh8)
    for r in ranks:
        np.testing.assert_allclose(r["metrics"], single, **F32)
        np.testing.assert_allclose(r["metrics"], reference, **F32)
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
