"""The ranks of the port's multi-device tests: a group of spawned
processes joined over gloo through a ``FileStore``, each running the same
case on its own rank (one process a device, as on GPUs), and the parent's
handle on them. This module imports neither JAX nor ``ray_tpu``, so a
rank starts with PyTorch and the port only; the parent computes the
reference and compares.

Cases take and return numpy (bf16 comes back as float32) and run with
``device="cpu"``.
"""

import datetime
import multiprocessing
import os
import queue
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

INIT_TIMEOUT_S = 60


# --- the parent's side --------------------------------------------------

class RankGroup:
    """``world`` spawned ranks that stay up across cases. ``run`` sends a
    case to every rank and returns their results in rank order; a case
    that fails or outlasts its timeout on any rank kills the group (the
    next ``run`` starts a fresh one) and raises."""

    def __init__(self, world, store_dir):
        self.world = world
        self.store_dir = str(store_dir)
        self.procs = []
        self._n = 0

    def _start(self):
        ctx = multiprocessing.get_context("spawn")
        self._n += 1
        path = os.path.join(self.store_dir, f"store{self._n}")
        self.inboxes = [ctx.Queue() for _ in range(self.world)]
        self.outbox = ctx.Queue()
        self.procs = [ctx.Process(target=serve, daemon=True, args=(
            r, self.world, path, self.inboxes[r], self.outbox))
            for r in range(self.world)]
        for p in self.procs:
            p.start()
        self._collect("ready", INIT_TIMEOUT_S + 60)

    def _collect(self, what, timeout):
        out = [None] * self.world
        deadline = time.monotonic() + timeout
        for _ in range(self.world):
            try:
                rank, ok, value = self.outbox.get(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                self.close()
                raise AssertionError(f"{what}: a rank did not answer "
                                     f"within {timeout} s") from None
            if not ok:
                self.close()
                raise AssertionError(f"{what} failed on rank {rank}:\n"
                                     f"{value}")
            out[rank] = value
        return out

    def run(self, case, timeout=150, **kwargs):
        if not self.procs or not all(p.is_alive() for p in self.procs):
            self.close()
            self._start()
        for inbox in self.inboxes:
            inbox.put((case, kwargs))
        return self._collect(case, timeout)

    def close(self):
        for inbox in getattr(self, "inboxes", []):
            try:
                inbox.put(None)
            except Exception:
                pass
        for p in self.procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)
        self.procs = []


def run_once(world, store_dir, target, timeout=120, **kwargs):
    """``target(rank, world, **kwargs)`` in ``world`` fresh spawned
    processes that make no group themselves; their results in rank
    order. Kills them past ``timeout``."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_once, daemon=True,
                         args=(target, r, world, kwargs, out))
             for r in range(world)]
    for p in procs:
        p.start()
    res = [None] * world
    try:
        for _ in range(world):
            rank, ok, value = out.get(timeout=timeout)
            if not ok:
                raise AssertionError(f"rank {rank} failed:\n{value}")
            res[rank] = value
    finally:
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
    return res


def _once(target, rank, world, kwargs, out):
    torch.set_num_threads(1)
    try:
        out.put((rank, True, target(rank, world, **kwargs)))
    except Exception:
        out.put((rank, False, traceback.format_exc()))


def placements_of_spec(spec, active):
    """A PartitionSpec's parts as the reprs of DTensor placements over the
    mesh dims ``active`` (a dim over a tuple of axes is Shard on each)."""
    out = ["Replicate()"] * len(active)
    for dim, part in enumerate(spec):
        if part is None:
            continue
        for a in (part,) if isinstance(part, str) else part:
            out[active.index(a)] = f"Shard(dim={dim})"
    return tuple(out)


# --- a rank's side --------------------------------------------------------

def serve(rank, world, store_path, inbox, outbox):
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
        outbox.put((rank, True, None))
    except Exception:
        outbox.put((rank, False, traceback.format_exc()))
        return
    while True:
        msg = inbox.get()
        if msg is None:
            break
        case, kwargs = msg
        try:
            outbox.put((rank, True, CASES[case](**kwargs)))
        except Exception:
            outbox.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


def _np(t):
    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_np(v) for v in t)
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.full_tensor()
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return t


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(a, dtype=np.float32)
                         if np.asarray(a).dtype.kind == "f"
                         else np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _mesh(spec, devices=None):
    from ray_tpu_torch.parallel import MeshSpec, build_mesh

    return build_mesh(MeshSpec(**spec), devices, device="cpu")


def _member(mesh):
    return mesh.get_coordinate() is not None


# --- cases: meshes and shardings ----------------------------------------

def mesh_info(spec, devices=None):
    from ray_tpu_torch.parallel import slice_topology
    from ray_tpu_torch.parallel.mesh import axis_sizes

    mesh = _mesh(spec, devices)
    return {"names": tuple(mesh.mesh_dim_names),
            "sizes": axis_sizes(mesh), "ranks": mesh.mesh.tolist(),
            "topology": slice_topology(devices, device="cpu")}


def placements(layouts, axes_trees):
    """For each layout and each named tree of logical axes: every leaf's
    spec (``_spec_for`` on the mesh) and placements, by leaf path."""
    from ray_tpu_torch.parallel import logical_sharding
    from ray_tpu_torch.parallel.sharding import DEFAULT_RULES, _spec_for

    out = {}
    for spec in layouts:
        mesh = _mesh(spec)
        for name, tree in axes_trees.items():
            for path, axes in _leaves(tree):
                key = (tuple(sorted(spec.items())), name, path)
                out[key] = (_spec_for(axes, DEFAULT_RULES, mesh),
                            tuple(repr(p) for p in
                                  logical_sharding(mesh, axes)))
    return out


def _leaves(tree, path=()):
    if tree is None or isinstance(tree, tuple):
        return [(path, tree or ())]
    return [leaf for k in sorted(tree) for leaf in _leaves(tree[k],
                                                           path + (k,))]


def local_block(spec, x, logical_axes):
    """The block of the global ``x`` this rank holds when placed by
    ``logical_axes`` (the DTensor's local tensor)."""
    from torch.distributed.tensor import distribute_tensor

    from ray_tpu_torch.parallel import logical_sharding
    from ray_tpu_torch.parallel.mesh import active_mesh

    mesh = _mesh(spec)
    d = distribute_tensor(_t(x), active_mesh(mesh),
                          logical_sharding(mesh, logical_axes))
    return d.to_local().numpy()


# --- cases: collectives ---------------------------------------------------

# op name -> (fn of the local block, out spec), for ``every_collective``
def _ops(axis):
    from ray_tpu_torch.parallel import (allgather, allreduce, alltoall,
                                        broadcast, recv, reducescatter, send)

    spec = (axis,)
    return {
        "allreduce_sum": (lambda s: allreduce(s, axis, "sum"), spec),
        "allreduce_mean": (lambda s: allreduce(s, axis, "mean"), spec),
        "allreduce_max": (lambda s: allreduce(s, axis, "max"), spec),
        "allreduce_min": (lambda s: allreduce(s, axis, "min"), spec),
        "allreduce_prod": (lambda s: allreduce(s, axis, "prod"), spec),
        "allgather": (lambda s: allgather(s, axis), spec),
        "allgather_untiled_1": (
            lambda s: allgather(s, axis, concat_axis=1, tiled=False), spec),
        "reducescatter_sum_1": (
            lambda s: reducescatter(s, axis, scatter_axis=1), spec),
        "reducescatter_mean_1": (
            lambda s: reducescatter(s, axis, scatter_axis=1, op="mean"),
            spec),
        "broadcast_3": (lambda s: broadcast(s, axis, root=3), spec),
        "alltoall_1_0": (
            lambda s: alltoall(s, axis, split_axis=1, concat_axis=0), spec),
        "send_1": (lambda s: send(s, axis, shift=1), spec),
        "recv_2": (lambda s: recv(s, axis, shift=2), spec),
    }


LINEAR_OPS = ("allreduce_sum", "allreduce_mean", "allgather",
              "allgather_untiled_1", "reducescatter_sum_1",
              "reducescatter_mean_1", "broadcast_3", "alltoall_1_0",
              "send_1", "recv_2")


def every_collective(mesh_spec, axis, x, cot, dtype):
    """Every symbolic op over ``axis`` on the global ``x`` (its leading
    dim split over ``axis``) through shard_map; for the linear ones in
    f32 also the gradient of sum(out * cot[op]) with respect to x."""
    from ray_tpu_torch.parallel.collectives import shard_map

    mesh = _mesh(mesh_spec)
    dt = getattr(torch, dtype)
    out, grads = {}, {}
    for name, (fn, spec) in _ops(axis).items():
        xt = _t(x, dt)
        grad = dtype == "float32" and name in LINEAR_OPS
        if grad:
            xt.requires_grad_()
        y = shard_map(fn, mesh, (axis,), spec)(xt)
        out[name] = _np(y)
        if grad:
            (y * _t(cot[name])).sum().backward()
            grads[name] = _np(xt.grad)
    return {"out": out, "grad": grads}


def shard_map_pair(x):
    """test_parallel.py's shard_map: allreduce over tp and allgather
    over dp on MeshSpec(dp=4, tp=2)."""
    from ray_tpu_torch.parallel import allgather, allreduce
    from ray_tpu_torch.parallel.collectives import shard_map

    mesh = _mesh({"dp": 4, "tp": 2})
    a, g = shard_map(lambda s: (allreduce(s, "tp"), allgather(s, "dp")),
                     mesh, (("dp", "tp"),), [(("dp", "tp"),), ()])(_t(x))
    return _np(a), _np(g)


def pgroup_ops(x, dtype="float32"):
    """The eager group over dp=8: rank r passes row r of ``x``."""
    from ray_tpu_torch.parallel import pgroup

    mesh = _mesh({"dp": 8})
    g = pgroup(mesh, "dp")
    r = dist.get_rank()
    mine = _t(x[r:r + 1], getattr(torch, dtype))
    out = {f"allreduce_{op}": _np(g.allreduce(mine, op=op))
           for op in ("sum", "mean", "max", "min", "prod")}
    out["allgather"] = _np(g.allgather(mine))
    out["broadcast_3"] = _np(g.broadcast(mine, root=3))
    out["shift_1"] = _np(g.shift(mine, shift=1))
    g.barrier()
    out["size"], out["rank"] = g.size, g.rank
    return out


def pgroup_reducescatter(x, op="sum"):
    """The eager reduce-scatter over dp=4 on ranks 0-3: rank r passes its
    (4 * chunk) rows ``x[r]``."""
    from ray_tpu_torch.parallel import pgroup

    mesh = _mesh({"dp": 4}, devices=range(4))
    if not _member(mesh):
        return None
    return _np(pgroup(mesh, "dp").reducescatter(
        _t(x[dist.get_rank()]), op=op))


def reducescatter_and_alltoall(ones, grid):
    """test_parallel.py's reduce-scatter of a replicated (8, 8) and
    all-to-all of row-sharded ``grid`` (out sharded by column)."""
    from ray_tpu_torch.parallel import alltoall, reducescatter
    from ray_tpu_torch.parallel.collectives import shard_map

    mesh = _mesh({"dp": 8})
    rs = shard_map(lambda s: reducescatter(s, "dp", scatter_axis=0), mesh,
                   (), ("dp",))(_t(ones))
    a2a = shard_map(lambda s: alltoall(s, "dp", split_axis=1,
                                       concat_axis=0),
                    mesh, ("dp",), (None, "dp"))(_t(grid))
    return _np(rs), _np(a2a)


class StoreHooks:
    """Stall-sentinel hooks over the group's own store, for the test: an
    arrival is a key, the wait polls for every rank's key of the step."""

    def __init__(self, store, poll_s=0.05):
        self.store, self.poll_s = store, poll_s

    def note_arrival(self, group, step, rank, size, op, t, deadline_s):
        self.store.set(f"{group}/{step}/{rank}", op)
        return {"ok": True}

    def await_peers(self, group, step, timeout_s, size):
        deadline = time.monotonic() + timeout_s
        while True:
            here = [r for r in range(size)
                    if self.store.check([f"{group}/{step}/{r}"])]
            if len(here) == size or time.monotonic() >= deadline:
                return {"complete": len(here) == size, "arrived": len(here),
                        "missing": [r for r in range(size)
                                    if r not in here]}
            time.sleep(self.poll_s)


def barrier_timeouts(timeout_s):
    """On dp=2 over ranks 0 and 1, rank 1 never reaches either barrier
    of rank 0: a named group with store hooks (the error names rank 1),
    then an unnamed one (the local sync's deadline; rank 1 meets that
    sync late so that no collective is left pending)."""
    from ray_tpu_torch.exceptions import CollectiveTimeoutError
    from ray_tpu_torch.parallel import barrier, pgroup

    mesh = _mesh({"dp": 2}, devices=range(2))
    rank = dist.get_rank()
    store = dist.distributed_c10d._get_default_store()
    out = {}
    if rank == 0:
        for mode in ("hooks", "local"):
            kw = ({"group_name": "g", "hooks": StoreHooks(store)}
                  if mode == "hooks" else {})
            t0 = time.monotonic()
            try:
                barrier(mesh, "dp", timeout_s, **kw)
                out[mode] = "no error"
            except CollectiveTimeoutError as e:
                out[mode] = {"seconds": time.monotonic() - t0,
                             "missing": e.missing_ranks, "op": e.op,
                             "message": str(e)}
        store.set("rank0_done", "1")
    elif rank == 1:
        store.wait(["rank0_done"])
        pgroup(mesh, "dp")._device_sync(torch.device("cpu"))
    return out


def two_level(x):
    from ray_tpu_torch.parallel import (build_multislice_mesh,
                                        two_level_pmean, two_level_psum)
    from ray_tpu_torch.parallel.collectives import shard_map

    mesh = build_multislice_mesh({"dp": 4}, n_slices=2, device="cpu")
    spec = (("dcn", "dp"),)
    return (_np(shard_map(lambda a: two_level_psum(a, "dp"), mesh, spec,
                          spec)(_t(x))),
            _np(shard_map(lambda a: two_level_pmean(a, "dp"), mesh, spec,
                          spec)(_t(x))))


def multislice_mesh():
    from ray_tpu_torch.parallel import (build_multislice_mesh,
                                        group_devices_by_slice)

    mesh = build_multislice_mesh({"dp": 2, "tp": 2}, n_slices=2,
                                 device="cpu")
    return {"names": tuple(mesh.mesh_dim_names),
            "shape": tuple(mesh.mesh.shape), "ranks": mesh.mesh.tolist(),
            "groups": group_devices_by_slice()}


# --- cases: ring attention, the pipeline ----------------------------------

def ring(q, k, v, causal, sp, grad):
    """ring_attention over sp ranks (the first ``sp``) through shard_map
    on (B, S, H, D) sequence-split inputs; with ``grad``, the gradients
    of sum(out ** 2)."""
    from ray_tpu_torch.ops import ring_attention
    from ray_tpu_torch.parallel.collectives import shard_map

    mesh = _mesh({"sp": sp}, devices=range(sp))
    if not _member(mesh):
        return None
    ts = [_t(a).requires_grad_(grad) for a in (q, k, v)]
    spec = (None, "sp")
    out = shard_map(lambda a, b, c: ring_attention(a, b, c, axis="sp",
                                                   causal=causal),
                    mesh, spec, spec)(*ts)
    if not grad:
        return _np(out)
    (out ** 2).sum().backward()
    return _np(out), [_np(t.grad) for t in ts]


def _tanh_stage(stage_params, x):
    for i in range(stage_params["w"].shape[0]):
        x = torch.tanh(x @ stage_params["w"][i] + stage_params["b"][i])
    return x


def pipeline(mesh_kind, params, x, stages, microbatches, grad):
    """pipeline_apply of the tanh stack over ``stages`` stages; with
    ``grad``, the gradients of sum(out ** 2) with respect to the stacked
    params."""
    from ray_tpu_torch.parallel import (build_multislice_mesh,
                                        pipeline_apply, split_stages)

    if mesh_kind == "slices":
        mesh = build_multislice_mesh({"dp": 4}, n_slices=2,
                                     dcn_axis_name="pp", device="cpu")
    else:
        mesh = _mesh({"pp": stages, "dp": 8 // stages})
    p = {k: _t(v).requires_grad_(grad) for k, v in params.items()}
    got = pipeline_apply(mesh, _tanh_stage, split_stages(p, stages), _t(x),
                         microbatches=microbatches)
    if not grad:
        return _np(got)
    (got ** 2).sum().backward()
    return _np(got), {k: _np(t.grad) for k, t in p.items()}


def pipeline_llama(params, tokens):
    """Llama tiny's layer stack pipelined over pp=2, dp=4; embedding and
    head outside, as in test_moe_pipeline.py."""
    from ray_tpu_torch.models import LLAMA_CONFIGS, params_from_jax
    from ray_tpu_torch.models.llama import _layer
    from ray_tpu_torch.ops import rms_norm, rope_frequencies
    from ray_tpu_torch.ops.quant import logits_matmul
    from ray_tpu_torch.parallel import pipeline_apply, split_stages

    cfg = LLAMA_CONFIGS["tiny"]
    p = params_from_jax(params, device="cpu")
    tok = _t(tokens).long()
    cos, sin = rope_frequencies(cfg.head_dim, tok.shape[1], cfg.rope_theta)

    def stage_fn(stage_params, x):
        for i in range(next(iter(stage_params.values())).shape[0]):
            x, _ = _layer(x, {k: v[i] for k, v in stage_params.items()},
                          cfg, cos, sin)
        return x

    mesh = _mesh({"pp": 2, "dp": 4})
    piped = pipeline_apply(mesh, stage_fn, split_stages(p["layers"], 2),
                           p["embed"][tok], microbatches=4)
    x = rms_norm(piped, p["final_norm"], cfg.norm_eps)
    return _np(logits_matmul(x, p["lm_head"]))


# --- cases: the model and the trainer -------------------------------------

def _cfg(name, n_experts=0):
    import dataclasses

    from ray_tpu_torch.models import LLAMA_CONFIGS

    cfg = LLAMA_CONFIGS[name]
    return (dataclasses.replace(cfg, n_experts=n_experts, top_k=2)
            if n_experts else cfg)


def llama_forward(params, tokens, spec):
    """Llama tiny's logits under ``spec``, params placed by
    param_logical_axes."""
    from ray_tpu_torch.models import (forward, param_logical_axes,
                                      params_from_jax)
    from ray_tpu_torch.parallel.sharding import distribute_pytree

    cfg = _cfg("tiny")
    mesh = _mesh(spec)
    p = distribute_pytree(params_from_jax(params, device="cpu"),
                          param_logical_axes(cfg), mesh)
    return _np(forward(p, _t(tokens), cfg, mesh=mesh))


def train_steps(params, batches, spec, n_experts=0, multislice=None):
    """make_train_step(mesh=...) on Llama tiny (MoE with ``n_experts``),
    adamw(1e-3), one step a batch: the metrics, the params after (as the
    stacked tree), and the params' and moments' placements. With
    ``multislice`` ({"axes": ..., "n_slices": ...}) the mesh is
    build_multislice_mesh's and the rules MULTISLICE_RULES."""
    from ray_tpu_torch._private.tree import tree_leaves, tree_map
    from ray_tpu_torch.models import (lm_loss, param_logical_axes,
                                      params_from_jax, params_to_numpy)
    from ray_tpu_torch.parallel import (MULTISLICE_RULES, DEFAULT_RULES,
                                        build_multislice_mesh)
    from ray_tpu_torch.train import adamw, make_train_step

    cfg = _cfg("tiny", n_experts)
    if multislice:
        mesh = build_multislice_mesh(multislice["axes"],
                                     n_slices=multislice["n_slices"],
                                     device="cpu")
        rules = MULTISLICE_RULES
    else:
        mesh, rules = _mesh(spec), DEFAULT_RULES
    init_fn, step_fn, place = make_train_step(
        lambda p, b: lm_loss(p, b, cfg, mesh=mesh, rules=rules),
        adamw(1e-3), device="cpu", mesh=mesh,
        param_axes=param_logical_axes(cfg), rules=rules)
    state = init_fn(params_from_jax(params, device="cpu"))
    placed = {"params": [str(tuple(p.placements))
                         for p in tree_leaves(state.params)],
              "mu": [str(tuple(m.placements))
                     for m in tree_leaves(state.opt_state.mu)],
              "nu": [str(tuple(m.placements))
                     for m in tree_leaves(state.opt_state.nu)]}
    metrics = []
    for b in batches:
        state, m = step_fn(state, place(b))
        metrics.append({k: float(v) for k, v in m.items()})
    full = params_to_numpy(tree_map(lambda t: t.full_tensor(), state.params))
    return {"metrics": metrics, "params": full, "placements": placed,
            "w_gate": str(tuple(state.params["layers"][0]["w_gate"]
                                .placements))}


def moe_ep(x, rw, wg, wu, wd):
    """moe_mlp on MeshSpec(ep=4, dp=2): expert weights placed over ep,
    tokens over batch, ``csl`` the constraint."""
    import functools

    from torch.distributed.tensor import distribute_tensor

    from ray_tpu_torch.ops.moe import moe_mlp
    from ray_tpu_torch.parallel import with_sharding_constraint_logical
    from ray_tpu_torch.parallel.mesh import active_mesh
    from ray_tpu_torch.parallel.sharding import placements_for

    mesh = _mesh({"ep": 4, "dp": 2})

    def put(a, axes):
        t = _t(a)
        return distribute_tensor(t, active_mesh(mesh),
                                 placements_for(t.shape, axes, mesh))

    csl = functools.partial(with_sharding_constraint_logical, mesh=mesh)
    out, aux = moe_mlp(
        put(x, ("batch", "seq", "embed")), put(rw, ("embed", "expert")),
        put(wg, ("expert", "embed", "mlp")), put(wu, ("expert", "embed", "mlp")),
        put(wd, ("expert", "mlp", "embed")), top_k=2, capacity_factor=8.0,
        csl=csl)
    return _np(out), _np(aux), str(tuple(put(wg, ("expert", "embed", "mlp"))
                                         .placements))


CASES = {f.__name__: f for f in (
    mesh_info, placements, local_block, every_collective, shard_map_pair,
    pgroup_ops, pgroup_reducescatter, reducescatter_and_alltoall,
    barrier_timeouts, two_level, multislice_mesh, ring, pipeline,
    pipeline_llama, llama_forward, train_steps, moe_ep)}


def world_one(rank, world):
    """build_mesh in a process without a group: a two-device spec raises,
    a one-device spec makes a world-1 group."""
    from ray_tpu_torch.parallel import MeshSpec, allgather, allreduce, build_mesh
    from ray_tpu_torch.parallel.collectives import rank_region
    from ray_tpu_torch.parallel.mesh import axis_sizes

    out = {}
    try:
        build_mesh(MeshSpec(dp=2), device="cpu")
    except RuntimeError as e:
        out["error"] = str(e)
    mesh = build_mesh(MeshSpec(), device="cpu")
    out["initialized"] = dist.is_initialized()
    out["world"] = dist.get_world_size()
    out["sizes"] = axis_sizes(mesh)
    with rank_region(mesh):
        x = torch.tensor([1.0, 2.0])
        out["sum"] = allreduce(x, "dp").tolist()
        out["gather"] = allgather(x, ("dp", "tp")).tolist()
    dist.destroy_process_group()
    return out


# --- the worker group's bring-up ------------------------------------------

def bringup(rank, world, address):
    """init_torch_distributed from a context of ``address``, ``world`` and
    ``rank``: whether it made a group, a sum over it, and that a second
    call keeps the group."""
    import types

    from ray_tpu_torch.train import init_torch_distributed

    ctx = types.SimpleNamespace(coordinator_address=address,
                                world_size=world, rank=rank)
    made = init_torch_distributed(ctx, device="cpu", timeout_s=60)
    out = {"made": made, "initialized": dist.is_initialized()}
    if dist.is_initialized():
        t = torch.tensor([float(rank + 1)])
        dist.all_reduce(t)
        out["sum"] = float(t)
        out["world"] = dist.get_world_size()
        out["again"] = init_torch_distributed(ctx, device="cpu")
        dist.destroy_process_group()
    return out


def bringup_bad(rank, world):
    """A rendezvous address no init method takes: the error is raised."""
    return bringup(0, 2, "bogus://nowhere")


# --- on the card: a world-1 NCCL group ----------------------------------

def card_collectives(rank, world):
    """Every symbolic and eager op over ``build_mesh(MeshSpec())`` on the
    card (a world-1 NCCL group the mesh makes), f32 and bf16: whether each
    equals its world-1 value bit for bit."""
    import ray_tpu_torch.parallel as par
    from ray_tpu_torch.parallel.collectives import rank_region

    mesh = par.build_mesh(par.MeshSpec())
    g = torch.Generator("cuda").manual_seed(0)
    group = par.pgroup(mesh, "dp")
    equal = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((4, 64), generator=g, device="cuda").to(dtype)
        calls = {f"allreduce_{op}": lambda op=op: par.allreduce(x, "dp", op)
                 for op in ("sum", "mean", "max", "min", "prod")}
        calls.update({
            "allreduce_tuple": lambda: par.allreduce(x, ("dp", "tp")),
            "allgather": lambda: par.allgather(x, "dp"),
            "reducescatter": lambda: par.reducescatter(x, "tp"),
            "broadcast": lambda: par.broadcast(x, "dp"),
            "alltoall": lambda: par.alltoall(x, "sp", split_axis=1,
                                             concat_axis=0),
            "send": lambda: par.send(x, "pp"),
            "recv": lambda: par.recv(x, "pp", shift=3)})
        with rank_region(mesh):
            for name, call in calls.items():
                equal[f"{name}_{dtype}"] = bool(torch.equal(call(), x))
        for name, call in (("pgroup_allreduce", group.allreduce),
                           ("pgroup_allgather", group.allgather),
                           ("pgroup_reducescatter", group.reducescatter),
                           ("pgroup_broadcast", group.broadcast),
                           ("pgroup_shift", group.shift)):
            equal[f"{name}_{dtype}"] = bool(torch.equal(call(x), x))
    group.barrier(timeout_s=30)
    out = {"backend": dist.get_backend(), "world": dist.get_world_size(),
           "equal": equal}
    dist.destroy_process_group()
    return out


def card_mesh_train(rank, world):
    """A 2-layer f32 model (remat "full") trained 2 steps on the card
    with and without ``mesh=build_mesh(MeshSpec())`` from the same
    weights: the metrics and the params after, as numpy."""
    from ray_tpu_torch._private.tree import tree_map
    from ray_tpu_torch.models import params_to_numpy
    from ray_tpu_torch.models.llama import (LlamaConfig, init_params,
                                            lm_loss, param_logical_axes)
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    from ray_tpu_torch.train import adamw, make_train_step

    cfg = LlamaConfig(vocab=256, dim=128, n_layers=2, n_heads=4,
                      n_kv_heads=2, mlp_dim=256, max_seq=128,
                      dtype=torch.float32, remat=True)
    params = init_params(cfg, seed=1, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 64),
                           generator=torch.Generator().manual_seed(3))
    mesh = build_mesh(MeshSpec())
    out = {}
    for kind in ("plain", "mesh"):
        kw = ({} if kind == "plain" else
              {"mesh": mesh, "param_axes": param_logical_axes(cfg)})
        loss = ((lambda p, b: lm_loss(p, b, cfg)) if kind == "plain" else
                (lambda p, b: lm_loss(p, b, cfg, mesh=mesh)))
        init_fn, step_fn, place = make_train_step(loss, adamw(1e-3),
                                                  device="cuda", **kw)
        state = init_fn(tree_map(lambda t: t.clone(), params))
        metrics = []
        for _ in range(2):
            state, m = step_fn(state, place({"tokens": tokens}))
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        full = tree_map(lambda t: t.full_tensor() if hasattr(
            t, "full_tensor") else t, state.params)
        out[kind] = {"metrics": metrics, "params": params_to_numpy(full)}
    dist.destroy_process_group()
    return out
