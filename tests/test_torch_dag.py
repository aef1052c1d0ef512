"""ray_tpu_torch.dag's compiled DAG against ray_tpu.dag's, on one local
ray_tpu cluster (CPU).

Each DAG shape of ``tests/test_dag.py`` is built three times on the same
inputs: through ``ray_tpu``'s compiled DAG (its actors compute on numpy,
or jax on the device edge), through the port on the same ``ray_tpu``
actors (their loops placed by ``DagHooks`` filled with ``ray_tpu``'s own
functions, which live here and never in the port; the actors compute on
torch tensors), and through the port under ``LOCAL`` (plain objects in
this process, a loop a thread). Results are equal exactly, error texts
equal. The port compiles with ``device="cpu"``: a device edge of CPU
tensors then takes DeviceChannel's host lane, read from the actors'
counters. ``chip_smoke.py``'s two-stage Llama split runs on ``tiny``
(f32) under ``LOCAL``, as ``ray_tpu`` actors and as the dag phase's
spawned processes, against ``ray_tpu``'s ``forward`` at 1e-5.
"""

import os
import sys
import types
from pathlib import Path

import cloudpickle
import jax
import numpy as np
import pytest
import torch

import ray_tpu
from ray_tpu import dag as jdag
from ray_tpu.actor import ActorMethod
from ray_tpu.models import LLAMA_CONFIGS as J_CONFIGS
from ray_tpu.models import forward as j_forward
from ray_tpu.models import init_params as j_init

from ray_tpu_torch import dag as tdag
from ray_tpu_torch.dag import LOCAL, DagHooks, actor
from ray_tpu_torch.dag import compiled as tcompiled
from ray_tpu_torch.models import params_from_jax

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))   # before init: the workers take sys.path

import chip_smoke  # noqa: E402
from torch_dag_actors import Adder, Boom, JaxBoom, JaxWorker, TorchWorker  # noqa: E402

# six xdist workers share the machine's cores
torch.set_num_threads(2)

TIMEOUT = 60


@pytest.fixture(scope="module")
def cluster():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        ray_tpu.init(num_cpus=4)
        try:
            yield
        finally:
            ray_tpu.shutdown()


@pytest.fixture
def make(cluster):
    """``make(cls, *args)``: a ray_tpu actor, killed after the test (an
    actor left alive holds one of the cluster's 4 CPUs)."""
    made = []

    def _make(cls, *args):
        made.append(ray_tpu.remote(cls).remote(*args))
        return made[-1]

    yield _make
    for handle in made:
        ray_tpu.kill(handle)


# ray_tpu's functions as the port's hooks
RT_HOOKS = DagHooks(
    actor_key=lambda h: h.actor_id.hex(),
    run=lambda h, fn, *a: ActorMethod(h, "_rtpu_dyn_call").remote(
        cloudpickle.dumps(fn), *a),
    get=ray_tpu.get)


def _np(value):
    if isinstance(value, list):
        return [_np(v) for v in value]
    if isinstance(value, torch.Tensor):
        return value.numpy()
    return np.asarray(value)


# the three builds of a shape: the DAG module, how a node is bound on a
# handle, how a numpy feed value enters, and how the root is compiled
REF = types.SimpleNamespace(
    name="ray_tpu", dag=jdag, bind=lambda h: h, value=lambda v: v,
    compile=lambda root, **kw: root.experimental_compile(**kw))
PORT = types.SimpleNamespace(
    name="port", dag=tdag, bind=actor, value=torch.as_tensor,
    compile=lambda root, **kw: root.experimental_compile(
        hooks=RT_HOOKS, device="cpu", **kw))
PORT_LOCAL = types.SimpleNamespace(
    name="port_local", dag=tdag, bind=actor, value=torch.as_tensor,
    compile=lambda root, **kw: root.experimental_compile(
        hooks=LOCAL, device="cpu", **kw))


def _feed(ns, args=(), kwargs=None):
    return ([ns.value(a) for a in args],
            {k: ns.value(v) for k, v in (kwargs or {}).items()})


def _run(ns, handles, build, feeds, **compile_kw):
    """The DAG ``build(ns, binders, inp)`` over ``handles``, compiled by
    ``ns``, each feed executed and read in turn; the results as numpy,
    and the channels' file paths."""
    binders = [ns.bind(h) for h in handles]
    with ns.dag.InputNode() as inp:
        root = build(ns, binders, inp)
    compiled = ns.compile(root, **compile_kw)
    try:
        out = []
        for args, kwargs in feeds:
            a, k = _feed(ns, args, kwargs)
            out.append(_np(compiled.execute(*a, **k).get(timeout=TIMEOUT)))
        paths = [ch.path for ch in compiled._channels]
    finally:
        compiled.teardown()
    return out, paths


def _three(make, classes, build, feeds, **compile_kw):
    """The shape through ray_tpu's compiled DAG, the port on the same
    ray_tpu actors, and the port under LOCAL on plain objects; all three
    results must be equal. Returns them by build."""
    handles = [make(cls, *args) for cls, args in classes]
    local = [cls(*args) for cls, args in classes]
    results = {}
    for ns, hs in ((REF, handles), (PORT, handles), (PORT_LOCAL, local)):
        results[ns.name], _ = _run(ns, hs, build, feeds, **compile_kw)
    for name in ("port", "port_local"):
        np.testing.assert_equal(results[name], results["ray_tpu"])
    return results


def _vec(i, n=4):
    return np.full((n,), float(i), np.float32)


# --- the shapes of tests/test_dag.py ---------------------------------------

def test_chain_parity_and_reuse(make):
    res = _three(
        make, [(Adder, (1,)), (Adder, (10,))],
        lambda ns, b, inp: b[1].add.bind(b[0].add.bind(inp)),
        [((_vec(i),), None) for i in range(10)])
    assert [r[0] for r in res["port"]] == [i + 11 for i in range(10)]


def test_fan_out_multi_output(make):
    res = _three(
        make, [(Adder, (1,)), (Adder, (2,))],
        lambda ns, b, inp: ns.dag.MultiOutputNode(
            [b[0].add.bind(inp), b[1].add.bind(inp)]),
        [((_vec(i),), None) for i in range(5)])
    assert [[v[0] for v in r] for r in res["port"]] == \
        [[i + 1, i + 2] for i in range(5)]


def test_same_actor_locality(make):
    """Two chained methods on ONE actor: one input and one output
    channel, no channel between them, and the actor really ran both
    methods (2 calls an execution, each build's 2 executions on the same
    actor)."""
    handles = [make(Adder, 1)]
    local = [Adder(1)]
    build = lambda ns, b, inp: b[0].add.bind(b[0].add.bind(inp))
    feeds = [((_vec(0),), None), ((_vec(40),), None)]
    counts, n_channels = [], []
    for ns, hs in ((REF, handles), (PORT, handles), (PORT_LOCAL, local)):
        out, paths = _run(ns, hs, build, feeds)
        assert [o[0] for o in out] == [2.0, 42.0], ns.name
        n_channels.append(len(paths))
        counts.append(ray_tpu.get(handles[0].count.remote(), timeout=TIMEOUT))
    # after each teardown the actor serves normal calls again
    assert counts == [4, 8, 8] and local[0].calls == 4
    assert n_channels == [2, 2, 2]


def _pair_sum(ns, b, inp):
    pair = b[0].pair.bind(inp)            # {"a": x, "b": 10x}
    return b[1].add2.bind(pair["a"], pair["b"])


def test_attribute_node(make):
    res = _three(make, [(Adder, (1,)), (Adder, (0,))], _pair_sum,
                       [((_vec(3),), None)])
    assert res["port"][0][0] == 33


def test_nested_attribute_access(make):
    res = _three(
        make, [(Adder, (0,)), (Adder, (1,))],
        lambda ns, b, inp: b[1].add.bind(
            b[0].make.bind(inp)["outer"]["inner"]),
        [((_vec(5),), None)])
    assert res["port"][0][0] == 11


def test_multi_arg_input(make):
    res = _three(
        make, [(Adder, (0,))],
        lambda ns, b, inp: b[0].add2.bind(inp[0], inp[1]),
        [((_vec(4), _vec(5)), None)])
    assert res["port"][0][0] == 9


def test_mixed_args_kwargs_input(make):
    res = _three(
        make, [(Adder, (0,))],
        lambda ns, b, inp: b[0].add2.bind(inp[0], inp["y"]),
        [((_vec(4),), {"y": _vec(5)}), ((_vec(1),), {"y": _vec(2)})])
    assert [r[0] for r in res["port"]] == [9, 3]


def test_single_participant_allreduce(make):
    """The identity reduction; repeated executions must not deadlock."""
    res = _three(
        make, [(Adder, (5,))],
        lambda ns, b, inp: ns.dag.MultiOutputNode(
            ns.dag.collective.allreduce.bind([b[0].add.bind(inp)])),
        [((_vec(i),), None) for i in (1, 2, 3)])
    assert [[v[0] for v in r] for r in res["port"]] == [[6], [7], [8]]


def test_allreduce(make):
    """x+1, x+2, x+3 -> every participant sees 3x+6."""
    res = _three(
        make, [(Adder, (i,)) for i in (1, 2, 3)],
        lambda ns, b, inp: ns.dag.MultiOutputNode(
            ns.dag.collective.allreduce.bind([a.add.bind(inp) for a in b])),
        [((_vec(1),), None), ((_vec(10),), None)])
    assert [[v[0] for v in r] for r in res["port"]] == [[9] * 3, [36] * 3]


def _error_texts(make, classes, build, ref_classes=None):
    """Each build's first execution (1) and its second (3, which fails):
    the result, and the error's text. ``ref_classes``: ray_tpu's own
    actors, where its build needs others."""
    handles = [make(cls, *args) for cls, args in classes]
    ref_handles = ([make(cls, *args) for cls, args in ref_classes]
                   if ref_classes else handles)
    local = [cls(*args) for cls, args in classes]
    texts = {}
    for ns, hs in ((REF, ref_handles), (PORT, handles), (PORT_LOCAL, local)):
        binders = [ns.bind(h) for h in hs]
        with ns.dag.InputNode() as inp:
            root = build(binders, inp)
        compiled = ns.compile(root)
        first = _np(compiled.execute(ns.value(_vec(1))).get(timeout=TIMEOUT))
        with pytest.raises(RuntimeError, match="kaboom") as e:
            compiled.execute(ns.value(_vec(3))).get(timeout=TIMEOUT)
        texts[ns.name] = (first[0], str(e.value))
        compiled.teardown()
    return texts


def test_error_propagates(make):
    texts = _error_texts(make, [(Boom, ())],
                         lambda b, inp: b[0].go.bind(inp))
    assert texts["port"] == texts["port_local"] == texts["ray_tpu"] == (
        1.0, "compiled DAG task failed: ValueError('kaboom')")


def test_mid_chain_error_reaches_driver(make):
    texts = _error_texts(make, [(Boom, ()), (Adder, (1,))],
                         lambda b, inp: b[1].add.bind(b[0].go.bind(inp)))
    assert texts["port"] == texts["port_local"] == texts["ray_tpu"] == (
        2.0, "compiled DAG task failed: ValueError('kaboom')")


def _compile_error(ns, handle, build):
    binder = ns.bind(handle)
    with ns.dag.InputNode() as inp:
        root = build(binder, inp)
    with pytest.raises(ValueError) as e:
        ns.compile(root)
    return str(e.value)


def test_compile_requires_input_node(make):
    handle = make(Adder, 1)
    texts = {ns.name: _compile_error(ns, h, lambda b, inp: b.add.bind(5))
             for ns, h in ((REF, handle), (PORT, handle),
                           (PORT_LOCAL, Adder(1)))}
    assert texts["port"] == texts["port_local"] == texts["ray_tpu"]
    assert "InputNode" in texts["port"]


def test_driver_read_device_edge_is_rejected(make, monkeypatch):
    """DeviceChannel is 1:1: a device edge the driver reads raises the
    reference's ValueError, and the port's channel made before the raise
    (the input's) leaves no file."""
    made = []
    channel = tcompiled.Channel

    def recorded(*args, **kwargs):
        made.append(channel(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(tcompiled, "Channel", recorded)
    handle = make(Adder, 1)
    texts = {ns.name: _compile_error(
        ns, h, lambda b, inp: b.add.bind(inp).with_device_transport())
        for ns, h in ((REF, handle), (PORT, handle),
                      (PORT_LOCAL, Adder(1)))}
    assert texts["port"] == texts["port_local"] == texts["ray_tpu"]
    assert "device_transport" in texts["port"]
    assert len(made) == 2
    assert not any(os.path.exists(ch.path) for ch in made)


def test_max_inflight(make):
    """Two executions in flight are taken, a third raises the reference's
    error, and the pending two still arrive in order."""
    handles = [make(Adder, 1), make(Adder, 10)]
    local = [Adder(1), Adder(10)]
    texts, results = {}, {}
    for ns, hs in ((REF, handles), (PORT, handles), (PORT_LOCAL, local)):
        b = [ns.bind(h) for h in hs]
        with ns.dag.InputNode() as inp:
            root = b[1].add.bind(b[0].add.bind(inp))
        compiled = ns.compile(root, max_inflight=2)
        try:
            refs = [compiled.execute(ns.value(_vec(i))) for i in (1, 2)]
            with pytest.raises(RuntimeError) as e:
                compiled.execute(ns.value(_vec(3)))
            texts[ns.name] = str(e.value)
            results[ns.name] = [_np(r.get(timeout=TIMEOUT))[0] for r in refs]
        finally:
            compiled.teardown()
    assert texts["port"] == texts["port_local"] == texts["ray_tpu"]
    assert "max_inflight=2" in texts["port"]
    assert results["port"] == results["port_local"] == results["ray_tpu"] \
        == [12.0, 13.0]


def test_teardown_unlinks_every_channel_file(make):
    """Every channel of a fan-out, an allreduce and a device edge exists
    until teardown, which unlinks each file."""
    handles = [make(TorchWorker), make(TorchWorker)]
    local = [TorchWorker(), TorchWorker()]
    for ns, hs in ((PORT, handles), (PORT_LOCAL, local)):
        b = [ns.bind(h) for h in hs]
        with ns.dag.InputNode() as inp:
            shifted = b[1].shift.bind(
                b[0].scale.bind(inp).with_device_transport())
            reduced = ns.dag.collective.allreduce.bind(
                [b[0].scale.bind(inp), b[1].shift.bind(inp)])
            root = ns.dag.MultiOutputNode([shifted, *reduced])
        compiled = ns.compile(root)
        paths = [ch.path for ch in compiled._channels]
        # the input, the device edge, 3 outputs, a contribution, a broadcast
        assert len(paths) == 7
        assert all(os.path.exists(p) for p in paths)
        out = _np(compiled.execute(ns.value(_vec(2))).get(timeout=TIMEOUT))
        assert [o[0] for o in out] == [5.0, 7.0, 7.0]
        compiled.teardown()
        assert not any(os.path.exists(p) for p in paths)


# --- device edges -------------------------------------------------------------

def _device_edge(ns, handles, feeds):
    b = [ns.bind(h) for h in handles]
    with ns.dag.InputNode() as inp:
        root = b[1].shift.bind(b[0].scale.bind(inp).with_device_transport())
    compiled = ns.compile(root, max_inflight=2)
    try:
        assert len(compiled._device_paths) == 1
        out = []
        # two in flight over the edge's one payload slot: the writer
        # snapshots, then waits for the slot
        for i in range(0, len(feeds), 2):
            refs = [compiled.execute(ns.value(f)) for f in feeds[i:i + 2]]
            out += [_np(r.get(timeout=TIMEOUT)) for r in refs]
    finally:
        compiled.teardown()
    return out


def test_device_edge_of_cpu_tensors_takes_the_host_lane(make):
    """A with_device_transport() edge compiled with device="cpu": the
    port's torch stages move each payload over DeviceChannel's host lane
    (counted on both actors, no IPC), with max_inflight=2, and give what
    ray_tpu's jax stages give over its DeviceChannel."""
    feeds = [np.full((4, 4), float(i), np.float32) for i in range(4)]
    jax_pair = [make(JaxWorker), make(JaxWorker)]
    want = _device_edge(REF, jax_pair, feeds)
    for h in jax_pair:
        ray_tpu.kill(h)
    torch_pair = [make(TorchWorker), make(TorchWorker)]

    def counts():
        return np.array(ray_tpu.get([h.counters.remote() for h in torch_pair],
                                    timeout=TIMEOUT))

    before = counts()
    got = _device_edge(PORT, torch_pair, feeds)
    np.testing.assert_equal(got, want)
    np.testing.assert_equal(want, [f * 2.0 + 1.0 for f in feeds])
    nbytes = sum(f.nbytes for f in feeds)
    assert (counts() - before).tolist() == [[0, nbytes], [0, nbytes]]
    local = _device_edge(PORT_LOCAL, [TorchWorker(), TorchWorker()], feeds)
    np.testing.assert_equal(local, want)


def test_device_edge_error_rides_the_control_lane(make):
    """A failure upstream of a device edge reaches the driver through the
    edge (DeviceChannel carries the error marker inline) with the
    reference's text."""
    texts = _error_texts(
        make, [(Boom, ()), (Adder, (1,))],
        lambda b, inp: b[1].add.bind(
            b[0].go.bind(inp).with_device_transport()),
        ref_classes=[(JaxBoom, ()), (Adder, (1,))])
    assert texts["port"] == texts["port_local"] == texts["ray_tpu"] == (
        2.0, "compiled DAG task failed: ValueError('kaboom')")


@pytest.mark.parametrize("keyed", ["LOCAL", "own actor_key"])
def test_a_device_edge_in_one_process_raises_at_compile(keyed, monkeypatch):
    """Hooks that run every actor in this process (LOCAL's ``run``) cannot
    carry a device edge to the card, whose CUDA IPC handles no process
    opens for itself: the compile raises before any loop starts and leaves
    no channel file; compiled for the CPU, the same DAG runs."""
    hooks = (LOCAL if keyed == "LOCAL" else
             DagHooks(actor_key=lambda h: f"mine:{id(h)}", run=LOCAL.run,
                      get=LOCAL.get))
    made = []
    for name in ("Channel", "DeviceChannel"):
        cls = getattr(tcompiled, name)

        def recorded(*args, _cls=cls, **kwargs):
            made.append(_cls(*args, **kwargs))
            return made[-1]

        monkeypatch.setattr(tcompiled, name, recorded)
    started = []
    monkeypatch.setattr(tcompiled, "_dag_exec_loop",
                        lambda *a: started.append(a))
    # the compile's device check passes as on a host with a card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    stages = [TorchWorker(), TorchWorker()]
    with tdag.InputNode() as inp:
        root = actor(stages[1]).shift.bind(
            actor(stages[0]).scale.bind(inp).with_device_transport())
    with pytest.raises(ValueError, match="cannot open its own IPC handles"):
        root.experimental_compile(hooks=hooks, device="cuda")
    assert not started
    # the input's channel, made before the edge raised
    paths = {c.path for c in made}
    assert len(paths) == 1 and not any(os.path.exists(p) for p in paths)
    monkeypatch.undo()
    compiled = root.experimental_compile(hooks=hooks, device="cpu")
    try:
        out = compiled.execute(torch.ones(3)).get(timeout=TIMEOUT)
    finally:
        compiled.teardown()
    assert torch.equal(out, torch.full((3,), 3.0))


def test_compiling_without_a_card_raises():
    """The default device is the card: with none, the compile raises
    before it makes any channel; device="cpu" compiles."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    a = Adder(1)
    with tdag.InputNode() as inp:
        root = actor(a).add.bind(inp)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        root.experimental_compile()
    compiled = root.experimental_compile(device="cpu")
    try:
        assert compiled.execute(torch.ones(2)).get(timeout=TIMEOUT)[0] == 2
    finally:
        compiled.teardown()


# --- the dag phase's two-stage Llama split, on tiny (f32) ------------------

def _tiny_split_reference():
    """ray_tpu's tiny params, the port's copy of them, seeded batches and
    ray_tpu's logits for each."""
    cfg = J_CONFIGS["tiny"]
    jparams = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(18)
    batches = [rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
               for _ in range(4)]
    logits = [np.asarray(j_forward(jparams, b, cfg)) for b in batches]
    # the ids compare exactly: no position sits on a near tie
    for lg in logits:
        top2 = np.sort(lg, axis=-1)[..., -2:]
        assert (top2[..., 1] - top2[..., 0]).min() > 1e-4
    return jparams, batches, logits


def _check_split(outs, logits):
    for o, lg in zip(outs, logits):
        np.testing.assert_array_equal(_np(o["ids"]), lg.argmax(-1))
        np.testing.assert_allclose(_np(o["last"]), lg[:, -1], rtol=1e-5,
                                   atol=1e-5)


def test_tiny_split_under_local_and_ray_tpu_actors(make):
    """stage1.forward.bind(stage0.forward.bind(inp).with_device_transport())
    over chip_smoke.DagStage, split at layer 1: under LOCAL and as ray_tpu
    actors, with two executions in flight, against ray_tpu's forward."""
    jparams, batches, logits = _tiny_split_reference()
    params = params_from_jax(jparams, device="cpu")
    handles = [make(chip_smoke.DagStage, "tiny", s, 1, "cpu") for s in (0, 1)]
    ray_tpu.get([h.build.remote(params) for h in handles], timeout=TIMEOUT)
    local = [chip_smoke.DagStage("tiny", s, 1, "cpu") for s in (0, 1)]
    for stage in local:
        stage.build(params_from_jax(jparams, device="cpu"))
    for ns, hs in ((PORT, handles), (PORT_LOCAL, local)):
        b = [ns.bind(h) for h in hs]
        with ns.dag.InputNode() as inp:
            root = b[1].forward.bind(
                b[0].forward.bind(inp).with_device_transport())
        compiled = ns.compile(root, max_inflight=2)
        x = [torch.as_tensor(b) for b in batches]
        try:
            refs = [compiled.execute(x[0]), compiled.execute(x[1])]
            outs = [refs[0].get(timeout=TIMEOUT)]
            refs.append(compiled.execute(x[2]))
            outs += [refs[1].get(timeout=TIMEOUT), refs[2].get(timeout=TIMEOUT)]
            outs.append(compiled.execute(x[3]).get(timeout=TIMEOUT))
        finally:
            compiled.teardown()
        _check_split(outs, logits)


def test_tiny_split_over_spawned_stage_processes():
    """chip_smoke.dag_pipeline, the dag phase's own path, on the CPU: the
    two stages in spawned processes placed through MpRunners' DagHooks,
    the hidden over the host lane (the card's takes IPC), both processes
    exit 0 and no channel file is left."""
    jparams, batches, logits = _tiny_split_reference()
    outs, ms, built, stats, paths, exits, _ = chip_smoke.dag_pipeline(
        torch, "tiny", 1, "cpu", [torch.as_tensor(b) for b in batches],
        params=params_from_jax(jparams, device="cpu"))
    _check_split(outs, logits)
    nbytes = 2 * 24 * J_CONFIGS["tiny"].dim * 4 * len(batches)
    assert [(s["ipc_transfers"], s["host_lane_bytes"]) for s in stats] == \
        [(0, nbytes), (0, nbytes)]
    assert len(ms) == len(batches) and exits == [0, 0]
    assert not any(os.path.exists(p) for p in paths)
