"""The train step's session seam: ray_tpu_torch's make_train_step(session=)
against ray_tpu's instrumented step.

The port's StepInstrumenter and classify_compile are held against the
reference's on one synthetic clock; the batch signature and token count
against the reference's helpers on the same numpy batches; then both
steps run Llama ``tiny`` (f32) 3 steps in a one-worker
``ray_tpu.train.Trainer`` with telemetry on, and report the same phases,
tokens, flops, chips, compile kind and batch signature a step, which the
job's goodput ledger folds alike.

The cluster's workers see one JAX device (the port's convention, one
card a rank, reports one chip), compile into a fresh XLA cache under
``tmp_path``, and read a compile hit threshold of 0 s, which both steps
take: the reference's first call writes the cache ("cold"), and the
port's builds nothing on the CPU and is decided by its duration.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
from ray_tpu.models import LLAMA_CONFIGS as J_CONFIGS
from ray_tpu.models import init_params as j_init
from ray_tpu.train import RunConfig, ScalingConfig, Trainer
from ray_tpu.train import step as j_step
from ray_tpu.train import telemetry as j_tel

from ray_tpu_torch.models import LLAMA_CONFIGS, lm_loss, params_from_jax
from ray_tpu_torch.train import (StepInstrumenter, adamw, classify_compile,
                                 estimate_flops_per_token, make_train_step)
from ray_tpu_torch.train import step as t_step

# six xdist workers share the machine's cores
torch.set_num_threads(2)

J_TINY = J_CONFIGS["tiny"]
FLOPS_PER_TOKEN = estimate_flops_per_token(J_TINY.n_params())


# --- the instrumenter and the compile classifier ----------------------------

@pytest.mark.parametrize("duration,wrote,threshold", [
    (0.1, 0, 0.5), (0.1, 2, 0.5), (0.7, 0, 0.5), (0.5, 0, 0.5),
    (0.0, 0, 0.0), (3.0, 1, 10.0)])
def test_classify_compile_matches_the_reference(duration, wrote, threshold):
    assert (classify_compile(duration, wrote, threshold)
            == j_tel.classify_compile(duration, wrote, threshold))


class _Clock:
    """A synthetic clock the step function advances, and a cache whose
    entry count the step function grows."""

    def __init__(self):
        self.t = 100.0
        self.entries = 0

    def __call__(self):
        return self.t


# (signature, seconds the call takes, cache entries it writes)
_SCRIPT = [("a", 2.0, 3),     # cold: it wrote the cache
           ("a", 0.25, 0),    # compute
           ("a", 0.25, 0),
           ("b", 0.1, 0),     # recompile, a cache hit by its duration
           ("b", 0.25, 0),
           ("c", 0.9, 0),     # recompile, cold by its duration
           ("a", 0.3, 0)]     # a known signature again: compute


def _drive(cls):
    clock = _Clock()
    recompiles = []
    inst = cls(clock=clock, cache_entries=lambda: clock.entries,
               hit_threshold_s=0.5,
               on_recompile=lambda old, new: recompiles.append((old, new)))
    lasts = []
    for sig, secs, wrote in _SCRIPT:
        def call(secs=secs, wrote=wrote):
            clock.t += secs
            clock.entries += wrote
            return sig
        blocked = []
        out = inst.run(call, sig, block=lambda r: blocked.append(r) or r)
        assert out == sig and blocked == [sig]
        lasts.append(dict(inst.last))
    return lasts, recompiles


def test_step_instrumenter_matches_the_reference():
    got, got_re = _drive(StepInstrumenter)
    want, want_re = _drive(j_tel.StepInstrumenter)
    assert got == want and got_re == want_re
    assert [x["phase"] for x in got] == ["compile", "compute", "compute",
                                         "compile", "compute", "compile",
                                         "compute"]
    assert [x["compile_kind"] for x in got if x["phase"] == "compile"] == [
        "cold", "cache_hit", "cold"]
    assert got_re == [("a", "b"), ("b", "c")]


# --- the batch signature and token count -----------------------------------

def _batches():
    rng = np.random.default_rng(3)
    return [
        {"tokens": rng.integers(0, 256, (4, 24)).astype(np.int32)},
        {"tokens": rng.integers(0, 256, (2, 8)).astype(np.int32),
         "mask": np.ones((2, 8), np.int32)},
        {"image": rng.standard_normal((3, 8, 8, 3)).astype(np.float32),
         "label": np.arange(3, dtype=np.int64)},
        {"x": [np.zeros((5,), np.float16), np.ones((2, 2), bool)],
         "y": np.float32(1.5)},
        [np.zeros((7, 2), np.uint8), np.zeros((3,), np.float64)],
    ]


@pytest.mark.parametrize("i", range(len(_batches())))
def test_batch_signature_and_tokens_match_the_reference(i):
    batch = _batches()[i]
    want_sig = j_step._batch_signature(batch)
    want_tokens = j_step._batch_tokens(batch)

    def as_torch(tree):
        if isinstance(tree, dict):
            return {k: as_torch(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [as_torch(v) for v in tree]
        return torch.from_numpy(np.asarray(tree))

    for got in (batch, as_torch(batch)):
        assert t_step._batch_signature(got) == want_sig
        assert t_step._batch_tokens(got) == want_tokens


def test_bf16_signature_names_numpy_s_dtype():
    x = torch.zeros((2, 3), dtype=torch.bfloat16)
    assert t_step._batch_signature({"h": x}) == j_step._batch_signature(
        {"h": jnp.zeros((2, 3), jnp.bfloat16)}) == "(2, 3)/bfloat16"


# --- the seam, in one process -----------------------------------------------

class _Timeline:
    def __init__(self):
        self.intervals = []

    def record_interval(self, name, t0, t1):
        self.intervals.append((name, t0, t1))


class _Session:
    """Records what the step reports, as ray_tpu.train's session takes it."""

    def __init__(self, on=True):
        self.telemetry_on = on
        self.timeline = _Timeline()
        self.notes = []

    def note_step(self, **kw):
        self.notes.append(kw)


def _tiny_step(session=None, **kw):
    cfg = LLAMA_CONFIGS["tiny"]
    init_fn, step_fn, place = make_train_step(
        lambda p, b: lm_loss(p, b, cfg), adamw(1e-3), device="cpu",
        model_flops_per_token=FLOPS_PER_TOKEN, session=session, **kw)
    params = params_from_jax(jax.tree.map(np.asarray, j_init(
        jax.random.PRNGKey(0), J_TINY)), device="cpu")
    return init_fn(params), step_fn, place


def test_step_reports_phases_and_counts_to_its_session():
    sess = _Session()
    recompiles = []
    state, step_fn, place = _tiny_step(
        lambda: sess, on_recompile=lambda o, n: recompiles.append((o, n)))
    batches = [b for b in _batches()[:2]]
    for b in (batches[0], batches[0], batches[1]):
        state, m = step_fn(state, place(b))
    assert [n for n, _, _ in sess.timeline.intervals] == [
        "host_to_device", "compile", "host_to_device", "compute",
        "host_to_device", "compile"]
    assert all(t1 >= t0 for _, t0, t1 in sess.timeline.intervals)
    sig0 = j_step._batch_signature(batches[0])
    sig1 = j_step._batch_signature(batches[1])
    assert [n["batch_shape"] for n in sess.notes] == [sig0, sig0, sig1]
    assert [n["tokens"] for n in sess.notes] == [96, 96, 16]
    assert [n["flops"] for n in sess.notes] == [
        FLOPS_PER_TOKEN * t for t in (96, 96, 16)]
    assert [n["chips"] for n in sess.notes] == [1, 1, 1]
    assert [n["recompile"] for n in sess.notes] == [False, False, True]
    assert [n["compile_kind"] != "" for n in sess.notes] == [True, False,
                                                             True]
    assert recompiles == [(sig0, sig1)]
    assert step_fn.model_flops_per_token == FLOPS_PER_TOKEN


def test_without_a_session_the_step_is_bare_and_never_syncs(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: synced.append(a))
    batch = _batches()[0]
    results = []
    for session in (None, lambda: None, lambda: _Session(on=False),
                    lambda: _Session(on=True)):
        state, step_fn, place = _tiny_step(session)
        for _ in range(2):
            state, m = step_fn(state, place(batch))
        results.append(m["loss"].item())
    # the CPU has nothing to sync, with a session or without one
    assert synced == []
    assert len(set(results)) == 1
    # with no session callable the factory returns the bare functions
    _, bare, _ = _tiny_step(None)
    assert bare.__name__ == "step_fn"


# --- inside a ray_tpu.train Trainer ------------------------------------------

def test_a_config_read_before_the_cluster_is_replaced_by_its_settings(
        monkeypatch):
    """Reads this process's ray_tpu config, as an earlier test file on the
    same worker may, before ``trainer_cluster`` first starts: the cached
    copy has no peak. The fixture must set its values on the config that
    the in-process GCS reads, or the jobs' ledgers fold no MFU."""
    from ray_tpu._private.config import global_config, reset_global_config

    monkeypatch.delenv("RAY_TPU_TRAIN_PEAK_FLOPS_PER_CHIP", raising=False)
    reset_global_config()
    stale = global_config()
    assert stale.train_peak_flops_per_chip == 0.0
    assert global_config() is stale


@pytest.fixture(scope="module")
def trainer_cluster(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "2")
        mp.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=1")
        mp.setenv("RAY_TPU_MESH_COMPILE_CACHE_DIR",
                  str(tmp_path_factory.mktemp("xla_cache")))
        mp.setenv("RAY_TPU_TRAIN_COMPILE_CACHE_HIT_THRESHOLD_S", "0")
        mp.setenv("RAY_TPU_TRAIN_PEAK_FLOPS_PER_CHIP", "1e12")
        # the workers read the environment when they start; this process
        # reads its config once and caches it, perhaps before this fixture
        # ran, so it is read again from the environment set above
        from ray_tpu._private.config import global_config, reset_global_config

        reset_global_config()
        assert global_config().train_peak_flops_per_chip == 1e12
        ray_tpu.init(num_cpus=4)
        try:
            yield
        finally:
            ray_tpu.shutdown()


def _make_train_fn():
    """The Trainer's worker function, nested so that cloudpickle carries it
    to the workers by value."""

    def _session_train_fn(config):
        """A Trainer worker: the named package's step on Llama tiny with the
        session's note_step and record_interval recorded, one report a
        step."""
        import jax
        import jax.numpy as jnp

        import ray_tpu.train as train
        from ray_tpu._private.config import global_config
        from ray_tpu.train import session as sess_mod

        sess = sess_mod._session
        calls = []
        record, note = sess.timeline.record_interval, sess.note_step

        def spy_record(name, t0, t1):
            calls.append(("interval", name))
            return record(name, t0, t1)

        def spy_note(**kw):
            calls.append(("note", kw))
            return note(**kw)

        sess.timeline.record_interval = spy_record
        sess.note_step = spy_note
        threshold = global_config().train_compile_cache_hit_threshold_s
        if config["package"] == "ray_tpu":
            import optax

            import ray_tpu.parallel as jpar
            from ray_tpu.models import (LLAMA_CONFIGS, lm_loss,
                                        param_logical_axes)
            from ray_tpu.train import make_train_step

            cfg = LLAMA_CONFIGS["tiny"]
            mesh = jpar.build_mesh(jpar.MeshSpec(), jax.devices()[:1])
            init_fn, step_fn, place = make_train_step(
                lambda p, b: lm_loss(p, b, cfg, mesh=mesh), optax.adamw(1e-3),
                mesh, param_logical_axes(cfg),
                model_flops_per_token=config["fpt"])
            state = init_fn(jax.tree.map(jnp.asarray, config["params"]))
            to_device = lambda b: {k: jnp.asarray(v) for k, v in b.items()}
        else:
            import torch

            from ray_tpu_torch.models import (LLAMA_CONFIGS, lm_loss,
                                              params_from_jax)
            from ray_tpu_torch.train import adamw, make_train_step

            torch.set_num_threads(2)
            cfg = LLAMA_CONFIGS["tiny"]
            mesh, kw = None, {}
            if config.get("dp"):
                # the gang's ranks as one dp mesh, each given the batch
                from ray_tpu_torch.models import param_logical_axes
                from ray_tpu_torch.parallel import MeshSpec, build_mesh
                from ray_tpu_torch.train import init_torch_distributed

                init_torch_distributed(train.get_context(), device="cpu",
                                       timeout_s=120)
                mesh = build_mesh(MeshSpec(dp=config["dp"]), device="cpu")
                kw = dict(mesh=mesh, param_axes=param_logical_axes(cfg))
            init_fn, step_fn, place = make_train_step(
                lambda p, b: lm_loss(p, b, cfg, mesh=mesh), adamw(1e-3),
                device="cpu", model_flops_per_token=config["fpt"],
                session=lambda: sess_mod._session,
                compile_hit_threshold_s=threshold, **kw)
            state = init_fn(params_from_jax(config["params"], device="cpu"))
            to_device = lambda b: b
        history, losses = [], []
        for b in config["batches"]:
            state, m = step_fn(state, place(to_device(b)))
            losses.append(float(m["loss"]))
            history.append(list(calls))
            calls.clear()
            train.report({"history": history, "losses": losses,
                          "devices": jax.local_device_count(),
                          "threshold": threshold})
        if config.get("dp"):
            import torch.distributed as dist

            dist.destroy_process_group()

    return _session_train_fn


def _fit(name, package, params, batches, tmp_path, workers=1, dp=0):
    result = Trainer(
        _make_train_fn(),
        train_loop_config={"package": package, "params": params,
                           "batches": batches, "fpt": FLOPS_PER_TOKEN,
                           "dp": dp},
        scaling_config=ScalingConfig(num_workers=workers),
        run_config=RunConfig(name=name, storage_path=str(tmp_path)),
    ).fit()
    assert result.error is None, result.error
    return result.metrics


def _ledger(name, steps=3):
    from ray_tpu.util import state

    deadline = time.time() + 30
    while True:
        jobs = state.train_status(job=name)["jobs"]
        if jobs and getattr(jobs[0], "steps", 0) >= steps:
            return jobs[0]
        assert time.time() < deadline, f"no ledger for {name}: {jobs}"
        time.sleep(0.2)


def test_port_step_reports_to_a_trainer_session_as_the_reference_does(
        trainer_cluster, tmp_path):
    params = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), J_TINY))
    rng = np.random.default_rng(36)
    batches = [{"tokens": rng.integers(0, J_TINY.vocab, (4, 24)).astype(
        np.int32)} for _ in range(3)]
    ref = _fit("session_ref", "ray_tpu", params, batches, tmp_path)
    port = _fit("session_port", "ray_tpu_torch", params, batches, tmp_path)
    assert ref["devices"] == port["devices"] == 1
    assert ref["threshold"] == port["threshold"] == 0.0
    # the same phases a step, in the same order, and the same notes
    assert port["history"] == ref["history"]
    names = [[c[1] for c in step if c[0] == "interval"]
             for step in port["history"]]
    assert names == [["host_to_device", "compile"],
                     ["host_to_device", "compute"],
                     ["host_to_device", "compute"]]
    notes = [[c[1] for c in step if c[0] == "note"][0]
             for step in port["history"]]
    sig = "(4, 24)/int32"
    assert notes[0] == {"tokens": 96, "flops": FLOPS_PER_TOKEN * 96,
                        "chips": 1, "compile_kind": "cold",
                        "recompile": False, "batch_shape": sig}
    assert [n["compile_kind"] for n in notes[1:]] == ["", ""]
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-5,
                               atol=1e-5)
    # the goodput ledger folds both jobs alike
    lr, lp = _ledger("session_ref"), _ledger("session_port")
    for field in ("steps", "chips", "tokens", "flops", "compile_count",
                  "cache_hit_count", "recompile_count"):
        assert getattr(lp, field) == getattr(lr, field), field
    assert (lp.steps, lp.chips, lp.tokens, lp.compile_count) == (3, 1, 288,
                                                                  1)
    assert lp.productive_s > 0 and lp.mfu > 0 and lr.mfu > 0
    assert lp.badput_s.get("compile", 0) > 0
    assert lp.badput_s.get("h2d", 0) > 0


def test_port_mesh_step_in_a_gang_folds_as_the_reference_gang(
        trainer_cluster, tmp_path):
    """Two ranks: the port's step under dp=2 (one rank a card, every rank
    given the whole batch, which the mesh shards) and the reference's gang
    of two one-device steps, each on the whole batch. Each rank reports
    the batch's tokens and flops and one chip, so the goodput ledger's
    fold (a sum over the ranks) gives both jobs the same chips, tokens
    and flops."""
    params = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), J_TINY))
    rng = np.random.default_rng(37)
    batches = [{"tokens": rng.integers(0, J_TINY.vocab, (4, 24)).astype(
        np.int32)} for _ in range(2)]
    ref = _fit("gang_ref", "ray_tpu", params, batches, tmp_path, workers=2)
    port = _fit("gang_port", "ray_tpu_torch", params, batches, tmp_path,
                workers=2, dp=2)
    assert port["history"] == ref["history"]
    lr, lp = _ledger("gang_ref", 2), _ledger("gang_port", 2)
    for field in ("world_size", "steps", "chips", "tokens", "flops",
                  "compile_count", "recompile_count"):
        assert getattr(lp, field) == getattr(lr, field), field
    assert (lp.world_size, lp.chips, lp.tokens) == (2, 2, 2 * 2 * 96)
    assert lp.flops == FLOPS_PER_TOKEN * lp.tokens
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-5,
                               atol=1e-5)
