"""ray_tpu_torch stands alone: it imports neither JAX nor the JAX package
(``ray_tpu``), calls no library attention or compiler, and its entry
points refuse to carry on quietly on the CPU when no card is present."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import resolve_device
from ray_tpu_torch.llm import EngineConfig, LLMEngine, init_kv_cache
from ray_tpu_torch.models import LLAMA_CONFIGS, init_params, params_from_jax

# six xdist workers share the machine's cores
torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "ray_tpu_torch"
TINY = LLAMA_CONFIGS["tiny"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "ray_tpu")


def _port_modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _no_card_env():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_the_walk_covers_every_model_family():
    """The module walk behind the import checks reaches the MoE, SSD and
    Mamba modules as it does the kernels' wrappers."""
    mods = _port_modules()
    for m in ("ray_tpu_torch.ops.moe", "ray_tpu_torch.ops.ssd",
              "ray_tpu_torch.models.mamba", "ray_tpu_torch.ops.attention",
              "ray_tpu_torch.llm.engine", "ray_tpu_torch.rllib",
              "ray_tpu_torch.rllib.grpo", "ray_tpu_torch.rllib.ppo",
              "ray_tpu_torch.rllib.sac", "ray_tpu_torch.rllib.checkpoint"):
        assert m in mods, m


def test_importing_every_module_loads_no_jax():
    """In a fresh interpreter where any import of jax or ray_tpu raises,
    every module of the port imports, and none of them is loaded after."""
    code = f"""
import importlib, json, sys
for m in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                        "ray_tpu")]:
    del sys.modules[m]

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ray_tpu"):
            raise ImportError("forbidden import: " + name)
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, {str(REPO)!r})
for m in {_port_modules()!r}:
    importlib.import_module(m)
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu"))))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(REPO),
                         env=_no_card_env())
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in
    list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]))
def test_source_has_no_jax_import(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_no_library_attention_or_compiler_in_the_port():
    for path in sorted(PKG.rglob("*")):
        if path.suffix not in (".py", ".cu", ".cuh", ".h"):
            continue
        text = path.read_text()
        for word in ("scaled_dot_product_attention", "torch.compile",
                     "cudnn", "flash_attn"):
            assert word not in text, f"{path} mentions {word}"


def test_default_device_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        init_params(TINY, seed=0)
    with pytest.raises(RuntimeError):
        params_from_jax({"w": [1.0]})
    with pytest.raises(RuntimeError):
        init_kv_cache(TINY, 4, 4)
    params = init_params(TINY, seed=0, device="cpu")
    with pytest.raises(RuntimeError):
        LLMEngine(params, TINY, EngineConfig(
            max_num_seqs=1, page_size=4, num_pages=32, max_seq_len=32))
    # the RL algorithms' learners too
    from ray_tpu_torch.rllib import GRPOConfig, PPOConfig, SACConfig

    for config in (PPOConfig(), SACConfig(), GRPOConfig()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            config.build()
    # asked for explicitly, the CPU works
    assert resolve_device("cpu") == torch.device("cpu")
    assert ray_tpu_torch.resolve_device is resolve_device


def test_engine_refuses_params_on_another_device():
    params = init_params(TINY, seed=0, device="meta")
    with pytest.raises(ValueError):
        LLMEngine(params, TINY, EngineConfig(
            max_num_seqs=1, page_size=4, num_pages=32, max_seq_len=32),
            device="cpu")


def test_chip_smoke_fails_without_a_card(tmp_path):
    """With no card visible, and alone in a directory without the rest of
    the repository, chip_smoke.py exits non-zero and prints no result."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", lone)
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, lone)):
        env = _no_card_env()
        env.pop("PYTHONPATH", None)
        out = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, timeout=120,
                             cwd=str(cwd), env=env)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout


# none of these is on the card's machine: the port reads and writes
# safetensors and bf16 itself
HF_LIBRARIES = ("ml_dtypes", "safetensors", "transformers")


def test_the_walk_covers_the_checkpoint_vision_and_data_modules():
    mods = _port_modules()
    for m in ("ray_tpu_torch.models.hf_interop", "ray_tpu_torch.models.clip",
              "ray_tpu_torch.models.vision", "ray_tpu_torch.data",
              "ray_tpu_torch.data.llm"):
        assert m in mods, m


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in
    list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]))
def test_source_imports_no_hf_library(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if n.split(".")[0] in HF_LIBRARIES]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_importing_every_module_loads_no_hf_library():
    """In a fresh interpreter where any import of ml_dtypes, safetensors or
    transformers raises, every module of the port imports."""
    code = f"""
import importlib, json, sys
blocked = {HF_LIBRARIES!r}

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in blocked:
            raise ImportError("forbidden import: " + name)
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, {str(REPO)!r})
for m in {_port_modules()!r}:
    importlib.import_module(m)
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in blocked)))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(REPO),
                         env=_no_card_env())
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_checkpoint_and_vision_entry_points_raise_without_a_card(
        monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from ray_tpu_torch.data import build_llm_processor
    from ray_tpu_torch.models import (CLIP_CONFIGS, RESNET_CONFIGS,
                                      init_clip, init_resnet,
                                      load_hf_checkpoint, save_hf_checkpoint)

    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_clip(CLIP_CONFIGS["tiny"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_resnet(RESNET_CONFIGS["tiny"])
    save_hf_checkpoint(init_params(TINY, seed=0, device="cpu"), TINY,
                       str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_hf_checkpoint(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_llm_processor("tiny")({"prompt_ids": [[1, 2]]})


def test_the_walk_covers_the_device_utilities_and_channels():
    mods = _port_modules()
    for m in ("ray_tpu_torch.util.hbm", "ray_tpu_torch.util.tracing",
              "ray_tpu_torch.data.batches",
              "ray_tpu_torch.experimental.channel",
              "ray_tpu_torch.experimental._transfer_shim",
              "ray_tpu_torch.experimental.device_channel"):
        assert m in mods, m


def test_data_tracing_and_channel_entry_points_raise_without_a_card(
        monkeypatch, tmp_path):
    """With no card: iter_device_batches, profile and the read of a
    device-flagged Channel payload (or of any DeviceChannel payload)
    raise, naming device='cpu', at the call and before they take the
    payload; a Channel is made and written without one, and the HBM
    stats are empty."""
    import numpy as np

    from ray_tpu_torch.data import iter_device_batches
    from ray_tpu_torch.experimental import Channel, DeviceChannel
    from ray_tpu_torch.util import collect_hbm_stats, profile

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        iter_device_batches(iter([{"x": np.zeros(2)}]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with profile(str(tmp_path)):
            pass
    ch = Channel(str(tmp_path / "chan"), create=True, capacity=1 << 12)
    try:
        ch.write(torch.ones(3), timeout=5)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ch.read(0, timeout=5)
        ch.device = "cpu"       # the payload stays until a read takes it
        assert torch.equal(ch.read(0, timeout=5), torch.ones(3))
        ch.device = None
        ch.write(np.ones(3), timeout=5)     # numpy needs no device
        assert isinstance(ch.read(0, timeout=5), np.ndarray)
    finally:
        ch.close()
    dc = DeviceChannel(device="cpu")
    try:
        reader = DeviceChannel(dc.path)
        dc.write({"x": torch.ones(2)}, timeout=5)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            reader.read(timeout=5)
        reader.device = "cpu"
        assert torch.equal(reader.read(timeout=5)["x"], torch.ones(2))
    finally:
        dc.close()
        dc.unlink()
    assert collect_hbm_stats() == []


def test_the_walk_covers_the_server_and_its_metrics():
    mods = _port_modules()
    for m in ("ray_tpu_torch.llm.serve", "ray_tpu_torch.util.metrics"):
        assert m in mods, m


def test_server_entry_points_raise_without_a_card(monkeypatch):
    """With no card visible, LLMServer without device= raises naming
    device='cpu'; build_llm_deployment without the host plane's
    deployment raises naming it."""
    from ray_tpu_torch.llm import LLMServer, build_llm_deployment

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMServer("tiny")
    with pytest.raises(ValueError, match="deployment="):
        build_llm_deployment("tiny")
    server = LLMServer("tiny", device="cpu", engine_config=dict(
        max_num_seqs=1, page_size=4, num_pages=32, max_seq_len=32))
    assert server.engine.device == torch.device("cpu")


def test_the_walk_covers_the_multi_device_plane():
    mods = _port_modules()
    for m in ("ray_tpu_torch.parallel", "ray_tpu_torch.parallel.mesh",
              "ray_tpu_torch.parallel.sharding",
              "ray_tpu_torch.parallel.collectives",
              "ray_tpu_torch.parallel.multislice",
              "ray_tpu_torch.parallel.pipeline",
              "ray_tpu_torch.ops.ring_attention",
              "ray_tpu_torch.train.worker_group", "ray_tpu_torch.exceptions"):
        assert m in mods, m


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in
    list((PKG / "parallel").rglob("*.py"))
    + [PKG / "ops" / "ring_attention.py", PKG / "train" / "worker_group.py"]))
def test_the_multi_device_plane_imports_torch_stdlib_and_numpy(path):
    """Its modules import torch, the stdlib, numpy and the port: no other
    third-party package."""
    tree = ast.parse((REPO / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert (top in ("torch", "numpy", "__future__")
                    or top in sys.stdlib_module_names), f"{path} imports {n}"


def test_mesh_entry_points_raise_without_a_card(monkeypatch):
    """With no card, the mesh, the multislice mesh, the topology, the
    trainer on a mesh and the gang's bring-up raise naming device='cpu'
    when the caller leaves the device to them; no group is made."""
    import types

    import torch.distributed as dist

    from ray_tpu_torch.models import lm_loss, param_logical_axes
    from ray_tpu_torch.parallel import (MeshSpec, build_mesh,
                                        build_multislice_mesh, local_mesh,
                                        slice_topology)
    from ray_tpu_torch.train import (adamw, init_torch_distributed,
                                     make_train_step)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: build_mesh(MeshSpec()), lambda: local_mesh(),
                 lambda: slice_topology(),
                 lambda: build_multislice_mesh({"dp": 1}),
                 lambda: make_train_step(
                     lambda p, b: lm_loss(p, b, TINY), adamw(1e-3),
                     mesh=object(), param_axes=param_logical_axes(TINY)),
                 lambda: init_torch_distributed(types.SimpleNamespace(
                     coordinator_address="localhost:1", world_size=2,
                     rank=0))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not dist.is_initialized()


def test_the_walk_covers_the_runner_hooks_and_the_step_telemetry():
    mods = _port_modules()
    for m in ("ray_tpu_torch.rllib.runners", "ray_tpu_torch.rllib.offline",
              "ray_tpu_torch.train.telemetry", "ray_tpu_torch.train.step"):
        assert m in mods, m


def test_default_runner_hooks_and_the_session_seam_load_no_ray_tpu():
    """In a fresh interpreter where any import of jax or ray_tpu raises:
    PPO and IMPALA with the default hooks train an iteration on the CPU,
    rollout_dataset hands its rows to a plain callable, and the train step
    reports to a session object of the caller's."""
    code = f"""
import json, sys, tempfile, types

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ray_tpu"):
            raise ImportError("forbidden import: " + name)
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, {str(REPO)!r})
import numpy as np
import torch
from ray_tpu_torch.models import LLAMA_CONFIGS, init_params, lm_loss
from ray_tpu_torch.rllib import (LOCAL, IMPALAConfig, PPOConfig,
                                 RunnerHooks, record_rollouts,
                                 rollout_dataset)
from ray_tpu_torch.train import adamw, make_train_step

for config in (PPOConfig(), IMPALAConfig()):
    algo = config.env_runners(rollout_fragment_length=16).training(
        hidden=(8,)).build(device="cpu")
    assert algo.hooks is LOCAL and algo.train()["training_iteration"] == 1
    algo.stop()
tmp = tempfile.mkdtemp()
record_rollouts("CartPole-v1", tmp, num_steps=10)
assert len(rollout_dataset(tmp, list)) == 10

notes = []
session = types.SimpleNamespace(
    telemetry_on=True, note_step=lambda **kw: notes.append(kw),
    timeline=types.SimpleNamespace(record_interval=lambda *a: None))
cfg = LLAMA_CONFIGS["tiny"]
init_fn, step_fn, place = make_train_step(
    lambda p, b: lm_loss(p, b, cfg), adamw(1e-3), device="cpu",
    session=lambda: session)
state = init_fn(init_params(cfg, seed=0, device="cpu"))
tokens = np.zeros((2, 8), np.int32)
state, m = step_fn(state, place({{"tokens": tokens}}))
assert notes[0]["tokens"] == 16 and notes[0]["batch_shape"] == "(2, 8)/int32"
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu"))))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(REPO),
                         env=_no_card_env())
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_hooked_and_instrumented_entry_points_raise_without_a_card(
        monkeypatch, tmp_path):
    """With no card, an algorithm built with hooks, one restored with
    hooks, and make_train_step with a session raise naming device='cpu'
    when the caller leaves the device to them."""
    from ray_tpu_torch.models import lm_loss
    from ray_tpu_torch.rllib import (LOCAL, DQNConfig, IMPALAConfig,
                                     PPOConfig)
    from ray_tpu_torch.rllib.ppo import PPO
    from ray_tpu_torch.train import adamw, make_train_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for config in (PPOConfig(), IMPALAConfig(), DQNConfig()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            config.build(hooks=LOCAL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(lambda p, b: lm_loss(p, b, TINY), adamw(1e-3),
                        session=lambda: None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PPO(PPOConfig(), hooks=LOCAL)
    path = PPOConfig().training(hidden=(8,)).build(
        device="cpu").save_to_path(str(tmp_path / "ck"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PPO.from_checkpoint(path, hooks=LOCAL)


def test_the_walk_covers_the_compiled_dag():
    mods = _port_modules()
    for m in ("ray_tpu_torch.dag", "ray_tpu_torch.dag.nodes",
              "ray_tpu_torch.dag.compiled"):
        assert m in mods, m


def test_the_compiled_dag_under_local_hooks_loads_no_ray_tpu():
    """In a fresh interpreter where any import of jax or ray_tpu raises: a
    compiled DAG under the default hooks, with a device edge of CPU
    tensors, an allreduce and a driver output, runs and tears down."""
    code = f"""
import json, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ray_tpu"):
            raise ImportError("forbidden import: " + name)
        return None

sys.meta_path.insert(0, Block())
sys.path.insert(0, {str(REPO)!r})
import torch
from ray_tpu_torch.dag import InputNode, MultiOutputNode, actor, collective

class Scale:
    def __init__(self, k):
        self.k = k
    def f(self, x):
        return x * self.k

a, b = Scale(2.0), Scale(3.0)
with InputNode() as inp:
    edge = actor(b).f.bind(actor(a).f.bind(inp).with_device_transport())
    root = MultiOutputNode(collective.allreduce.bind(
        [edge, actor(a).f.bind(inp)]))
compiled = root.experimental_compile(device="cpu")
out = compiled.execute(torch.ones(2)).get(timeout=60)
compiled.teardown()
assert [o.tolist() for o in out] == [[8.0, 8.0], [8.0, 8.0]]
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu"))))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(REPO),
                         env=_no_card_env())
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_compiled_dag_raises_without_a_card(monkeypatch):
    """With no card, a compile that leaves the device to the port raises
    naming device='cpu'."""
    from ray_tpu_torch.dag import InputNode, actor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    class Echo:
        def f(self, x):
            return x

    with InputNode() as inp:
        root = actor(Echo()).f.bind(inp)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        root.experimental_compile()
