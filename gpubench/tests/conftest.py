"""Fixtures of the harness's tests: a checkout root of tiny cells on the
CPU, built from the harness's own files and a few of their own.

The harness's tests run apart from the repository's (``python -m pytest
gpubench/tests``). Tests marked ``cuda`` need an NVIDIA card and skip
elsewhere; each decides inside the test.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent

TINY_CONFIG = {
    "hidden_size": 64, "intermediate_size": 128,
    "max_position_embeddings": 512, "num_attention_heads": 4,
    "num_hidden_layers": 2, "num_key_value_heads": 2,
    "rms_norm_eps": 1e-05, "rope_theta": 1000000.0, "sliding_window": None,
    "torch_dtype": "float32", "vocab_size": 2048}

TINY_MOE_CONFIG = dict(TINY_CONFIG, num_local_experts=4,
                       num_experts_per_tok=2)

TINY_TRAFFIC = {
    "load": "closed", "clients": 4, "requests": 400, "order_seed": 0,
    "strata": 4,
    "prompt_tokens": {"dist": "lognormal", "median": 40, "sigma": 0.5,
                      "min": 16, "max": 100},
    "output_tokens": {"dist": "lognormal", "median": 12, "sigma": 0.4,
                      "min": 4, "max": 24},
    "warm_completed": 4}

TINY_SERVE = {
    "driver": "serve_closed",
    "engine": {"max_num_seqs": 4, "page_size": 16, "max_seq_len": 128,
               "num_pages": 33, "decode_burst": 4},
    "trace_seconds": 1, "sample": 8, "control": "program_int8",
    # compared as the cells of BENCHMARK.json are, by the mean gap. In
    # float32 on the CPU the program's mean gap read 0 on 12 seeds in each
    # cell; the controls read 0.00081-0.0020 (int8 program, dense, 4 seeds)
    # and 0.049-0.073 (fp8 reference, mixture, 4 seeds)
    "limits": {"mean_logit_gap": 4e-4, "min_sampled_tokens": 40}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one)")


def _write(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def build_root(root: Path, cells, configs) -> Path:
    """A checkout root at ``root``: the harness's files, and a manifest of
    ``cells`` ({name: (config, traffic, workload dict, traffic dict)})
    over ``configs`` ({name: config dict})."""
    shutil.copytree(BENCH, root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    manifest["configs"] = []
    for name, cfg in configs.items():
        _write(root / "gpubench" / "configs" / f"{name}.json", cfg)
        manifest["configs"].append(
            {"name": name, "source": "test", "reduced": [], "why": "test",
             "file": f"gpubench/configs/{name}.json"})
    manifest["workloads"] = []
    for name, (config, mix, workload, traffic) in cells.items():
        _write(root / "gpubench" / "workloads" / f"{name}.json", workload)
        _write(root / "gpubench" / "traffic" / f"{mix}.json", traffic)
        manifest["workloads"].append(
            {"name": name, "config": config, "traffic": mix, "chips": 1,
             "why": "test"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        m.pop("workloads", None)
    _write(root / "BENCHMARK.json", manifest)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    """Tiny dense and mixture serving cells on the CPU."""
    moe = dict(TINY_SERVE, control="reference_fp8")
    return build_root(tmp_path, {
        "tiny.serve": ("tiny-dense", "tiny_mix", TINY_SERVE, TINY_TRAFFIC),
        "tiny_moe.serve": ("tiny-moe", "tiny_mix", moe, TINY_TRAFFIC),
    }, {"tiny-dense": TINY_CONFIG, "tiny-moe": TINY_MOE_CONFIG})
