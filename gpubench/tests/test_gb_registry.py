"""A later change adds a cell, a mix, a driver or a metric by adding files
and manifest entries alone: the harness finds each by name."""

from __future__ import annotations

import json
import time

import torch

from gpubench import run


def test_new_cell_and_metric_by_files_alone(tiny_root):
    bench = tiny_root / "gpubench"
    # a new mix and cell, and a new per-layer metric with its reader
    mix = json.loads((bench / "traffic" / "tiny_mix.json").read_text())
    mix["clients"] = 2
    (bench / "traffic" / "tiny_pair.json").write_text(json.dumps(mix))
    (bench / "workloads" / "tiny.serve.pair.json").write_text(
        (bench / "workloads" / "tiny.serve.json").read_text())
    (bench / "metrics" / "serve.steps_in_window.py").write_text(
        "from gpubench import work\n\n\n"
        "def read(records):\n"
        "    return float(len(work.window_steps(records)))\n")
    manifest = json.loads((tiny_root / "BENCHMARK.json").read_text())
    manifest["workloads"].append(
        {"name": "tiny.serve.pair", "config": "tiny-dense",
         "traffic": "tiny_pair", "chips": 1, "why": "test"})
    manifest["per_layer"].append(
        {"name": "serve.steps_in_window", "unit": "steps",
         "better": "higher", "source": "program_span", "layer": "engine",
         "moves": "output_tokens_per_s",
         "workloads": ["tiny.serve.pair"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = run.load_cell("tiny.serve.pair", tiny_root)
    assert cell.traffic["clients"] == 2
    assert "serve.steps_in_window" in [m["name"] for m in cell.per_layer]
    assert "serve.steps_in_window" not in [
        m["name"] for m in run.load_cell("tiny.serve", tiny_root).per_layer]
    res = run.run_cell(cell, 11, 1.0, False, torch.device("cpu"),
                       time.perf_counter())
    value = run.reader(cell, "serve.steps_in_window").read(
        res["out"]["records"])
    assert value > 0


def test_manifest_names_files_that_exist():
    root = run.ROOT
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    for c in manifest["configs"]:
        assert (root / c["file"]).is_file()
    for w in manifest["workloads"]:
        cell = run.load_cell(w["name"])
        assert (root / "gpubench" / "drivers"
                / f"{cell.workload['driver']}.py").is_file()
    for m in manifest["per_layer"]:
        assert (root / "gpubench" / "metrics" / f"{m['name']}.py").is_file()
