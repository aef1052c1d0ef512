"""The control of each serving cell, at the cell's own size on the card,
on three seeds: the cell run with its control (``workloads/<cell>.json``'s
``control``) has to come out as not correct. Each seed prints its
readings as one JSON line (``pytest -s``).

- ``program_int8``: the program's own int8 path (weight-only int8,
  ``ops/quant.py::quantize_params``) serves the cell in place of bf16;
  its served tokens are held to the cell's limit.
- ``reference_fp8``: the reference with fp8 weights stands in the
  program's place; at each position of the served sequences, the gap in
  the float32 reference's logits of the token it puts first is held to
  the cell's limits (the ``control_*`` checks).

The same at a size a CPU run holds is ``test_gb_serve_cpu.py``'s
``test_control_fails``.
"""

from __future__ import annotations

import gc
import json
import time

import pytest
import torch

from gpubench import check, run

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["mistral7b.serve.rag",
                                  "mixtral.serve.batch"])
def test_control_fails_on_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cell runs at full size")
    c = run.load_cell(cell)
    seconds = json.loads((run.ROOT / "BENCHMARK.json").read_text())[
        "run_seconds"]
    for seed in SEEDS:
        res = run.run_cell(c, seed, seconds, False, torch.device("cuda"),
                           time.perf_counter(),
                           control=c.workload["control"])
        checks = res["out"]["checks"]
        print(json.dumps({"cell": cell, "seed": seed,
                          "control": c.workload["control"],
                          "checks": checks,
                          "readings": res["out"]["readings"]}), flush=True)
        assert not check.verdict(checks), (cell, seed, checks)
        del res
        gc.collect()
        torch.cuda.empty_cache()
