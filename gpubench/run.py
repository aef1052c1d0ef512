"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks
for. The cell's entry in ``BENCHMARK.json`` names its configuration,
whose file it reads; ``gpubench/workloads/<cell>.json`` names its traffic
mix (``gpubench/traffic/<mix>.json``), its driver
(``gpubench/drivers/<kind>.py``), the program's settings and the limits
of the comparison. With ``--trace 0`` the line carries the cell's
end-to-end metrics (``<quantity>.<suffix>``, a quantity split off for some
cells, is the driver's ``<quantity>``), with ``--trace 1`` its per-layer
metrics, each read by
``gpubench/metrics/<metric>.py`` from the run's records; a reader that
finds nothing to read leaves its metric out. The last line of standard
output is the JSON result; the numbers compared, each with its limit, are
the last lines of standard error and the line's last key, ``checks``.

The exit code is not 0, and no result is printed, without the cards the
cell asks for, or when a module of JAX or of the JAX package is loaded
once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tpu")


@dataclasses.dataclass
class Cell:
    """One cell as the files describe it."""
    name: str
    entry: Dict[str, Any]          # its BENCHMARK.json workload entry
    workload: Dict[str, Any]       # gpubench/workloads/<name>.json
    traffic: Dict[str, Any]        # gpubench/traffic/<mix>.json
    config: Dict[str, Any]         # the configuration file
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    root: Path


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` from ``root``'s ``BENCHMARK.json`` and files."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    bench = root / "gpubench"
    workload = json.loads((bench / "workloads" / f"{name}.json").read_text())
    traffic = json.loads(
        (bench / "traffic" / f"{entry['traffic']}.json").read_text())
    return Cell(name, entry, workload, traffic,
                json.loads((root / conf["file"]).read_text()),
                [m for m in manifest["end_to_end"] if _applies(m, name)],
                [m for m in manifest["per_layer"] if _applies(m, name)],
                root)


def load_file(path: Path, kind: str):
    """The module in ``path`` (a driver or a metric's reader)."""
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod_name = "gpubench_" + kind + "_" + "".join(
        ch if ch.isalnum() else "_" for ch in path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell):
    return load_file(cell.root / "gpubench" / "drivers"
                     / f"{cell.workload['driver']}.py", "driver")


def reader(cell: Cell, metric: str):
    return load_file(cell.root / "gpubench" / "metrics" / f"{metric}.py",
                     "metric")


@dataclasses.dataclass
class Ctx:
    """What a driver is given."""
    cell: str
    workload: Dict[str, Any]
    traffic: Dict[str, Any]
    spec: Any                      # spec.ModelSpec
    seed: int
    seconds: float
    trace: bool
    device: Any                    # torch.device
    t_start: float
    control: Optional[str] = None  # None, or the cell's control


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, control: Optional[str] = None) -> Dict[str, Any]:
    """Drive the cell and reduce what it recorded to the result's keys."""
    from gpubench.spec import spec_from_config

    ctx = Ctx(cell.name, cell.workload, cell.traffic,
              spec_from_config(cell.config), seed, seconds, trace, device,
              t_start, control)
    out = driver(cell).run(ctx)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = reader(cell, m["name"]).read(out["records"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        # ``<quantity>.<suffix>`` is the driver's <quantity>, split off for
        # the cells it lists
        metrics = {}
        for m in cell.end_to_end:
            quantity = m["name"].split(".", 1)[0]
            if quantity in out["e2e"]:
                metrics[m["name"]] = {"value": out["e2e"][quantity],
                                      "unit": m["unit"]}
    return {"out": out, "metrics": metrics}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _power_limit() -> Optional[str]:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)

    import torch

    from gpubench import check as chk

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpubench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                   T_START)
    bad = forbidden_modules()
    if bad:
        print(f"gpubench: the run loaded {bad}", file=sys.stderr)
        return 3
    out = res["out"]
    result: Dict[str, Any] = {
        "correct": chk.verdict(out["checks"]),
        "attempted": out["attempted"], "failed": out["failed"],
        "metrics": res["metrics"],
        "device": {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(device),
                   "count": chips,
                   "memory_peak_bytes": out["memory_peak_bytes"]},
        "card": _power_limit(),
    }
    if args.trace:
        tr = out["trace"]
        result["device"]["busy_s"] = tr["busy_s"] if tr else 0.0
        result["device"]["window_s"] = tr["window_s"] if tr else 0.0
        if out.get("breakdown"):
            result["breakdown"] = out["breakdown"]
    result["phases_s"] = out.get("phases")
    result["readings"] = out.get("readings")
    if out["trace"]:
        result["trace"] = {k: out["trace"][k]
                           for k in ("stop_s", "device_events", "edges")}
    result["checks"] = out["checks"]
    for line in chk.check_lines(out["checks"]):
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
