"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's), and the reference imports nothing of the program."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

from gpubench import run

BENCH = Path(__file__).resolve().parent.parent


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not set(_imports(path)) & set(run.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "ray_tpu_torch" not in set(_imports(path)), path


def test_a_run_loads_no_forbidden_module(tiny_root):
    code = (
        "import sys, time, torch\n"
        "from pathlib import Path\n"
        "from gpubench import run\n"
        f"c = run.load_cell('tiny.serve', Path({str(tiny_root)!r}))\n"
        "run.run_cell(c, 3, 0.5, False, torch.device('cpu'),"
        " time.perf_counter())\n"
        "print(sorted({m.split('.', 1)[0] for m in sys.modules}))\n"
        "print(run.forbidden_modules())\n")
    env = dict(os.environ, PYTHONPATH=str(BENCH.parent))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    loaded, bad = res.stdout.strip().splitlines()[-2:]
    assert "ray_tpu_torch" in loaded       # the program ran
    assert bad == "[]"


def test_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ray_tpu_torch_x", sys)
    assert "ray_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.forbidden_modules()
