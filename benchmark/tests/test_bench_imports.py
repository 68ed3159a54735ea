"""Nothing the benchmark runs loads JAX, flax or the JAX package, compared
by whole top-level names (the port's name begins with the JAX package's),
and the plain references import nothing of the program."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

from benchmark import run

BENCH = Path(run.__file__).resolve().parent


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {n.split(".", 1)[0] for n in _imports(path)}
        assert not tops & set(run.FORBIDDEN), (path, tops & set(run.FORBIDDEN))


def test_references_import_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        tops = {n.split(".", 1)[0] for n in _imports(path)}
        assert run.PROGRAM not in tops, path


def test_a_run_loads_no_forbidden_module():
    """A tiny run of a cell of each configuration, in a fresh process, with
    every per-layer reader loaded."""
    code = """
import json, sys
from benchmark import run
from benchmark.tests import tiny
spec = run.load_spec()
for m in spec["per_layer"]:
    run.metric_module(m["name"])
for cell, make in (("clipvip_b32.train_graphed", tiny.clipvip), ("lfvila_stage1.index", tiny.lfvila)):
    wl, cfg = make(cell)
    run.execute(cell, 7, 0.2, True, device="cpu", wl=wl, cfg=cfg)
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert run.PROGRAM in loaded
    assert not loaded & set(run.FORBIDDEN), loaded & set(run.FORBIDDEN)
