"""Nothing the benchmark runs loads JAX, the JAX package ``repro`` or the
reference's benchmark folders (whole top-level names: ``repro_torch`` is
not ``repro``), and no configuration's reference imports the port."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

from stencilbench.run import FORBIDDEN

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_nothing_forbidden():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        bad = imported(path) & set(FORBIDDEN)
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_references_import_nothing_of_the_port():
    for path in sorted((HERE / "configs").glob("*.py")):
        assert imported(path) <= {"torch", "numpy", "math", "__future__"}, path


RUN = r"""
import json, sys, time
from pathlib import Path
import torch
from stencilbench import harness
from stencilbench.run import forbidden_modules
root = Path(sys.argv[1])
bench = harness.Bench(root)
for w in bench.doc["workloads"]:
    r = harness.run_cell(bench.cell(w["name"]), 5, 0.05, False,
                         torch.device("cpu"), time.perf_counter())
    assert r["correct"], r
print(json.dumps({"forbidden": forbidden_modules(),
                  "port": "repro_torch.core.autotune" in sys.modules,
                  "top": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_a_run_loads_nothing_forbidden(tiny_root):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-c", RUN, str(tiny_root)],
                          cwd=tiny_root, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["forbidden"] == [] and report["port"]
    assert not set(report["top"]) & set(FORBIDDEN)
