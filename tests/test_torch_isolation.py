"""The PyTorch port imports neither JAX nor the JAX package ``repro``.

In a fresh interpreter with ``sys.modules["jax"] = None`` (so any import
of JAX fails), every module of ``repro_torch`` and ``chip_smoke`` (whose
work sits under ``if __name__ == "__main__"``) must import, and no
``repro`` module may have been loaded.  The same holds for the port's
examples (``examples_torch/*.py``, work under ``main``) and its scripts
(``scripts/lint_stencils_torch.py``; ``scripts/ci_torch.sh`` runs only
the port's files).
"""
from __future__ import annotations

import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None
import repro_torch
names = ["repro_torch"] + [
    m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
]
for n in names:
    importlib.import_module(n)
import chip_smoke
loaded = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
jax = sorted(m for m in sys.modules if (m == "jax" or m.startswith("jax."))
             and sys.modules[m] is not None)
print(json.dumps({"modules": names, "repro": loaded, "jax": jax}))
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["repro"] == [] and report["jax"] == []
    want = {"repro_torch." + m.name for m in pkgutil.walk_packages(
        [str(ROOT / "src" / "repro_torch")]
    )}
    assert want <= set(report["modules"])
    assert {
        "repro_torch.kernels.stencil", "repro_torch.kernels.pipeline",
        "repro_torch.core.autotune", "repro_torch.runtime.batching",
        "repro_torch.core.analysis", "repro_torch.core.numerics",
        "repro_torch.runtime.bucketing", "repro_torch.runtime.cache",
        "repro_torch.serve", "repro_torch.serve.engine",
        "repro_torch.core.distribute",
        "repro_torch.train", "repro_torch.train.trainer",
        "repro_torch.optim", "repro_torch.optim.optimizer",
        "repro_torch.data", "repro_torch.data.pipeline",
        "repro_torch.checkpoint", "repro_torch.checkpoint.checkpoint",
        "repro_torch.launch", "repro_torch.launch.mesh",
        "repro_torch.launch.sharding", "repro_torch.launch.train",
        "repro_torch.launch.dryrun",
        "repro_torch.roofline", "repro_torch.roofline.analysis",
    } <= set(report["modules"])


def test_port_sources_never_name_jax_or_repro():
    """A lazy import would escape the subprocess check; grep the sources."""
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            code = line.split("#", 1)[0].strip()
            if code.startswith(("import ", "from ")):
                mod = code.split()[1]
                assert not mod.startswith(("jax", "repro.")) and mod != "repro", (
                    f"{path.relative_to(ROOT)}: {line.strip()}"
                )


EXAMPLES = sorted((ROOT / "examples_torch").glob("*.py"))
LINT_SCRIPT = ROOT / "scripts" / "lint_stencils_torch.py"
CI_SCRIPT = ROOT / "scripts" / "ci_torch.sh"

FILES_SCRIPT = r"""
import importlib.util, json, sys
sys.modules["jax"] = None
for i, path in enumerate(sys.argv[1:]):
    spec = importlib.util.spec_from_file_location(f"_port_file_{i}", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
jax = sorted(m for m in sys.modules if (m == "jax" or m.startswith("jax."))
             and sys.modules[m] is not None)
print(json.dumps({"repro": loaded, "jax": jax}))
"""


def test_examples_and_scripts_import_neither_jax_nor_repro():
    assert {p.name for p in EXAMPLES} == {
        "quickstart.py", "serve_stencils.py", "stencil_multidevice.py",
        "train_lm.py", "serve_lm.py", "elastic_restart.py"}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", FILES_SCRIPT, *map(str, EXAMPLES),
         str(LINT_SCRIPT)], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report == {"repro": [], "jax": []}


def test_examples_and_scripts_never_name_jax_or_repro():
    """The import lines of the examples and the lint script, and every
    command of the CI script, name the port only."""
    for path in EXAMPLES + [LINT_SCRIPT]:
        for line in path.read_text().splitlines():
            code = line.split("#", 1)[0].strip()
            if code.startswith(("import ", "from ")):
                mod = code.split()[1]
                assert not mod.startswith(("jax", "repro.")) and mod != "repro", (
                    f"{path.relative_to(ROOT)}: {line.strip()}")
    for line in CI_SCRIPT.read_text().splitlines():
        code = line.split("#", 1)[0]
        assert "repro." not in code and "-m repro " not in code, line
        assert "examples/" not in code and "benchmarks/" not in code, line
