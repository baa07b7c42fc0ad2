"""The PyTorch port imports neither JAX nor the JAX package ``repro``.

In a fresh interpreter with ``sys.modules["jax"] = None`` (so any import
of JAX fails), every module of ``repro_torch`` and ``chip_smoke`` (whose
work sits under ``if __name__ == "__main__"``) must import, and no
``repro`` module may have been loaded.  The same holds for the port's
examples (``examples_torch/*.py``, work under ``main``) and its scripts
(``scripts/lint_stencils_torch.py``, ``scripts/make_experiments_tables_torch.py``;
``scripts/ci_torch.sh`` runs only the port's files), for the conformance
cases ``chip_smoke.py`` shares with the CPU suite
(``tests/_torch_conformance_cases.py``), and for its benchmarks
(``benchmarks_torch/*.py``, which import neither ``jax`` nor ``repro``
nor the reference's ``benchmarks``).
"""
from __future__ import annotations

import json
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

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


# The tile kernel's round plan: every name is defined in kernels/tiling.py.
PLAN_NAMES = {
    "DEFAULT_TILES", "STRIP_CELLS", "default_tile", "index_inputs",
    "float_inputs", "stage_tails", "tap_reach", "frame_width", "TapColumn",
    "tap_columns", "StageRegion", "stage_regions", "tap_loads", "RoundPlan",
    "round_plan", "smem_bytes_estimate",
}


@pytest.mark.parametrize("module", ["repro_torch.core.model",
                                    "repro_torch.kernels.tiling"])
def test_the_ranker_and_the_round_plan_load_no_torch(module):
    """The ranker and the round plan it prices are arithmetic: in a fresh
    interpreter importing either loads no torch.  The imports run one
    way (tiling, then cuda_build, then stencil), and the plan's names are
    defined in kernels/tiling.py alone."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    probe = (f"import sys, {module}; "
             "print(sorted(m for m in sys.modules if m.startswith('torch')))")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
    kernels = ROOT / "src" / "repro_torch" / "kernels"
    assert "repro_torch.kernels.stencil" not in (
        kernels / "cuda_build.py").read_text()
    top = re.compile(r"^(?:def|class) (\w+)|^(\w+) = ", re.M)
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        defined = {a or b for a, b in top.findall(path.read_text())}
        if path == kernels / "tiling.py":
            assert PLAN_NAMES <= defined
        else:
            assert not defined & PLAN_NAMES, path


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
TABLES_SCRIPT = ROOT / "scripts" / "make_experiments_tables_torch.py"
CONFORMANCE_CASES = ROOT / "tests" / "_torch_conformance_cases.py"
CI_SCRIPT = ROOT / "scripts" / "ci_torch.sh"
PORT_FILES = [LINT_SCRIPT, TABLES_SCRIPT, CONFORMANCE_CASES]

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
        [sys.executable, "-c", FILES_SCRIPT, *map(str, EXAMPLES + PORT_FILES)],
        cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report == {"repro": [], "jax": []}


def test_examples_and_scripts_never_name_jax_or_repro():
    """The import lines of the examples, the scripts and the conformance
    cases, and every command of the CI script, name the port only."""
    for path in EXAMPLES + PORT_FILES:
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


BENCH_FILES = sorted((ROOT / "benchmarks_torch").glob("*.py"))

BENCH_SCRIPT = r"""
import importlib, json, sys
sys.modules["jax"] = None
sys.modules["benchmarks"] = None
for name in sys.argv[1:]:
    importlib.import_module("benchmarks_torch." + name)
loaded = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
jax = sorted(m for m in sys.modules if (m == "jax" or m.startswith("jax."))
             and sys.modules[m] is not None)
print(json.dumps({"repro": loaded, "jax": jax}))
"""


def test_benchmarks_import_neither_jax_nor_repro_nor_benchmarks():
    """Every module of ``benchmarks_torch/`` imports with JAX and the
    reference's ``benchmarks`` blocked, and loads no ``repro`` module."""
    assert {p.stem for p in BENCH_FILES} == {
        "common", "run", "intensity", "single_pe", "best_config",
        "speedup_vs_soda", "parallelism_sweep", "lm_roofline",
        "serving_throughput", "cold_start", "model_accuracy",
        "serving_latency"}
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    proc = subprocess.run(
        [sys.executable, "-c", BENCH_SCRIPT, *(p.stem for p in BENCH_FILES)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report == {"repro": [], "jax": []}


def test_benchmarks_never_name_jax_repro_or_benchmarks():
    """The import lines of ``benchmarks_torch/`` name the port only (a
    lazy import inside a function would escape the subprocess check)."""
    for path in BENCH_FILES:
        for line in path.read_text().splitlines():
            code = line.split("#", 1)[0].strip()
            if code.startswith(("import ", "from ")):
                mod = code.split()[1]
                assert not mod.startswith(("jax", "repro.")), line
                assert mod not in ("repro", "benchmarks"), line
                assert not mod.startswith("benchmarks."), line


def _load(path: Path, name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cell(status, seconds=0.0, args=None, temps=None, terms=(0, 0, 0),
          useful=0.0, fits=True):
    """One results entry in the reference's schema (the fields both
    scripts read), as ``dryrun_results.json`` holds it."""
    if status != "ok":
        return {"status": status, "seconds": seconds, "report": None}
    names = ("compute", "memory", "collective")
    return {"status": "ok", "seconds": seconds, "report": {
        "memory_per_chip": {"arguments": args, "temps": temps,
                            "peak": args + temps},
        "fits": fits, "bottleneck": names[terms.index(max(terms))],
        "useful_flops_ratio": useful,
        **{f"{n}_term": t for n, t in zip(names, terms)}}}


def test_tables_script_rows_match_the_reference():
    """On one results dict the port's tables have the reference's rows
    (the header's seconds column is named for what the port measures),
    and the counts of ok and skipped cells are right."""
    ref = _load(ROOT / "scripts" / "make_experiments_tables.py", "_ref_tables")
    port = _load(TABLES_SCRIPT, "_port_tables")
    results = {
        "granite_3_2b|train_4k|16x16": _cell(
            "ok", 41.2, 18.43 * 2**30, 3.1 * 2**30, (0.0998, 7.32, 0.236),
            0.74),
        "mamba2_130m|decode_32k|2x16x16": _cell(
            "ok", 9.8, 0.12 * 2**30, 0.05 * 2**30, (1.07e-6, 8.46e-4, 6.65e-5),
            0.41),
        "yi_34b|long_500k|16x16": _cell("skipped"),
        "granite_3_2b|long_500k|2x16x16": _cell("skipped"),
        "internlm2_1_8b|decode_32k|16x16": _cell(
            "ok", 12.0, 3.0 * 2**30, 0.26 * 2**30, (2.69e-5, 0.159, 2.49e-3),
            0.93, fits=False),
    }
    hill = {"granite_3_2b|train_4k|16x16": _cell(
        "ok", 40.0, 9.0 * 2**30, 2.0 * 2**30, (0.09, 3.5, 0.2), 0.8)}
    for name, args in (("dryrun_table", (results,)),
                       ("roofline_table", (results, hill))):
        want = getattr(ref, name)(*args).splitlines()
        got = getattr(port, name)(*args).splitlines()
        assert got[2:] == want[2:], name
        assert got[1] == want[1] and len(got) == len(want)
    assert len(port.dryrun_table(results).splitlines()) == 2 + 5
    assert len(port.roofline_table(results).splitlines()) == 2 + 3
    assert port.counts(results) == (3, 2, 0)
    failed = dict(results, **{"yi_34b|train_4k|16x16": _cell("failed", 3.0)})
    assert port.counts(failed) == (3, 2, 1)
    assert "| yi_34b | train_4k | 16x16 | failed | 3 |" in port.dryrun_table(
        failed)


def test_tables_script_fills_a_document(tmp_path):
    """``--doc`` replaces both markers in place; a record with no
    arguments/temps split shows dashes, not a split made up from peak."""
    port = _load(TABLES_SCRIPT, "_port_tables_doc")
    cell = _cell("ok", 5.0, 2**30, 2**30, (1.0, 2.0, 0.5), 0.5)
    del cell["report"]["memory_per_chip"]["arguments"]
    del cell["report"]["memory_per_chip"]["temps"]
    res = tmp_path / "dryrun_results.json"
    res.write_text(json.dumps({"a|train_4k|16x16": cell,
                               "b|long_500k|16x16": _cell("skipped")}))
    doc = tmp_path / "DOC.md"
    doc.write_text("# x\n<!-- DRYRUN_TABLE -->\n\n<!-- ROOFLINE_TABLE -->\n")
    assert port.main(["--results", str(res), "--doc", str(doc),
                      "--hillclimb", str(tmp_path / "none.json")]) == 0
    text = doc.read_text()
    assert "<!--" not in text
    assert "| a | train_4k | 16x16 | ok | 5 | — | — | True |" in text
    assert "| a | train_4k | 16x16 | 1.000 | 2.000 | 0.500 | memory | 0.50 |" \
        in text
