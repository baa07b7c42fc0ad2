"""The port's dry-run (``repro_torch.launch.dryrun``): production cells
on torch's ``fake`` process group of 256 and 512 ranks, in a subprocess
(the port of ``tests/test_dryrun_machinery.py``'s script); and the CLI's
``skipped`` and results-file behaviour.

Bounds: each cell ``ok`` and ``fits`` (per-rank peak memory within the
H100's 80 GB), with compute and memory terms above 0; the process leaves
no process group behind.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")

SCRIPT = r"""
import json, sys
import torch.distributed as dist
from repro_torch.launch import dryrun

out = {}
for arch, shape, multi_pod in (("mamba2_130m", "decode_32k", False),
                               ("internlm2_1_8b", "decode_32k", True)):
    res = dryrun.lower_cell(arch, shape, multi_pod=multi_pod, verbose=False,
                            hbm_limit=80e9, dump_dir=sys.argv[1])
    assert res.status == "ok", res
    assert not dist.is_initialized()
    out[f"{arch}|{shape}|{res.mesh}"] = dict(
        report=res.report, op_dump=res.op_dump)
print("DRYRUN_MACHINERY_OK " + json.dumps(out))
"""


@pytest.mark.slow
def test_dryrun_runs_small_cells(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp_path)], capture_output=True,
        text=True, timeout=900, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("DRYRUN_MACHINERY_OK ")][-1]
    cells = json.loads(line.split(" ", 1)[1])
    for key, cell in cells.items():
        rep = cell["report"]
        assert rep["fits"], (key, rep["memory_per_chip"])
        assert rep["compute_term"] > 0 and rep["memory_term"] > 0, key
        assert rep["chips"] == (512 if key.endswith("2x16x16") else 256)
        assert 0 < rep["memory_per_chip"]["peak"] <= 80e9
        assert os.path.exists(cell["op_dump"]), key


def test_skipped_cell_needs_no_process_group(tmp_path):
    """A cell the reference skips is skipped before any group exists;
    the CLI merges it into its results file."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun

    res = dryrun.lower_cell("granite_3_2b", "long_500k")
    assert res.status == "skipped" and "full-attention" in res.reason
    assert not dist.is_initialized()
    results = tmp_path / "r.json"
    dryrun.main(["--arch", "granite_3_2b", "--shape", "long_500k",
                 "--results", str(results)])
    assert json.loads(results.read_text())[
        "granite_3_2b|long_500k|16x16"]["status"] == "skipped"
    assert not dist.is_initialized()
