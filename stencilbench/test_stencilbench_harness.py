"""A whole run of each cell on the CPU, on the port's plain versions at
small grids: the program's outputs pass the cell's own limits; the
control (the program's bfloat16 path) and each fault planted under the
timed path fail them; the command refuses to run without a card."""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from stencilbench import faults, harness

ROOT = Path(__file__).resolve().parents[1]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
CPU = torch.device("cpu")


def run(root, cell, seed=2**31 + 11, **kw):
    bench = harness.Bench(root)
    return harness.run_cell(bench.cell(cell), seed, 0.2, False, CPU,
                            time.perf_counter(), **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct_on_the_cpu(tiny_root, cell):
    r = run(tiny_root, cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"cell_updates_per_s", "solve_ms_p95",
                                 "setup_s"}
    assert r["design"]["path"] == "tile_pipeline"
    c = r["checks"]["max_rel_err"]
    assert 0 <= c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_bfloat16_is_not_correct(tiny_root, cell):
    r = run(tiny_root, cell, dtype="bfloat16")
    assert not r["correct"] and r["failed"] >= 1


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(tiny_root, cell, fault):
    with faults.planted(fault):
        r = run(tiny_root, cell)
    assert not r["correct"]
    assert r["checks"]["max_rel_err"]["value"] > 1e3 * r["checks"][
        "max_rel_err"]["limit"]


def test_a_cell_without_limits_is_not_correct(tiny_root):
    (tiny_root / "stencilbench" / "limits" / f"{CELLS[0]}.json").unlink()
    r = run(tiny_root, CELLS[0])
    assert not r["correct"] and r["checks"]["max_rel_err"]["limit"] is None


def test_a_cell_on_more_than_one_chip_is_refused(tiny_root):
    doc = json.loads((tiny_root / "BENCHMARK.json").read_text())
    doc["workloads"][0]["chips"] = 4
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="one card"):
        harness.Bench(tiny_root).cell(CELLS[0])


def test_solves_take_the_pool_in_turn_and_keep_each_output(tiny_root):
    cell = harness.Bench(tiny_root).cell(CELLS[0])
    design = harness.tune(cell, CPU)
    pool = harness.make_pool(cell, 2**31 + 9, CPU)
    batches = [harness.batch(pool, b) for b in range(cell.mix.pool_batches)]
    done = harness.solves(design.runner.batched, batches, 4, first=2)
    P = cell.mix.pool_batches
    assert [(i, b) for i, b, _ in done] == [(i, i % P) for i in range(2, 6)]
    assert harness.is_correct(harness.compare(cell, pool, done[:1]))
    assert pool["in_1"].dtype == getattr(torch, cell.config.DTYPE)


def test_same_seed_same_inputs(tiny_root):
    cell = harness.Bench(tiny_root).cell(CELLS[0])
    a = harness.make_pool(cell, 2**31 + 5, CPU)
    b = harness.make_pool(cell, 2**31 + 5, CPU)
    c = harness.make_pool(cell, 2**31 + 6, CPU)
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not all(torch.equal(a[n], c[n]) for n in a)
    assert all(bool((x >= 0).all() and (x < 1).all()) for x in a.values())


def test_reservoir_keeps_a_seeded_sample():
    def sample(seed, n=500):
        r = harness.Reservoir(3, seed)
        for i in range(n):
            r.offer(i, i % 3, torch.tensor(float(i)))
        return [i for i, _, _ in r.kept]

    assert sample(1) == sample(1) and len(set(sample(1))) == 3
    assert sample(1) != sample(2)
    assert sample(1, n=2) == [0, 1]


def test_command_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "stencilbench/run.py", "--workload", CELLS[0],
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "needs 1 CUDA device" in proc.stderr


@pytest.mark.gpu
def test_cell_runs_on_the_card():
    """On a card: one short run of the first cell through the command."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tile kernel has no CPU mode")
    proc = subprocess.run(
        [sys.executable, "stencilbench/run.py", "--workload", CELLS[0],
         "--seed", str(2**31 + 21), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu", r
