"""The ``reciprocal_div_per_update`` reader: divisions the tile kernel's
stages compute through a reciprocal of a constant divisor, per cell
update, from the port's counters ``launch_tile_kernel.divides_reciprocal``
and ``.updates_issued``.

It gives the ratio from counters set by hand and from the launch plans
of the benchmark's picks (1 where each update divides by 5 or 9 once, 0
where none divides), and nothing where no kernel was launched or the port
lacks the division counter.  A traced run of a tiny cell on the CPU (the
plain versions, which launch no kernel) leaves it out."""
from __future__ import annotations

import json
import time
from pathlib import Path

import pytest
import torch

from repro_torch import trace
from repro_torch.configs import stencils
from repro_torch.kernels import stencil
from repro_torch.kernels.stencil import launch_tile_kernel
from stencilbench import harness, tracing, yardstick

ROOT = Path(__file__).resolve().parents[1]
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in DOC["workloads"]]
COUNTERS = ("divides_reciprocal", "updates_issued")


def read(rec):
    path = ROOT / "stencilbench" / "metrics" / "reciprocal_div_per_update.py"
    return harness.load_module(path, "program_metric_reciprocal_div").read(rec)


def records():
    work = yardstick.solve_work(5, 8, (9720, 1024), 8, 64).times(10)
    t = tracing.Trace(2.0, 1.9, [("sasa_tile_kernel", 0.0, 1.9)], [], [])
    return harness.Records({"dispatch": [1e-3] * 10}, 10, 2.0, work,
                           {"s": 8, "tile": [64, 64], "path": "tile_pipeline"},
                           t)


@pytest.fixture
def counters(monkeypatch):
    """Sets the division and update counters by hand."""
    def put(divides, issued):
        for name, v in zip(COUNTERS, (divides, issued)):
            monkeypatch.setattr(launch_tile_kernel, name, v)
    return put


# The benchmark's picks (name, shape, s, tile) and the reading each gives.
PICKS = [
    ("jacobi2d", (9720, 1024), 8, (64, 64), 1.0),
    ("jacobi2d", (9720, 1024), 1, (128, 64), 1.0),
    ("blur_jacobi2d", (9720, 1024), 2, (64, 64), 1.0),
    ("heat3d", (9720, 32, 32), 2, (16, 8, 32), 0.0),
    ("heat3d", (9720, 32, 32), 1, (16, 8, 32), 0.0),
]


@pytest.mark.parametrize("name, shape, s, tile, ratio", PICKS)
def test_the_reader_gives_divisions_per_update_of_the_picks(
        counters, name, shape, s, tile, ratio):
    plan = stencil._launch_plan(stencils.get(name, shape=shape), s, tile)
    batches = 8 * 3
    counters(batches * plan.divides_reciprocal, batches * plan.issued)
    assert read(records()) == ratio
    assert plan.divides_ieee == 0


def test_no_launch_reads_nothing(counters):
    counters(0, 0)
    assert read(records()) is None


def test_a_port_without_the_division_counter_reads_nothing(counters,
                                                           monkeypatch):
    """As the parent commit's port: updates counted, divisions not."""
    counters(0, 100)
    assert read(records()) == 0.0
    monkeypatch.delattr(launch_tile_kernel, "divides_reciprocal")
    assert read(records()) is None


def test_the_metric_lists_every_cell_but_the_blur_cell():
    """The blur cell's last two per-layer metrics are pinned
    (``test_stencilbench_blur_jacobi2d.py``), so the metric leaves it
    out, as ``smem_loads_per_update`` does."""
    by_name = {m["name"]: m for m in DOC["per_layer"]}
    metric = by_name["reciprocal_div_per_update"]
    assert metric["workloads"] == [c for c in CELLS
                                   if c != "blur_jacobi2d.ens8.it64"]
    assert (metric["layer"], metric["moves"], metric["source"]) == (
        "kernel K2", "cell_updates_per_s", "program_counter")


@pytest.mark.parametrize("cell", [CELLS[0], CELLS[1]])
def test_a_traced_cpu_run_leaves_the_reading_out(tiny_root, monkeypatch,
                                                 counters, cell):
    # The CPU has no device kernel for the trace's reduction to find.
    monkeypatch.setattr(tracing, "reduce_profile", lambda prof: tracing.Trace(
        1.0, 0.5, [("sasa_tile_kernel", 0.0, 0.5)], [], []))
    counters(0, 0)
    trace.reset()
    r = harness.run_cell(harness.Bench(tiny_root).cell(cell), 2**31 + 41,
                         0.2, True, torch.device("cpu"), time.perf_counter())
    assert r["correct"], r["checks"]
    assert "reciprocal_div_per_update" not in r["metrics"]
