"""The ``smem_loads_per_update`` reader: shared-memory tap loads the tile
kernel's stages issue per cell update, from the port's counters
``launch_tile_kernel.smem_tap_loads`` and ``.updates_issued``.

It gives the ratio from counters set by hand and from the launch plans
of the benchmark's picks, and nothing where no kernel was launched or the
port lacks the load counter.  A traced run of a tiny cell on the CPU (the
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
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
COUNTERS = ("smem_tap_loads", "updates_issued")


def read(rec):
    path = ROOT / "stencilbench" / "metrics" / "smem_loads_per_update.py"
    return harness.load_module(path, "program_metric_smem_loads").read(rec)


def records():
    work = yardstick.solve_work(5, 8, (9720, 1024), 8, 64).times(10)
    t = tracing.Trace(2.0, 1.9, [("sasa_tile_kernel", 0.0, 1.9)], [], [])
    return harness.Records({"dispatch": [1e-3] * 10}, 10, 2.0, work,
                           {"s": 8, "tile": [64, 64], "path": "tile_pipeline"},
                           t)


@pytest.fixture
def counters(monkeypatch):
    """Sets the load and update counters by hand."""
    def put(loads, issued):
        for name, v in zip(COUNTERS, (loads, issued)):
            monkeypatch.setattr(launch_tile_kernel, name, v)
    return put


# The benchmark's picks (name, shape, s, tile), the reading each gives,
# and the taps of an update it stays below.
PICKS = [
    ("jacobi2d", (9720, 1024), 8, (64, 64), 3.3795930462, 5),
    ("jacobi2d", (9720, 1024), 1, (128, 64), 3.359375, 5),
    ("blur_jacobi2d", (9720, 1024), 2, (64, 64), 3.7246439361, 7),
    ("heat3d", (9720, 32, 32), 2, (16, 8, 32), 5.3664839468, 7),
    ("heat3d", (9720, 32, 32), 1, (16, 8, 32), 5.25, 7),
]


@pytest.mark.parametrize("name, shape, s, tile, ratio, taps", PICKS)
def test_the_reader_gives_loads_per_update_of_the_picks(
        counters, name, shape, s, tile, ratio, taps):
    plan = stencil._launch_plan(stencils.get(name, shape=shape), s, tile)
    batches = 8 * 3
    counters(batches * plan.tap_loads, batches * plan.issued)
    got = read(records())
    assert got == pytest.approx(ratio, rel=1e-9)
    assert got < taps


def test_no_launch_reads_nothing(counters):
    counters(0, 0)
    assert read(records()) is None


def test_a_port_without_the_load_counter_reads_nothing(counters, monkeypatch):
    """As the parent commit's port: updates counted, loads not."""
    counters(326, 100)
    assert read(records()) == pytest.approx(3.26)
    monkeypatch.delattr(launch_tile_kernel, "smem_tap_loads")
    assert read(records()) is None


@pytest.mark.parametrize("cell", [CELLS[0], CELLS[1]])
def test_a_traced_cpu_run_leaves_the_reading_out(tiny_root, monkeypatch,
                                                 counters, cell):
    # The CPU has no device kernel for the trace's reduction to find.
    monkeypatch.setattr(tracing, "reduce_profile", lambda prof: tracing.Trace(
        1.0, 0.5, [("sasa_tile_kernel", 0.0, 0.5)], [], []))
    counters(0, 0)
    trace.reset()
    r = harness.run_cell(harness.Bench(tiny_root).cell(cell), 2**31 + 37,
                         0.2, True, torch.device("cpu"), time.perf_counter())
    assert r["correct"], r["checks"]
    assert "smem_loads_per_update" not in r["metrics"]
