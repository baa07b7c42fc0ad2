"""The ``tma_window_pct`` reader: the share of the tile kernel's
floating-input windows loaded by one tensor copy each, from the port's
counters ``launch_tile_kernel.windows_tma`` and ``.windows``.

It gives the share from counters set by hand and from the launch plans of
the benchmark's picks (100 where every window takes the copy, 0 in the
periodic cell, whose blocks all wrap their halo), and nothing where no
kernel was launched or the port lacks the counters.  A traced run of a
tiny cell on the CPU (the plain versions, which launch no kernel) leaves
it out."""
from __future__ import annotations

import json
import time
from pathlib import Path

import pytest
import torch

from repro_torch import trace
from repro_torch.configs import stencils
from repro_torch.kernels import stencil, tiling
from repro_torch.kernels.stencil import launch_tile_kernel
from stencilbench import harness, tracing, yardstick

ROOT = Path(__file__).resolve().parents[1]
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in DOC["workloads"]]
COUNTERS = ("windows_tma", "windows")
METRIC = "tma_window_pct"


def read(rec):
    path = ROOT / "stencilbench" / "metrics" / f"{METRIC}.py"
    return harness.load_module(path, "program_metric_tma_window").read(rec)


def records():
    work = yardstick.solve_work(5, 8, (9720, 1024), 8, 64).times(10)
    t = tracing.Trace(2.0, 1.9, [("sasa_tile_kernel", 0.0, 1.9)], [], [])
    return harness.Records({"dispatch": [1e-3] * 10}, 10, 2.0, work,
                           {"s": 8, "tile": [64, 64], "path": "tile_pipeline"},
                           t)


@pytest.fixture
def counters(monkeypatch):
    """Sets the window counters by hand."""
    def put(copied, windows):
        for name, v in zip(COUNTERS, (copied, windows)):
            monkeypatch.setattr(launch_tile_kernel, name, v)
    return put


# The benchmark's picks (name, shape, s, tile) and the reading each gives.
PICKS = [
    ("jacobi2d", (9720, 1024), 8, (64, 64), 100.0),
    ("jacobi2d", (9720, 1024), 1, (128, 64), 100.0),
    ("blur_jacobi2d", (9720, 1024), 2, (64, 64), 100.0),
    ("heat3d", (9720, 32, 32), 2, (16, 8, 32), 100.0),
    ("heat3d", (9720, 32, 32), 1, (16, 8, 32), 100.0),
    ("heat3d_periodic", (9720, 32, 32), 2, (16, 8, 32), 0.0),
]


@pytest.mark.parametrize("name, shape, s, tile, pct", PICKS,
                         ids=[f"{p[0]}-s{p[2]}" for p in PICKS])
def test_the_reader_gives_the_share_of_the_picks(counters, name, shape, s,
                                                 tile, pct):
    spec = stencils.get(name, shape=shape)
    plan = stencil._launch_plan(spec, s, tile)
    batches = 8 * 3
    counters(batches * tiling.tma_windows(spec, plan), batches * plan.windows)
    assert read(records()) == pct


def test_the_reader_gives_the_share_of_counters_set_by_hand(counters):
    counters(3, 4)
    assert read(records()) == 75.0


def test_no_launch_reads_nothing(counters):
    counters(0, 0)
    assert read(records()) is None


def test_a_port_without_the_counters_reads_nothing(counters, monkeypatch):
    """As the parent commit's port: neither window counter exists."""
    counters(0, 100)
    assert read(records()) == 0.0
    monkeypatch.delattr(launch_tile_kernel, "windows_tma")
    assert read(records()) is None
    monkeypatch.delattr(launch_tile_kernel, "windows")
    assert read(records()) is None


def test_the_metric_lists_the_cells_whose_metrics_no_test_pins():
    """The blur cell's last two per-layer metrics and the periodic cell's
    last are pinned (``test_stencilbench_blur_jacobi2d.py``,
    ``test_stencilbench_heat3d_periodic.py``), so the metric leaves both
    cells out."""
    by_name = {m["name"]: m for m in DOC["per_layer"]}
    metric = by_name[METRIC]
    assert metric["workloads"] == [
        c for c in CELLS
        if c not in ("blur_jacobi2d.ens8.it64", "heat3d_periodic.ens8.it64")]
    assert (metric["layer"], metric["moves"], metric["source"],
            metric["unit"], metric["better"]) == (
        "kernel K2", "cell_updates_per_s", "program_counter", "%", "higher")
    assert DOC["per_layer"][-1] is metric


@pytest.mark.parametrize("cell", [CELLS[0], CELLS[1]])
def test_a_traced_cpu_run_leaves_the_reading_out(tiny_root, monkeypatch,
                                                 counters, cell):
    # The CPU has no device kernel for the trace's reduction to find.
    monkeypatch.setattr(tracing, "reduce_profile", lambda prof: tracing.Trace(
        1.0, 0.5, [("sasa_tile_kernel", 0.0, 0.5)], [], []))
    counters(0, 0)
    trace.reset()
    r = harness.run_cell(harness.Bench(tiny_root).cell(cell), 2**31 + 47,
                         0.2, True, torch.device("cpu"), time.perf_counter())
    assert r["correct"], r["checks"]
    assert METRIC not in r["metrics"]
