"""The ``edge_block_pct`` reader: the share of the tile kernel's thread
blocks whose window leaves the grid, from the port's counters
``launch_tile_kernel.blocks`` and ``.edge_blocks``.

It gives the share from counters set by hand, and nothing where no block
was launched or the port lacks the counters.  A traced run of a tiny cell
on the CPU (the plain versions, which launch no kernel) leaves it out."""
from __future__ import annotations

import json
import time
from pathlib import Path

import pytest
import torch

from repro_torch import trace
from repro_torch.kernels.stencil import launch_tile_kernel
from stencilbench import harness, tracing, yardstick

ROOT = Path(__file__).resolve().parents[1]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
COUNTERS = ("blocks", "edge_blocks")


def read(rec):
    path = ROOT / "stencilbench" / "metrics" / "edge_block_pct.py"
    return harness.load_module(path, "program_metric_edge_block_pct").read(rec)


def records():
    work = yardstick.solve_work(5, 8, (9720, 1024), 8, 64).times(10)
    t = tracing.Trace(2.0, 1.9, [("sasa_tile_kernel", 0.0, 1.9)], [], [])
    return harness.Records({"dispatch": [1e-3] * 10}, 10, 2.0, work,
                           {"s": 8, "tile": [64, 64], "path": "tile_pipeline"},
                           t)


@pytest.fixture
def counters(monkeypatch):
    """Sets the block counters by hand."""
    def put(blocks, edge):
        for name, v in zip(COUNTERS, (blocks, edge)):
            monkeypatch.setattr(launch_tile_kernel, name, v)
    return put


# Tiles per grid and edge tiles among them in the benchmark's cells, over
# launches of batch 8 and 32 (each launch adds B x the plan's counts).
@pytest.mark.parametrize("tiles,edge,batches,pct", [
    (2432, 2432, 8 * 3, 100.0),
    (2432, 332, 8 * 3, 13.651315789),
    (1216, 180, 32 * 5, 14.802631579),
])
def test_the_reader_gives_the_share_of_edge_blocks(counters, tiles, edge,
                                                   batches, pct):
    counters(tiles * batches, edge * batches)
    assert read(records()) == pytest.approx(pct)


def test_no_block_launched_reads_nothing(counters):
    counters(0, 0)
    assert read(records()) is None


def test_a_port_without_the_counters_reads_nothing(counters, monkeypatch):
    """As the parent commit's port: no block counters on the launch."""
    counters(6, 6)
    assert read(records()) == pytest.approx(100.0)
    for name in COUNTERS:
        monkeypatch.delattr(launch_tile_kernel, name)
    assert read(records()) is None


@pytest.mark.parametrize("cell", [CELLS[0], CELLS[1]])
def test_a_traced_cpu_run_leaves_the_share_out(tiny_root, monkeypatch,
                                               counters, cell):
    # The CPU has no device kernel for the trace's reduction to find.
    monkeypatch.setattr(tracing, "reduce_profile", lambda prof: tracing.Trace(
        1.0, 0.5, [("sasa_tile_kernel", 0.0, 0.5)], [], []))
    counters(0, 0)
    trace.reset()
    r = harness.run_cell(harness.Bench(tiny_root).cell(cell), 2**31 + 31,
                         0.2, True, torch.device("cpu"), time.perf_counter())
    assert r["correct"], r["checks"]
    assert "edge_block_pct" not in r["metrics"]
