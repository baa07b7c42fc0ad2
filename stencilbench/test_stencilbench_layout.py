"""The harness finds a cell by its names alone: a configuration, a mix, a
metric and a limit added as new files, with entries in ``BENCHMARK.json``,
run without an edit to any file already there.  The roofline shares
count the configuration's stated work, whatever fusion depth or tile the
program picked for it."""
from __future__ import annotations

import hashlib
import json
import time

import pytest
import torch

from stencilbench import harness, tracing, yardstick

NEW_CONFIG = '''
import torch
import torch.nn.functional as F

SOURCE = "a 3-point row average, for the layout test"
REDUCED = []
ASSUMED = []
DSL = """\\
kernel: ROWAVG
iteration: {iterations}
input {dtype}: in_1({shape})
output {dtype}: out_1(0,0) = (in_1(0,-1) + in_1(0,0) + in_1(0,1)) / 3
"""
SHAPE = (24, 40)
DTYPE = "float32"
INPUTS = {"in_1": (0.0, 1.0)}
OPS_PER_UPDATE = 3
BYTES_PER_CELL = 8


def reference(inputs, iterations):
    x = inputs["in_1"]
    for _ in range(iterations):
        p = F.pad(x, (1, 1))
        x = (p[..., :-2] + p[..., 1:-1] + p[..., 2:]) / 3
    return x
'''

NEW_METRIC = '''
def read(rec):
    return float(rec.solves)
'''


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "stencilbench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_added_as_files_runs_without_editing_a_file(tiny_root):
    before = digests(tiny_root)
    sb = tiny_root / "stencilbench"
    (sb / "configs" / "rowavg-24x40.py").write_text(NEW_CONFIG)
    (sb / "traffic" / "ens2.it3.json").write_text(json.dumps({
        "grids_per_solve": 2, "iterations": 3, "loop": "closed",
        "clients": 1, "in_flight": 1, "pool_batches": 2}))
    (sb / "metrics" / "solves_in_window.py").write_text(NEW_METRIC)
    (sb / "limits" / "rowavg.ens2.it3.json").write_text(json.dumps(
        {"max_rel_err": {"limit": 1e-6}}))
    doc = json.loads((tiny_root / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "rowavg-24x40", "source": "test",
                           "file": "stencilbench/configs/rowavg-24x40.py",
                           "reduced": [], "why": "test"})
    doc["workloads"].append({"name": "rowavg.ens2.it3",
                             "config": "rowavg-24x40", "traffic": "ens2.it3",
                             "chips": 1, "why": "test"})
    doc["per_layer"].append({"name": "solves_in_window", "unit": "solves",
                             "better": "higher", "source": "host_clock",
                             "layer": "runner", "moves": "cell_updates_per_s",
                             "workloads": ["rowavg.ens2.it3"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(doc))

    bench = harness.Bench(tiny_root)
    cell = bench.cell("rowavg.ens2.it3")
    assert [m["name"] for m, _ in cell.per_layer] == ["solves_in_window"]
    assert cell.solve_work() == yardstick.Work(2 * 24 * 40 * 3,
                                               2 * 24 * 40 * 3 * 3,
                                               2 * 24 * 40 * 8)
    r = harness.run_cell(cell, 2**31 + 3, 0.2, False, torch.device("cpu"),
                         time.perf_counter())
    assert r["correct"], r["checks"]
    assert "solves_in_window" not in [m["name"] for m, _ in
                                      bench.cell(doc["workloads"][0]["name"]).per_layer]
    after = digests(tiny_root)
    assert {p: d for p, d in after.items() if p in before} == before


def records(design, window_s=2.0, kernel_s=1.5):
    work = yardstick.solve_work(5, 8, (9720, 1024), 8, 64).times(100)
    trace = tracing.Trace(window_s, kernel_s,
                          [("sasa_tile_kernel(SasaPtrs, SasaGeom)", 0.0,
                            kernel_s)], [], [])
    return harness.Records({}, 100, window_s, work, design, trace)


def read(name, rec):
    return harness.load_module(
        harness.Bench(harness.Path(__file__).resolve().parents[1]).folder
        / "metrics" / f"{name}.py", f"layout_{name}").read(rec)


@pytest.mark.parametrize("name", ["sasa_tile_kernel_roofline",
                                  "solve_roofline"])
def test_roofline_shares_ignore_the_programs_fusion_and_tile(name):
    a = read(name, records({"s": 8, "tile": [64, 64], "path": "tile_pipeline"}))
    b = read(name, records({"s": 1, "tile": [128, 64], "path": "single_pe"}))
    assert a == b and 0 < a <= 100
    least = yardstick.least_time_s(records({}).work)
    want = least / (1.5 if name.startswith("sasa") else 2.0) * 100
    assert a == pytest.approx(want)


def test_kernel_roofline_is_silent_without_its_kernel():
    rec = records({})
    rec.trace.kernels = [("another_kernel", 0.0, 1.0)]
    assert read("sasa_tile_kernel_roofline", rec) is None
    assert read("launches_per_solve", rec) == pytest.approx(0.01)
