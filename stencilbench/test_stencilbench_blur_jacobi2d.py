"""BLUR-JACOBI2D (arXiv:2208.10770, Listing 4) in the benchmark.

The configuration's plain reference equals a direct loop over the cells
(the DSL as written, ``temp`` reading zero outside the grid) and the
port's oracle.  The tile kernel's launch plan counts its ``local``
stages' updates, and its staged window cells and those the taps reach,
as a tile-by-tile count does; the readers ``local_redundant_ratio`` and
``halo_overfetch_pct`` give their value from counters set by hand and
nothing without them."""
from __future__ import annotations

import itertools
import json
import math
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import stencils
from repro_torch.core import dsl
from repro_torch.core.spec import refs_in
from repro_torch.kernels import cuda_build, stencil
from repro_torch.kernels.ref import stencil_iterations_ref
from repro_torch.kernels.stencil import launch_tile_kernel
from stencilbench import harness, tracing, yardstick

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "stencilbench" / "configs" / "blur_jacobi2d-9720x1024.py"
CELL = "blur_jacobi2d.ens8.it64"
COUNTERS = ("local_updates_issued", "local_updates_useful", "window_cells",
            "reach_cells")


def config():
    return harness.load_module(CONFIG, "blur_jacobi2d_config")


def at(x, i, j):
    """``x[i, j]``, or 0 outside the grid."""
    if 0 <= i < x.shape[0] and 0 <= j < x.shape[1]:
        return x[i, j]
    return 0.0


def blur_jacobi2d_loop(x, iterations):
    for _ in range(iterations):
        temp = np.zeros_like(x)
        for i in range(x.shape[0]):
            for j in range(x.shape[1]):
                temp[i, j] = (at(x, i - 1, j) + at(x, i - 1, j + 1)
                              + at(x, i - 1, j + 2) + at(x, i, j)
                              + at(x, i, j + 1) + at(x, i, j + 2)
                              + at(x, i + 1, j) + at(x, i + 1, j + 1)
                              + at(x, i + 1, j + 2)) / 9
        y = np.zeros_like(x)
        for i in range(x.shape[0]):
            for j in range(x.shape[1]):
                y[i, j] = (at(temp, i, j + 1) + at(temp, i + 1, j)
                           + at(temp, i, j) + at(temp, i, j - 1)
                           + at(temp, i - 1, j)) / 5
        x = y
    return x


@pytest.mark.parametrize("iterations", [1, 3])
def test_reference_matches_a_direct_loop_and_the_ports_oracle(iterations):
    cfg = config()
    assert "boundary:" not in cfg.DSL and cfg.REDUCED == []
    shape = (7, 9)
    grids = np.random.default_rng(11).uniform(0, 1, (2,) + shape)
    got = cfg.reference({"in": torch.from_numpy(grids)}, iterations)
    for b in range(2):
        np.testing.assert_allclose(got[b].numpy(),
                                   blur_jacobi2d_loop(grids[b], iterations),
                                   rtol=1e-13, atol=1e-15)
    spec = dsl.parse(cfg.DSL.format(iterations=iterations, dtype="float64",
                                    shape="7, 9"))
    oracle = stencil_iterations_ref(spec, {"in": torch.from_numpy(grids)})
    assert oracle.dtype == torch.float64
    assert float((got - oracle).abs().max()) <= 1e-12


def test_the_config_is_the_ports_listing_4():
    """The frozen DSL parses to the stages of the port's own copy."""
    cfg = config()
    mine = dsl.parse(cfg.DSL.format(iterations=4, dtype="float",
                                    shape="9720, 1024"))
    port = stencils.blur_jacobi2d()
    assert mine.stages == port.stages and mine.shape == cfg.SHAPE
    assert [st.is_output for st in mine.stages] == [False, True]


def one_sided(shape):
    return dsl.parse(f"""
kernel: ONESIDED
iteration: 4
input float: in_1({shape[0]}, {shape[1]})
output float: out_1(0,0) = (in_1(0,0) + in_1(0,1) + in_1(0,2) + in_1(1,0)) / 4
""")


def reach_box(spec, s):
    """Per axis, how far below and above a cell the taps of ``s``
    iterations reach, from the Minkowski sum of every stage's tap set."""
    reached = {(0,) * spec.ndim}
    for _ in range(s):
        for st in reversed(spec.stages):
            taps = {ref.offsets for ref in refs_in(st.expr)}
            reached = {tuple(a + b for a, b in zip(p, t))
                       for p in reached for t in taps}
    return [(-min(min(p[d] for p in reached), 0),
             max(max(p[d] for p in reached), 0)) for d in range(spec.ndim)]


def brute_force_counts(spec, s, tile):
    """The four per-grid counts, tile by tile: each local stage of each
    fused iteration updates the tile dilated by what the later stages and
    iterations still read; each tile stages one window (the tile and
    ``h`` cells a side) per floating input, of whose cells those within
    the taps' reach of the tile count as reached."""
    radii = [st.radius for st in spec.stages]
    r = sum(radii)
    h = s * r
    box = reach_box(spec, s)
    n_in = len(cuda_build.float_inputs(spec))
    issued = window = reached = 0
    for tc in itertools.product(*(range(math.ceil(n / t))
                                  for n, t in zip(spec.shape, tile))):
        origin = [i * t for i, t in zip(tc, tile)]
        for j in range(s):
            for k, st in enumerate(spec.stages):
                if st.is_output:
                    continue
                e = (s - 1 - j) * r + sum(radii[k + 1:])
                issued += math.prod(t + 2 * e for t in tile)
        for cell in itertools.product(*(range(o - h, o + t + h)
                                        for o, t in zip(origin, tile))):
            window += n_in
            reached += n_in * all(
                o - lo <= c < o + t + hi
                for c, o, t, (lo, hi) in zip(cell, origin, tile, box))
    useful = math.prod(spec.shape) * s * len(spec.local_stages)
    return issued, useful, window, reached


CASES = [
    ("blur_jacobi2d", (40, 36), 1, (16, 16)),
    ("blur_jacobi2d", (40, 36), 2, (16, 16)),
    ("blur_jacobi2d", (40, 36), 4, (8, 16)),
    ("jacobi2d", (40, 36), 2, (16, 16)),
    ("hotspot", (24, 20), 2, (8, 8)),
    ("one_sided", (30, 20), 3, (8, 8)),
]


@pytest.mark.parametrize("name, shape, s, tile", CASES,
                         ids=[f"{c[0]}-s{c[2]}" for c in CASES])
def test_the_plans_counts_are_counted_tile_by_tile(name, shape, s, tile):
    spec = (one_sided(shape) if name == "one_sided"
            else stencils.get(name, shape=shape))
    plan = stencil._launch_plan(spec, s, tile)
    got = (plan.local_issued, plan.local_useful, plan.window_cells,
           plan.reach_cells)
    assert got == brute_force_counts(spec, s, tile)
    assert [list(side) for side in stencil.tap_reach(spec)] == [
        [lo // s, hi // s] for lo, hi in reach_box(spec, s)]
    if name in ("jacobi2d", "hotspot"):
        assert plan.local_useful == 0 and plan.window_cells == plan.reach_cells
    else:
        assert plan.reach_cells < plan.window_cells


def test_the_cells_design_reads_as_predicted():
    """At the cell's size and the ranker's pick (s = 2, 64x64): the taps
    reach 2 rows a side and 1 column left, 3 right, so a 72x72 box of the
    76x76 window."""
    spec = stencils.blur_jacobi2d()
    assert stencil.tap_reach(spec) == [(2, 2), (1, 3)]
    plan = stencil._launch_plan(spec, 2, (64, 64))
    assert plan.local_issued * 2 * 9720 * 1024 == plan.local_useful * 2432 * (
        72**2 + 66**2)
    assert 100 * (1 - plan.reach_cells / plan.window_cells) == pytest.approx(
        100 * (1 - 72**2 / 76**2))
    assert plan.issued / plan.useful == pytest.approx(1.1322788066, rel=1e-9)


def read(name, rec):
    path = ROOT / "stencilbench" / "metrics" / f"{name}.py"
    return harness.load_module(path, f"blur_metric_{name}").read(rec)


def records():
    work = yardstick.solve_work(14, 8, (9720, 1024), 8, 64).times(10)
    t = tracing.Trace(2.0, 1.9, [("sasa_tile_kernel", 0.0, 1.9)], [], [])
    return harness.Records({"dispatch": [1e-3] * 10}, 10, 2.0, work,
                           {"s": 2, "tile": [64, 64], "path": "tile_pipeline"},
                           t)


@pytest.fixture
def counters(monkeypatch):
    """Sets the four counters by hand."""
    def put(*values):
        for name, v in zip(COUNTERS, values):
            monkeypatch.setattr(launch_tile_kernel, name, v)
    return put


def test_the_readers_give_the_ratio_and_the_share(counters):
    counters(11655, 10000, 5776, 5184)
    assert read("local_redundant_ratio", records()) == pytest.approx(1.1655)
    assert read("halo_overfetch_pct", records()) == pytest.approx(
        100 * 592 / 5776)
    counters(0, 0, 400, 400)
    assert read("local_redundant_ratio", records()) is None
    assert read("halo_overfetch_pct", records()) == 0.0


@pytest.mark.parametrize("name", ["local_redundant_ratio",
                                  "halo_overfetch_pct"])
def test_no_counters_read_nothing(counters, monkeypatch, name):
    counters(0, 0, 0, 0)
    assert read(name, records()) is None
    counters(3, 2, 5, 4)
    assert read(name, records()) is not None
    for n in COUNTERS:
        monkeypatch.delattr(launch_tile_kernel, n)
    assert read(name, records()) is None


def test_a_traced_cpu_run_leaves_the_counter_metrics_out(tiny_root,
                                                         monkeypatch,
                                                         counters):
    # The CPU has no device kernel for the trace's reduction to find.
    monkeypatch.setattr(tracing, "reduce_profile", lambda prof: tracing.Trace(
        1.0, 0.5, [("sasa_tile_kernel", 0.0, 0.5)], [], []))
    counters(0, 0, 0, 0)
    bench = harness.Bench(tiny_root)
    cell = bench.cell(CELL)
    assert [m["name"] for m, _ in cell.per_layer][-2:] == [
        "local_redundant_ratio", "halo_overfetch_pct"]
    r = harness.run_cell(cell, 2**31 + 37, 0.2, True, torch.device("cpu"),
                         time.perf_counter())
    assert r["correct"], r["checks"]
    assert not {"local_redundant_ratio", "halo_overfetch_pct"} & set(
        r["metrics"])


def test_the_metrics_list_only_the_blur_jacobi2d_cell():
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    by_name = {m["name"]: m for m in doc["per_layer"]}
    for name in ("local_redundant_ratio", "halo_overfetch_pct"):
        assert by_name[name]["workloads"] == [CELL]
