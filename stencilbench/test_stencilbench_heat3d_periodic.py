"""HEAT3D-PERIODIC (arXiv:2208.10770, Sec. 5.1, on a torus) in the
benchmark.

The configuration's plain reference equals a direct loop with explicit
modular indices, and its DSL is the port's own copy.  The port's plain
path agrees with the reference within the certified bound, also where a
window is wider than the grid.  The tile kernel's launch plan counts the
window cells wrapped round the grid as a tile-by-tile count does (none
under the other rules), and the reader ``wrapped_load_pct`` gives their
share from counters set by hand and nothing without them."""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import stencils
from repro_torch.core import dsl, model, numerics
from repro_torch.core.autotune import autotune
from repro_torch.core.ir import lower
from repro_torch.core.platform import DEFAULT_GPU
from repro_torch.core.spec import Boundary
from repro_torch.kernels import pipeline, stencil, tiling
from repro_torch.kernels.stencil import launch_tile_kernel
from stencilbench import harness, tracing, yardstick

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "stencilbench" / "configs" / "heat3d_periodic-9720x32x32.py"
CELL = "heat3d_periodic.ens8.it64"
METRIC = "wrapped_load_pct"


def config():
    return harness.load_module(CONFIG, "heat3d_periodic_config")


def heat3d_periodic_loop(x, iterations):
    n0, n1, n2 = x.shape
    for _ in range(iterations):
        y = np.empty_like(x)
        for i in range(n0):
            for j in range(n1):
                for k in range(n2):
                    c = x[i, j, k]
                    y[i, j, k] = (
                        0.125 * (x[(i + 1) % n0, j, k] - 2 * c
                                 + x[(i - 1) % n0, j, k])
                        + 0.125 * (x[i, (j + 1) % n1, k] - 2 * c
                                   + x[i, (j - 1) % n1, k])
                        + 0.125 * (x[i, j, (k + 1) % n2] - 2 * c
                                   + x[i, j, (k - 1) % n2])
                        + c)
        x = y
    return x


@pytest.mark.parametrize("iterations", [1, 3])
def test_reference_matches_a_direct_loop_with_modular_indices(iterations):
    cfg = config()
    assert "boundary: periodic" in cfg.DSL and cfg.REDUCED == []
    assert any("periodic" in a for a in cfg.ASSUMED)
    shape = (5, 4, 6)
    grids = np.random.default_rng(21).uniform(0, 1, (2,) + shape)
    got = cfg.reference({"in_1": torch.from_numpy(grids)}, iterations)
    assert got.dtype == torch.float64
    for b in range(2):
        np.testing.assert_allclose(
            got[b].numpy(), heat3d_periodic_loop(grids[b], iterations),
            rtol=1e-13, atol=1e-15)


def test_the_config_is_the_ports_heat3d_periodic():
    """The frozen DSL parses to the port's own copy, boundary included."""
    cfg = config()
    mine = dsl.parse(cfg.DSL.format(iterations=4, dtype="float",
                                    shape="9720, 32, 32"))
    port = stencils.heat3d_periodic()
    assert mine == port and mine.shape == cfg.SHAPE
    assert mine.boundary.kind == "periodic"


# (shape, iterations, s, tile): the first two pass through ``autotune``
# (s = 0), the rest run the round loop at a given depth and tile; each
# window overhangs its grid on some axis, (3, 5, 4) at s = 4 on every
# axis by more than the grid.
PLAIN = [
    ((12, 10, 9), 8, 0, None),
    ((20, 6, 12), 5, 0, None),
    ((3, 5, 4), 9, 4, (3, 5, 4)),
    ((16, 12, 40), 6, 2, (16, 8, 32)),
    ((7, 9, 11), 5, 3, (5, 4, 8)),
]


@pytest.mark.parametrize("shape, iterations, s, tile", PLAIN,
                         ids=[f"{c[0]}-s{c[2]}" for c in PLAIN])
def test_the_ports_plain_path_matches_the_reference(shape, iterations, s,
                                                    tile):
    cfg = config()
    text = cfg.DSL.format(iterations=iterations, dtype="float",
                          shape=", ".join(map(str, shape)))
    spec = dsl.parse(text)
    grids = np.random.default_rng(22).uniform(0, 1, (2,) + shape)
    x = torch.from_numpy(grids.astype(np.float32))
    if s:
        assert any(w > n for w, n in zip(
            tiling.round_plan(spec, s, tile).window, shape))
        got = pipeline.stencil_run_batched(lower(spec).spec, {"in_1": x},
                                           iterations, s=s, tile=tile)
    else:
        runner = autotune(text, iterations=iterations,
                          device="cpu").runner.batched
        assert runner.path == "tile_pipeline"
        got = runner.dispatch(runner.stage({"in_1": x})).out
    want = cfg.reference({"in_1": torch.from_numpy(grids)}, iterations)
    for b in range(2):
        bound = numerics.tolerance_for(spec, iterations,
                                       {"in_1": grids[b].astype(np.float32)})
        err = float((got[b].double() - want[b]).abs().max())
        assert err <= bound, (b, err, bound)


def brute_force_wrapped(spec, s, tile):
    """Per grid, tile by tile: the window cells (the tile and ``h`` cells
    a side, one window per floating input) of which some coordinate lies
    outside the grid."""
    h = s * spec.radius
    n_in = len(tiling.float_inputs(spec))
    wrapped = 0
    for tc in itertools.product(*(range(math.ceil(n / t))
                                  for n, t in zip(spec.shape, tile))):
        origin = [i * t for i, t in zip(tc, tile)]
        for cell in itertools.product(*(range(o - h, o + t + h)
                                        for o, t in zip(origin, tile))):
            wrapped += n_in * any(not 0 <= c < n
                                  for c, n in zip(cell, spec.shape))
    return wrapped


def with_boundary(spec, kind):
    return dataclasses.replace(spec, boundary=Boundary(
        kind, 1.5 if kind == "constant" else 0.0))


WRAP_CASES = [
    ("heat3d_periodic", (20, 12, 40), 1, (8, 8, 32)),
    ("heat3d_periodic", (20, 12, 40), 2, (8, 8, 32)),
    ("heat3d_periodic", (20, 12, 40), 4, (8, 8, 32)),
    ("heat3d_periodic", (20, 12, 40), 1, (5, 4, 16)),
    ("heat3d_periodic", (20, 12, 40), 2, (5, 4, 16)),
    ("heat3d_periodic", (20, 12, 40), 4, (5, 4, 16)),
    ("jacobi2d", (40, 36), 2, (16, 16)),
    ("jacobi2d", (40, 36), 3, (13, 64)),
    ("hotspot", (24, 20), 2, (8, 8)),     # two floating inputs
]


@pytest.mark.parametrize("name, shape, s, tile", WRAP_CASES,
                         ids=[f"{c[0]}-s{c[2]}-{c[3]}" for c in WRAP_CASES])
def test_the_wrapped_count_is_counted_tile_by_tile(name, shape, s, tile):
    spec = with_boundary(stencils.get(name, shape=shape), "periodic")
    plan = stencil._launch_plan(spec, s, tile)
    clipped = tuple(min(t, n) for t, n in zip(tile, shape))
    assert plan.wrapped == brute_force_wrapped(spec, s, clipped) > 0
    assert plan.wrapped < plan.window_cells


@pytest.mark.parametrize("kind", ["zero", "constant", "replicate"])
@pytest.mark.parametrize("name, shape, s, tile", [WRAP_CASES[1],
                                                  WRAP_CASES[6]],
                         ids=["heat3d", "jacobi2d"])
def test_no_cell_is_wrapped_under_the_other_rules(kind, name, shape, s,
                                                  tile):
    spec = with_boundary(stencils.get(name, shape=shape), kind)
    plan = stencil._launch_plan(spec, s, tile)
    assert plan.wrapped == 0
    periodic = stencil._launch_plan(with_boundary(spec, "periodic"), s, tile)
    assert periodic._replace(wrapped=0) == plan


def test_the_cells_design_reads_as_predicted():
    """At the cell's size: the ranker prices the torus as the zero
    boundary (s = 2 on 16x8x32 tiles); every one of the 2432 blocks is an
    edge block, and 3,908,096 of a grid's 21,012,480 window cells a round
    are wrapped (20x12x36 windows over a 32-cell row)."""
    port = stencils.heat3d_periodic()
    picks = [model.choose_best(sp, DEFAULT_GPU, iterations=64)[0]
             for sp in (port, stencils.heat3d())]
    assert picks[0] == picks[1]
    cfg = picks[0].config
    assert (cfg.s, cfg.tile_rows, picks[0].rounds) == (2, 16, 32)
    plan = stencil._launch_plan(port, 2, (16, 8, 32))
    assert plan.window == (20, 12, 36) and plan.smem_bytes == 69120
    assert (plan.tiles, plan.edge_tiles) == (2432, 2432)
    assert (plan.wrapped, plan.window_cells) == (3908096, 21012480)
    assert 100 * plan.wrapped / plan.window_cells == pytest.approx(
        18.5989278752)
    assert plan.issued / plan.useful == pytest.approx(1.2480967078)
    assert plan.tap_loads / plan.issued == pytest.approx(5.3664839468)
    assert lower(port).spec.wrap_index_inputs == ()


def read(rec):
    path = ROOT / "stencilbench" / "metrics" / f"{METRIC}.py"
    return harness.load_module(path, f"periodic_metric_{METRIC}").read(rec)


def records():
    work = yardstick.solve_work(15, 8, (9720, 32, 32), 8, 64).times(10)
    t = tracing.Trace(2.0, 1.9, [("sasa_tile_kernel", 0.0, 1.9)], [], [])
    return harness.Records({"dispatch": [1e-3] * 10}, 10, 2.0, work,
                           {"s": 2, "tile": [16, 8, 32],
                            "path": "tile_pipeline"}, t)


@pytest.fixture
def counters(monkeypatch):
    """Sets ``.wrapped_cells`` and ``.window_cells`` by hand."""
    def put(wrapped, window):
        monkeypatch.setattr(launch_tile_kernel, "wrapped_cells", wrapped)
        monkeypatch.setattr(launch_tile_kernel, "window_cells", window)
    return put


def test_the_reader_gives_the_share(counters):
    counters(8 * 3908096, 8 * 21012480)
    assert read(records()) == pytest.approx(18.5989278752)
    counters(0, 400)
    assert read(records()) == 0.0


def test_no_counters_read_nothing(counters, monkeypatch):
    counters(0, 0)
    assert read(records()) is None
    counters(3, 5)
    assert read(records()) is not None
    # as the parent commit's port: windows counted, wrapped cells not
    monkeypatch.delattr(launch_tile_kernel, "wrapped_cells")
    assert read(records()) is None
    monkeypatch.delattr(launch_tile_kernel, "window_cells")
    assert read(records()) is None


def test_a_traced_cpu_run_leaves_the_counter_metric_out(tiny_root,
                                                        monkeypatch,
                                                        counters):
    # The CPU has no device kernel for the trace's reduction to find.
    monkeypatch.setattr(tracing, "reduce_profile", lambda prof: tracing.Trace(
        1.0, 0.5, [("sasa_tile_kernel", 0.0, 0.5)], [], []))
    counters(0, 0)
    cell = harness.Bench(tiny_root).cell(CELL)
    assert [m["name"] for m, _ in cell.per_layer][-1] == METRIC
    r = harness.run_cell(cell, 2**31 + 43, 0.2, True, torch.device("cpu"),
                         time.perf_counter())
    assert r["correct"], r["checks"]
    assert METRIC not in r["metrics"]
    assert "sasa_tile_kernel_roofline" in r["metrics"]


def test_the_cell_and_its_metric_in_the_benchmark():
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in doc["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "heat3d_periodic-9720x32x32", "ens8.it64", 1)
    by_name = {m["name"]: m for m in doc["per_layer"]}
    metric = by_name[METRIC]
    assert metric["workloads"] == [CELL]
    assert (metric["layer"], metric["moves"], metric["source"],
            metric["unit"], metric["better"]) == (
        "kernel K2", "cell_updates_per_s", "program_counter", "%", "lower")
    listed = [m["name"] for m in doc["per_layer"]
              if CELL in m.get("workloads", [CELL])]
    assert len(listed) == 15 and listed[-1] == METRIC
    assert not {"local_redundant_ratio", "halo_overfetch_pct"} & set(listed)
