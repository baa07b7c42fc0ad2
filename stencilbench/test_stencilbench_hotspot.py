"""HOTSPOT at 720x1024 (arXiv:2208.10770, Sec. 5.1, Listing 3, with
Rodinia's coefficients at that size and clamped edges) in the benchmark.

The coefficient formulas give Listing 3's constants at 9720x1024, where
the update is unstable, and a stable one at 720x1024.  The configuration's
plain reference equals a direct loop with clamped indices, and its DSL is
the port's Listing 3 with only the constants and the boundary changed.
The port's plain path agrees with the reference within the certified
bound.  The count of the cells the boundary rule's passes visit equals
a tile-by-tile count, and the launch adds it to
``launch_tile_kernel.fixup_cells``; the reader ``boundary_fixup_pct``
gives its share of the issued updates, and nothing without the counter."""
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
from repro_torch.kernels import pipeline, tiling
from repro_torch.kernels.stencil import launch_tile_kernel
from stencilbench import harness, tracing, yardstick

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "stencilbench" / "configs" / "hotspot-720x1024.py"
CELL = "hotspot.ens64.it64"
METRIC = "boundary_fixup_pct"
# Listing 3's constants, as the paper prints them (Rodinia at 9720x1024).
LISTING = {"step_cap": "1.296", "ry": "0.949219", "rx": "0.010535",
           "rz": "0.00000514403"}


def config():
    return harness.load_module(CONFIG, "hotspot_config")


def sig_digits(literal: str) -> int:
    return len(literal.replace(".", "").lstrip("0"))


def test_the_formulas_give_listing_3_at_9720x1024():
    got = config().coefficients(9720, 1024)
    for key, printed in LISTING.items():
        digits = sig_digits(printed)
        assert float(f"{float(got[key]):.{digits}g}") == float(printed), key


def test_the_formulas_at_720x1024():
    cfg = config()
    assert cfg.coefficients(720, 1024) == cfg.C == {
        "step_cap": "0.096", "ry": "0.0703125", "rx": "0.142222222",
        "rz": "0.0000694444444"}
    assert float(cfg.C["rx"]) == pytest.approx(0.1 * 1024 / 720, rel=1e-8)
    assert float(cfg.C["rz"]) == pytest.approx(51.2 / (720 * 1024), rel=1e-8)


def multipliers(c, rows, cols):
    """Per cosine mode ``cos(pi k (i + 1/2) / n)`` of a clamped grid, the
    factor one update multiplies it by: the largest and the smallest."""
    step, ry, rx, rz = (float(c[k]) for k in ("step_cap", "ry", "rx", "rz"))
    cy = np.cos(np.pi * np.arange(rows) / rows)
    cx = np.cos(np.pi * np.arange(cols) / cols)
    lam = 1 + step * (ry * (2 * cy[:, None] - 2) + rx * (2 * cx[None, :] - 2)
                      - rz)
    return float(lam.max()), float(lam.min())


def test_the_update_is_stable_at_720x1024_and_not_at_9720x1024():
    """Why the size moved: with Listing 3's constants the checkerboard
    mode is multiplied by about -3.98 an update; at 720x1024 every mode's
    factor lies in (0, 1)."""
    hi, lo = multipliers(config().C, 720, 1024)
    assert 0 < lo < hi < 1
    assert lo == pytest.approx(0.91839, abs=1e-5)
    assert hi == pytest.approx(1 - 0.096 * 51.2 / (720 * 1024))
    _, lo = multipliers(LISTING, 9720, 1024)
    assert lo < -3.9


def test_the_cosine_modes_are_the_references_own():
    """One step of the reference moves a clamped grid's cosine mode by the
    factor ``multipliers`` prices (the update is affine: the mode's part
    is the difference of two steps)."""
    cfg = config()
    rows, cols = 12, 16
    step, ry, rx, rz = (float(cfg.C[k]) for k in ("step_cap", "ry", "rx",
                                                   "rz"))
    rng = np.random.default_rng(31)
    base = {n: torch.from_numpy(rng.uniform(0, 1, (1, rows, cols)))
            for n in ("in_1", "in_2")}
    for ky, kx in [(0, 0), (1, 3), (rows - 1, cols - 1)]:
        mode = torch.from_numpy(np.outer(
            np.cos(np.pi * ky * (np.arange(rows) + 0.5) / rows),
            np.cos(np.pi * kx * (np.arange(cols) + 0.5) / cols)))[None]
        moved = dict(base, in_2=base["in_2"] + mode)
        diff = cfg.reference(moved, 1) - cfg.reference(base, 1)
        lam = 1 + step * (ry * (2 * math.cos(math.pi * ky / rows) - 2)
                          + rx * (2 * math.cos(math.pi * kx / cols) - 2)
                          - rz)
        np.testing.assert_allclose(diff.numpy(), lam * mode.numpy(),
                                   atol=1e-13)


def hotspot_loop(power, t, c, iterations):
    rows, cols = t.shape
    step, ry, rx, rz = (float(c[k]) for k in ("step_cap", "ry", "rx", "rz"))
    for _ in range(iterations):
        y = np.empty_like(t)
        for i in range(rows):
            for j in range(cols):
                n, s = t[max(i - 1, 0), j], t[min(i + 1, rows - 1), j]
                w, e = t[i, max(j - 1, 0)], t[i, min(j + 1, cols - 1)]
                x = t[i, j]
                y[i, j] = x + step * ((n + s - x - x) * ry + power[i, j]
                                      + (w + e - x - x) * rx
                                      + (80 - x) * rz)
        t = y
    return t


@pytest.mark.parametrize("iterations", [1, 4])
def test_reference_matches_a_direct_loop_with_clamped_indices(iterations):
    cfg = config()
    assert "boundary: replicate" in cfg.DSL and cfg.REDUCED == []
    assert any("replicate" in a for a in cfg.ASSUMED)
    assert (cfg.OPS_PER_UPDATE, cfg.BYTES_PER_CELL) == (15, 12)
    shape = (7, 9)
    rng = np.random.default_rng(32)
    grids = {n: rng.uniform(0, 1, (2,) + shape) for n in ("in_1", "in_2")}
    got = cfg.reference({n: torch.from_numpy(a) for n, a in grids.items()},
                        iterations)
    assert got.dtype == torch.float64
    for b in range(2):
        np.testing.assert_allclose(
            got[b].numpy(),
            hotspot_loop(grids["in_1"][b], grids["in_2"][b], cfg.C,
                         iterations),
            rtol=1e-13, atol=1e-13)


def test_the_config_is_listing_3_with_its_constants_and_edges():
    """Put Listing 3's printed constants back and drop the boundary line:
    the text parses to the port's own HOTSPOT."""
    cfg = config()
    text = cfg.DSL.format(iterations=4, dtype="float", shape="9720, 1024")
    mine = dsl.parse(text)
    assert mine.boundary.kind == "replicate" and mine.iterate_input == "in_2"
    assert mine.shape == (9720, 1024) and cfg.SHAPE == (720, 1024)
    for key, printed in LISTING.items():
        text = text.replace(f" {cfg.C[key]}", f" {printed}")
    text = text.replace("boundary: replicate\n", "")
    assert dsl.parse(text) == stencils.hotspot()


# (shape, iterations, s, tile): the first passes through ``autotune``
# (s = 0), the rest run the round loop at a given depth and tile, with
# partial last tiles on both axes; (6, 10) at s = 4 has a window wider
# than the grid.
PLAIN = [
    ((40, 52), 6, 0, None),
    ((40, 52), 6, 3, (16, 16)),
    ((37, 45), 7, 2, (16, 32)),
    ((6, 10), 9, 4, (6, 10)),
]


@pytest.mark.parametrize("shape, iterations, s, tile", PLAIN,
                         ids=[f"{c[0]}-s{c[2]}" for c in PLAIN])
def test_the_ports_plain_path_matches_the_reference(shape, iterations, s,
                                                    tile):
    """Within ``numerics.tolerance_for``: the certified first-order bound
    of float32 rounding on these inputs over these iterations, which the
    float64 reference does not incur."""
    cfg = config()
    text = cfg.DSL.format(iterations=iterations, dtype="float",
                          shape=", ".join(map(str, shape)))
    spec = dsl.parse(text)
    rng = np.random.default_rng(33)
    grids = {n: rng.uniform(0, 1, (2,) + shape) for n in ("in_1", "in_2")}
    x = {n: torch.from_numpy(a.astype(np.float32)) for n, a in grids.items()}
    if s:
        got = pipeline.stencil_run_batched(lower(spec).spec, x, iterations,
                                           s=s, tile=tile)
    else:
        runner = autotune(text, iterations=iterations,
                          device="cpu").runner.batched
        assert runner.path == "tile_pipeline"
        got = runner.dispatch(runner.stage(x)).out
    want = cfg.reference({n: torch.from_numpy(a) for n, a in grids.items()},
                         iterations)
    for b in range(2):
        bound = numerics.tolerance_for(
            spec, iterations,
            {n: a[b].astype(np.float32) for n, a in grids.items()})
        err = float((got[b].double() - want[b]).abs().max())
        assert err <= bound, (b, err, bound)


def with_boundary(spec, kind):
    return dataclasses.replace(spec, boundary=Boundary(
        kind, 1.5 if kind == "constant" else 0.0))


def brute_force_outside(spec, s, tile):
    """Per grid, tile by tile: the window cells outside the grid (one
    window per floating input), and over the edge tiles (a window cell
    outside the grid) the cells of every stage region
    (:func:`tiling.stage_regions`) and of the windows."""
    h = s * spec.radius
    n_in = len(tiling.float_inputs(spec))
    region_cells = sum(math.prod(r.extent)
                       for r in tiling.stage_regions(spec, s, tile))
    window = edge_issued = edge_window = 0
    for tc in itertools.product(*(range(math.ceil(n / t))
                                  for n, t in zip(spec.shape, tile))):
        origin = [i * t - h for i, t in zip(tc, tile)]
        extent = [t + 2 * h for t in tile]
        outside = sum(
            any(not 0 <= o + c < n for o, c, n in zip(origin, cell,
                                                       spec.shape))
            for cell in itertools.product(*map(range, extent)))
        window += n_in * outside
        if outside:
            edge_issued += region_cells
            edge_window += n_in * math.prod(extent)
    return window, edge_issued, edge_window


FIXUP_CASES = [
    ("hotspot", (40, 52), 1, (16, 16)),
    ("hotspot", (40, 52), 2, (16, 16)),
    ("hotspot", (40, 52), 4, (16, 32)),
    ("jacobi2d", (37, 30), 2, (13, 64)),
    ("blur_jacobi2d", (30, 28), 1, (16, 16)),     # a local stage
    ("heat3d", (20, 12, 40), 1, (8, 8, 32)),
    ("heat3d", (20, 12, 40), 2, (5, 4, 16)),
    ("heat3d", (9, 7, 12), 4, (4, 4, 8)),
]


@pytest.mark.parametrize("name, shape, s, tile", FIXUP_CASES,
                         ids=[f"{c[0]}-s{c[2]}-{c[3]}" for c in FIXUP_CASES])
def test_the_outside_counts_are_counted_tile_by_tile(name, shape, s, tile):
    spec = stencils.get(name, shape=shape)
    plan = tiling.round_plan(spec, s, tile)
    clipped = tuple(min(t, n) for t, n in zip(tile, shape))
    window, edge_issued, _ = brute_force_outside(spec, s, clipped)
    assert plan.window_outside == window
    assert 0 < plan.window_outside < plan.window_cells
    assert 0 < edge_issued <= plan.issued
    assert tiling.fixup_cells(with_boundary(spec, "replicate"), plan,
                              True) == window + edge_issued


@pytest.mark.parametrize("copied", [True, False])
@pytest.mark.parametrize("kind", ["zero", "constant", "replicate",
                                  "periodic"])
@pytest.mark.parametrize("name, shape, s, tile", [FIXUP_CASES[1],
                                                  FIXUP_CASES[6]],
                         ids=["hotspot", "heat3d"])
def test_each_rule_rewrites_the_cells_of_its_passes(name, shape, s, tile,
                                                    kind, copied):
    """After every stage the replicate rule's pass visits each region
    cell of the edge tiles, and zero and constant have no pass; after the
    load constant and replicate visit each window cell outside the grid,
    zero only where the windows came by row copies; the periodic rule
    has no pass.  The plan's counts do not depend on the rule."""
    spec = with_boundary(stencils.get(name, shape=shape), kind)
    plan = tiling.round_plan(spec, s, tile)
    assert plan._replace(wrapped=0) == tiling.round_plan(
        with_boundary(spec, "zero"), s, tile)
    window, edge_issued, _ = brute_force_outside(spec, s, tile)
    load = kind in ("constant", "replicate") or (kind == "zero"
                                                 and not copied)
    want = 0 if kind == "periodic" else (
        (kind == "replicate") * edge_issued + load * window)
    assert tiling.fixup_cells(spec, plan, copied) == want


def test_bfloat16_folds_the_rule_into_each_load():
    """No pass after the load; the replicate pass after every stage."""
    spec = dsl.parse(config().DSL.format(iterations=4, dtype="bfloat16",
                                         shape="40, 52"))
    plan = tiling.round_plan(spec, 2, (16, 16))
    _, edge_issued, _ = brute_force_outside(spec, 2, (16, 16))
    assert tiling.fixup_cells(spec, plan, False) == edge_issued > 0


def test_halo_index_maps_rewrite_loaded_windows_under_replicate_only():
    """A bucket spec's edge blocks fold zero and constant into each
    cell's load, and give replicate a pass over every cell of the loaded
    windows besides its pass after every stage."""
    from repro_torch.runtime.bucketing import bucket_plan

    jac = stencils.get("jacobi2d", shape=(60, 60))
    mspec = bucket_plan(with_boundary(jac, "replicate"), (64, 64)).mspec
    assert mspec.halo_index_inputs
    for kind in ("replicate", "zero", "constant"):
        spec = with_boundary(mspec, kind)
        plan = tiling.round_plan(spec, 2, (16, 16))
        _, edge_issued, edge_window = brute_force_outside(spec, 2, (16, 16))
        want = edge_issued + edge_window if kind == "replicate" else 0
        assert tiling.fixup_cells(spec, plan, False) == want
        assert want == 0 or 0 < edge_window < plan.window_cells


def test_the_cells_design_reads_as_predicted():
    """At the cell's size: the ranker picks s = 8 on 64x64 tiles (8
    rounds); a block holds three 25,600-byte windows; 52 of the 192
    blocks are edge blocks (the last row of tiles keeps 16 rows); a grid
    and launch issues 1.3182x the useful updates; the replicate rule's
    passes visit 192,512 window cells after the load and the edge
    blocks' 2,105,792 stage cells, 29.56% of the issued updates; every
    window takes the tensor copy."""
    cfg = config()
    spec = dsl.parse(cfg.DSL.format(iterations=64, dtype="float32",
                                    shape="720, 1024"))
    best = model.choose_best(spec, DEFAULT_GPU, iterations=64)[0]
    assert (best.config.s, best.config.tile_rows, best.rounds) == (8, 64, 8)
    port = lower(spec).spec
    assert port.halo_index_inputs == () and port.wrap_index_inputs == ()
    plan = tiling.round_plan(port, 8, (64, 64))
    assert plan.window == (80, 80) and plan.smem_bytes == 3 * 25600
    assert (plan.tiles, plan.edge_tiles) == (192, 52)
    assert 100 * plan.edge_tiles / plan.tiles == pytest.approx(27.0833333)
    assert plan.issued / plan.useful == pytest.approx(1.3182291667)
    assert plan.issued == 192 * 40496 and plan.window_outside == 192512
    fixup = tiling.fixup_cells(port, plan, True)
    assert fixup == 192512 + 52 * 40496 == 2298304
    assert 100 * fixup / plan.issued == pytest.approx(29.559298)
    assert plan.tma and tiling.tma_windows(port, plan) == plan.windows == 384


def read(rec):
    path = ROOT / "stencilbench" / "metrics" / f"{METRIC}.py"
    return harness.load_module(path, f"hotspot_metric_{METRIC}").read(rec)


def records():
    work = yardstick.solve_work(15, 12, (720, 1024), 64, 64).times(10)
    t = tracing.Trace(2.0, 1.9, [("sasa_tile_kernel", 0.0, 1.9)], [], [])
    return harness.Records({"dispatch": [1e-3] * 10}, 10, 2.0, work,
                           {"s": 8, "tile": [64, 64],
                            "path": "tile_pipeline"}, t)


@pytest.fixture
def counters(monkeypatch):
    """Sets ``.fixup_cells`` and ``.updates_issued`` by hand."""
    def put(fixup, issued):
        monkeypatch.setattr(launch_tile_kernel, "fixup_cells", fixup)
        monkeypatch.setattr(launch_tile_kernel, "updates_issued", issued)
    return put


def test_the_reader_gives_the_share(counters):
    counters(64 * 2298304, 64 * 7775232)
    assert read(records()) == pytest.approx(29.559298)
    counters(0, 400)
    assert read(records()) == 0.0


def test_no_counters_read_nothing(counters, monkeypatch):
    counters(0, 0)
    assert read(records()) is None
    counters(3, 5)
    assert read(records()) is not None
    # as the parent commit's port: updates counted, rewritten cells not
    monkeypatch.delattr(launch_tile_kernel, "fixup_cells")
    assert read(records()) is None


def test_a_traced_cpu_run_of_the_cell(tiny_root, monkeypatch, counters):
    """Correct on the plain versions, the kernel metrics read from the
    trace; no kernel launched, so the counter's reader finds nothing."""
    monkeypatch.setattr(tracing, "reduce_profile", lambda prof: tracing.Trace(
        1.0, 0.5, [("sasa_tile_kernel", 0.0, 0.5)], [], []))
    counters(0, 0)
    cell = harness.Bench(tiny_root).cell(CELL)
    assert cell.mix.grids == cell.mix.iterations == 64
    r = harness.run_cell(cell, 2**31 + 53, 0.2, True, torch.device("cpu"),
                         time.perf_counter())
    assert r["correct"], r["checks"]
    assert "sasa_tile_kernel_roofline" in r["metrics"]
    assert read(records()) is None


def test_the_configuration_and_cell_in_the_benchmark():
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = {c["name"]: c for c in doc["configs"]}["hotspot-720x1024"]
    assert cfg["file"] == "stencilbench/configs/hotspot-720x1024.py"
    assert cfg["reduced"] == [] and cfg["source"] == config().SOURCE
    cell = {w["name"]: w for w in doc["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "hotspot-720x1024", "ens64.it64", 1)
    listed = {m["name"] for m in doc["per_layer"]
              if CELL in m.get("workloads", [CELL])}
    assert {"sasa_tile_kernel_roofline", "redundant_update_ratio",
            "edge_block_pct", "tma_window_pct", "smem_loads_per_update",
            "launches_per_solve", "device_idle_pct"} <= listed
    assert not {"wrapped_load_pct", "local_redundant_ratio",
                "halo_overfetch_pct"} & listed
