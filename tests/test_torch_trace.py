"""The port's spans (``repro_torch.trace``) and the tile kernel's update
counters.

With no profiler a span is one shared no-op and nothing accumulates.
Under ``torch.profiler`` a CPU solve of the batched runner exports its
``sasa.*`` spans, nested, and :func:`trace.totals` counts the same.  The
counters ``launch_tile_kernel.updates_issued`` / ``.updates_useful`` equal
the trapezoid's closed form, and ``.edge_blocks`` / ``.blocks`` a count
over the tiles; a launch adds its batch times each of these and of the
plan's local-stage and window counts.  The ``gpu`` test
holds the spans against the CUDA runtime's launch events on the card::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_trace.py
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import types

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.configs import stencils
from repro_torch.core.model import ParallelismConfig
from repro_torch.core.spec import Boundary
from repro_torch.kernels import stencil, tiling
from repro_torch.runtime.batching import build_batched_runner

K2 = ParallelismConfig("temporal", s=2, buffer_depth=2)


def solve_once(runner, shape, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    arrays = {n: rng.random((batch,) + shape, dtype=np.float32)
              for n in runner.spec.inputs}
    return runner.dispatch(runner.stage(arrays))


def profiled_events(tmp_path, fn, activities):
    with torch.profiler.profile(activities=activities) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def spans(events, name):
    return [e for e in events if e.get("ph") == "X" and e["name"] == name
            and e.get("cat") == "user_annotation"]


def inside(e, outer, eps=1e-3):
    return (outer["ts"] - eps <= e["ts"]
            and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"] + eps)


def test_no_profiler_no_span_and_nothing_accumulates():
    assert trace.span("sasa.round") is trace.span("sasa.dispatch", 3)
    trace.reset()
    spec = stencils.jacobi2d((40, 36), iterations=5)
    runner = build_batched_runner(spec, K2, iterations=5, device="cpu")
    solve_once(runner, (40, 36))
    assert trace.totals() == {}


def test_a_profiled_cpu_solve_exports_nested_spans(tmp_path):
    spec = stencils.jacobi2d((40, 36), iterations=5)
    runner = build_batched_runner(spec, K2, iterations=5, device="cpu")
    assert runner.path == "tile_pipeline"
    trace.reset()
    events = profiled_events(tmp_path, lambda: solve_once(runner, (40, 36)),
                             [torch.profiler.ProfilerActivity.CPU])
    (stage,) = spans(events, "sasa.stage")
    (dispatch,) = spans(events, "sasa.dispatch")
    rounds = spans(events, "sasa.round")
    assert len(rounds) == 3            # 2 + 2 + 1 fused iterations
    assert all(inside(r, dispatch) for r in rounds)
    assert not inside(stage, dispatch)
    assert spans(events, "sasa.launch.alloc") == []   # the plain version
    got = trace.totals()
    assert {n: c for n, (c, _) in got.items()} == {
        "sasa.stage": 1, "sasa.dispatch": 1, "sasa.round": 3}
    assert got["sasa.round"][1] <= got["sasa.dispatch"][1]
    assert trace.span("sasa.round") is trace.span("sasa.stage")
    trace.reset()
    assert trace.totals() == {}


def closed_form(spec, s, tile):
    """Issued and useful updates of one grid, from the trapezoid alone."""
    tiles = math.prod(math.ceil(n / t) for n, t in zip(spec.shape, tile))
    issued = tiles * sum(math.prod(r.extent)
                         for r in tiling.stage_regions(spec, s, tile))
    return issued, math.prod(spec.shape) * s * len(spec.stages)


@pytest.mark.parametrize("name, shape, s, tile, ratio", [
    # sum over e = 0..7 of (64 + 2e)^2 over 8 * 64^2, 9728 rows of 9720
    ("jacobi2d", (9720, 1024), 8, (64, 64),
     sum((64 + 2 * e) ** 2 for e in range(8)) / (8 * 64**2) * 9728 / 9720),
    # (18 * 10 * 34 + 16 * 8 * 32) over 2 * 16 * 8 * 32, the same rows
    ("heat3d", (9720, 32, 32), 2, (16, 8, 32),
     (18 * 10 * 34 + 4096) / (2 * 4096) * 9728 / 9720),
    ("jacobi2d", (9720, 1024), 1, (128, 64), 9728 / 9720),
    ("heat3d", (9720, 32, 32), 1, (16, 8, 32), 9728 / 9720),
    ("jacobi2d", (256, 192), 1, (64, 64), 1.0),
])
def test_update_counts_are_the_trapezoids(name, shape, s, tile, ratio):
    spec = stencils.get(name, shape=shape)
    plan = tiling.round_plan(spec, s, tile)
    assert (plan.issued, plan.useful) == closed_form(spec, s, tile)
    assert plan.issued / plan.useful == pytest.approx(ratio, rel=1e-12)


def brute_force_tiles(spec, s, tile):
    """Tiles of one grid, and those whose window (the tile and h = s * r
    cells on every side) leaves the grid on some axis, tile by tile."""
    h = s * spec.radius
    tiles = edge = 0
    for tc in itertools.product(*(range(math.ceil(n / t))
                                  for n, t in zip(spec.shape, tile))):
        tiles += 1
        edge += any(i * t - h < 0 or (i + 1) * t + h > n
                    for i, t, n in zip(tc, tile, spec.shape))
    return tiles, edge


@pytest.mark.parametrize("name, shape, s, tile, tiles, edge", [
    # the benchmark's cells: the 3-D tile spans the 32-cell row, so every
    # window overhangs x = 0 and x = 31
    ("heat3d", (9720, 32, 32), 2, (16, 8, 32), 2432, 2432),
    ("heat3d", (9720, 32, 32), 1, (16, 8, 32), 2432, 2432),
    ("jacobi2d", (9720, 1024), 8, (64, 64), 2432, 332),
    ("jacobi2d", (9720, 1024), 1, (128, 64), 1216, 180),
    ("jacobi2d", (256, 192), 1, (64, 64), 12, 10),
    ("heat3d", (40, 40, 64), 1, (8, 8, 32), 50, 50),
    ("heat3d", (40, 40, 96), 1, (8, 8, 32), 75, 66),
])
def test_edge_tiles_are_counted_tile_by_tile(name, shape, s, tile, tiles,
                                             edge):
    spec = stencils.get(name, shape=shape)
    plan = tiling.round_plan(spec, s, tile)
    assert (plan.tiles, plan.edge_tiles) == (tiles, edge)
    assert brute_force_tiles(spec, s, tile) == (tiles, edge)


class _StubLib:
    def launch(self, ins, maps, out, geom, stream):
        self.geom = tuple(geom)
        return 0


class _OnCard:
    """A CPU tensor that says it lies on the card, ``offset`` bytes past
    its storage."""

    device = torch.device("cuda")

    def __init__(self, t, offset=0):
        self.t, self.offset = t, offset
        self.dtype, self.shape = t.dtype, t.shape

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return self.t.data_ptr() + self.offset


@pytest.fixture
def stub_launch(monkeypatch):
    """``launch_tile_kernel`` without a card: the library and the CUDA
    calls stubbed, and every counter of the launch put back as it was
    after the test.  Gives the stub library, which keeps the last geom."""
    for n in (*stencil.COUNTERS, *tiling.LAUNCH_COUNTS):
        monkeypatch.setattr(stencil.launch_tile_kernel, n,
                            getattr(stencil.launch_tile_kernel, n))
    fake = types.SimpleNamespace(
        int32=torch.int32,
        empty=lambda shape, dtype, device: torch.empty(shape, dtype=dtype),
        cuda=types.SimpleNamespace(
            device=lambda d: contextlib.nullcontext(),
            current_stream=lambda d: types.SimpleNamespace(cuda_stream=0)))
    monkeypatch.setattr(stencil, "torch", fake)
    lib = _StubLib()
    monkeypatch.setattr(stencil.cuda_build, "get_kernel", lambda spec: lib)
    return lib


def _grids(batch, shape, offset=0):
    t = torch.empty((batch,) + shape[:1] + (1,) * (len(shape) - 1))
    return _OnCard(t.expand((batch,) + shape), offset)


@pytest.mark.parametrize("name, shape, s, tile, batch", [
    ("heat3d", (9720, 32, 32), 2, (16, 8, 32), 8),
    ("jacobi2d", (9720, 1024), 1, (128, 64), 32),
    ("jacobi2d", (256, 192), 1, (64, 64), 3),
    ("blur_jacobi2d", (9720, 1024), 2, (64, 64), 8),
    ("heat3d_periodic", (9720, 32, 32), 2, (16, 8, 32), 8),
    ("heat3d_periodic", (40, 24, 30), 4, (5, 8, 32), 3),
    ("hotspot", (720, 1024), 8, (64, 64), 64),
])
def test_a_launch_adds_its_batch_times_the_plan_to_the_counters(
        monkeypatch, stub_launch, name, shape, s, tile, batch):
    """Without a card: the library and the CUDA calls stubbed, two
    launches of ``batch`` grids add 2 x batch x the plan's counts."""
    spec = stencils.get(name, shape=shape)
    grids = _grids(batch, shape)
    f = stencil.launch_tile_kernel
    names = ("updates_issued", "updates_useful", "blocks", "edge_blocks",
             "local_updates_issued", "local_updates_useful", "window_cells",
             "reach_cells", "smem_tap_loads", "wrapped_cells", "windows",
             "windows_tma", "fixup_cells")
    for n in names:    # no launch of this test outlives it
        monkeypatch.setattr(f, n, 7)
    for _ in range(2):
        f(spec, [grids] * len(spec.inputs), s, tile)
    plan = tiling.round_plan(spec, s, tile)
    takes = name != "heat3d_periodic"
    assert [getattr(f, n) - 7 for n in names] == [
        2 * batch * v for v in (plan.issued, plan.useful, plan.tiles,
                                plan.edge_tiles, plan.local_issued,
                                plan.local_useful, plan.window_cells,
                                plan.reach_cells, plan.tap_loads,
                                plan.wrapped, plan.windows,
                                tiling.tma_windows(spec, plan),
                                tiling.fixup_cells(spec, plan, takes))]
    assert (plan.wrapped > 0) == (name == "heat3d_periodic")
    # every window of the zero rule's cells takes the tensor copy, none of
    # the periodic cell's (every block an edge block)
    assert stub_launch.geom == (batch,) + plan.geom + (int(takes),)


@pytest.mark.parametrize("kind", ["zero", "constant", "replicate",
                                  "periodic"])
def test_a_launch_adds_the_cells_its_rule_passes_visit(monkeypatch,
                                                       stub_launch, kind):
    """HOTSPOT's two windows at the benchmark cell's pick (B = 64, s = 8,
    64x64 on 720x1024, 52 of 192 blocks edge blocks): a launch adds B
    times the plan's fixup count to ``.fixup_cells``: the windows' cells
    outside the grid under constant and replicate (the tensor copy fills
    the zeros), and under replicate every stage region cell of the edge
    blocks."""
    spec = dataclasses.replace(
        stencils.get("hotspot", shape=(720, 1024)),
        boundary=Boundary(kind, 1.5 if kind == "constant" else 0.0))
    f = stencil.launch_tile_kernel
    monkeypatch.setattr(f, "fixup_cells", 0)
    f(spec, [_grids(64, (720, 1024))] * 2, 8, (64, 64))
    plan = tiling.round_plan(spec, 8, (64, 64))
    assert (plan.window_outside, plan.issued, plan.edge_tiles) == (
        192512, 192 * 40496, 52)
    want = {"zero": 0, "constant": 192512,
            "replicate": 192512 + 52 * 40496, "periodic": 0}[kind]
    assert f.fixup_cells == 64 * want


@pytest.mark.parametrize("name, shape, offset, takes", [
    ("heat3d", (40, 24, 32), 0, True),
    ("heat3d", (40, 24, 32), 4, False),       # off a 16-byte boundary
    ("heat3d", (40, 24, 32), 16, True),
    ("heat3d", (40, 24, 30), 0, False),       # rows of 120 bytes
    ("heat3d_periodic", (40, 24, 32), 0, False),   # edge blocks only
    ("jacobi2d", (256, 192), 8, False),
    ("jacobi2d", (256, 192), 0, True),
])
def test_a_launch_takes_the_tensor_copy_where_it_can(
        monkeypatch, stub_launch, name, shape, offset, takes):
    """The launch passes its choice as the 13th geometry entry and counts
    the windows so loaded on ``.windows_tma``."""
    spec = stencils.get(name, shape=shape)
    tile = tiling.default_tile(spec.ndim)
    f = stencil.launch_tile_kernel
    for n in ("windows", "windows_tma", "fixup_cells"):
        monkeypatch.setattr(f, n, 0)
    f(spec, [_grids(3, shape, offset)], 1, tile)
    plan = tiling.round_plan(spec, 1, tile)
    assert stub_launch.geom[-1] == int(takes)
    assert f.windows == 3 * plan.windows
    assert f.windows_tma == (3 * plan.windows if takes else 0)
    # the zero rule's row copies fill the windows' outside cells by a pass
    # the tensor copy does not need; the zero rule has no pass after a stage
    loaded = name != "heat3d_periodic" and not takes
    assert f.fixup_cells == 3 * tiling.fixup_cells(spec, plan, takes) == (
        3 * loaded * plan.window_outside)


@pytest.mark.gpu
def test_each_launch_lies_in_its_enqueue_span(tmp_path):
    """On the card: every ``sasa_tile_kernel``'s runtime launch call lies
    inside a ``sasa.launch.enqueue`` span on the profiler's clock, every
    launch span inside a round, and the counters grew by three launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tile kernel has no CPU mode")
    dev = torch.device("cuda")
    shape = (256, 192)
    spec = stencils.jacobi2d(shape, iterations=6)
    runner = build_batched_runner(spec, K2, iterations=6, device=dev)
    staged = runner.stage({
        n: np.random.default_rng(1).random((2,) + shape, dtype=np.float32)
        for n in spec.inputs})
    runner.dispatch(staged).event.synchronize()        # builds the kernel
    f = stencil.launch_tile_kernel
    before = (f.updates_issued, f.updates_useful, f.blocks, f.edge_blocks)

    def solve():
        runner.dispatch(staged).event.synchronize()

    events = profiled_events(tmp_path, solve, [
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    plan = tiling.round_plan(spec, 2, tuple(runner.tile))
    assert (f.updates_issued - before[0], f.updates_useful - before[1],
            f.blocks - before[2], f.edge_blocks - before[3]) == (
        3 * 2 * plan.issued, 3 * 2 * plan.useful, 3 * 2 * plan.tiles,
        3 * 2 * plan.edge_tiles)
    kernels = [e for e in events if e.get("cat") == "kernel"
               and e["name"].startswith("sasa_tile_kernel")]
    assert len(kernels) == 3
    ids = {e["args"]["correlation"] for e in kernels}
    calls = [e for e in events if e.get("cat") == "cuda_runtime"
             and e.get("args", {}).get("correlation") in ids]
    assert len(calls) == 3
    enqueues = spans(events, "sasa.launch.enqueue")
    rounds = spans(events, "sasa.round")
    assert len(enqueues) == 3 and len(rounds) == 3
    for c in calls:
        assert any(inside(c, e) for e in enqueues), c
    for e in enqueues + spans(events, "sasa.launch.alloc"):
        assert any(inside(e, r) for r in rounds), e
