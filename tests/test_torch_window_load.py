"""The tile kernel's window load, on the CPU: the round plan's shared
memory laid out for the tensor copy (rows at a pitch of whole 16-byte
units, every window on a 128-byte boundary), the windows a launch loads by
one tensor copy each, and the ranker's picks at the benchmark's cells,
which that layout leaves where they were.  The copy itself runs on the
card only (``tests/test_torch_gpu.py``)."""
from __future__ import annotations

import dataclasses
import math

import pytest

from repro_torch.configs import stencils
from repro_torch.core import dsl, model
from repro_torch.core.ir import lower
from repro_torch.core.platform import DEFAULT_GPU
from repro_torch.core.spec import Boundary
from repro_torch.kernels import tiling
from repro_torch.runtime.bucketing import bucket_plan

# The benchmark's picks: (name, s, tile), the bytes of a block's windows
# and the blocks an SM holds.
LAYOUTS = [
    ("jacobi2d", 8, (64, 64), 51_200, 4),
    ("jacobi2d", 1, (128, 64), 70_912, 3),
    ("heat3d", 2, (16, 8, 32), 69_120, 3),
    ("heat3d", 1, (16, 8, 32), 51_968, 4),
    ("blur_jacobi2d", 2, (64, 64), 69_504, 3),
]


@pytest.mark.parametrize("name, s, tile, window_bytes, resident", LAYOUTS,
                         ids=[f"{c[0]}-s{c[1]}" for c in LAYOUTS])
def test_rows_and_windows_are_laid_out_for_the_copy(name, s, tile,
                                                    window_bytes, resident):
    plan = tiling.round_plan(stencils.get(name), s, tile)
    assert plan.frame == 0
    assert plan.pitch % 4 == 0 and 0 <= plan.pitch - plan.window[-1] < 4
    assert plan.framed_cells * 4 % tiling.SMEM_ALIGN == 0
    rows = math.prod(plan.window[:-1]) * plan.pitch
    assert 0 <= plan.framed_cells - rows < tiling.SMEM_ALIGN // 4
    assert plan.smem_bytes == plan.n_buffers * plan.framed_cells * 4
    assert plan.smem_bytes == window_bytes
    assert plan.tma and model.resident_blocks(plan.smem_bytes,
                                              DEFAULT_GPU) == resident


def with_boundary(spec, kind):
    return dataclasses.replace(spec, boundary=Boundary(
        kind, 1.5 if kind == "constant" else 0.0))


def as_bf16(spec):
    return dataclasses.replace(
        spec, inputs={n: ("bfloat16", sh) for n, (_, sh) in spec.inputs.items()},
        stages=tuple(dataclasses.replace(st, dtype="bfloat16")
                     for st in spec.stages))


# (name, shape, s, tile): tiles inside the grid and edge tiles; HOTSPOT
# stages two floating inputs
RULE_CASES = [
    ("jacobi2d", (256, 192), 1, (64, 64)),
    ("heat3d", (40, 40, 96), 1, (8, 8, 32)),
    ("hotspot", (96, 128), 2, (32, 32)),
]


@pytest.mark.parametrize("kind", ["zero", "constant", "replicate", "periodic"])
@pytest.mark.parametrize("name, shape, s, tile", RULE_CASES,
                         ids=[c[0] for c in RULE_CASES])
def test_every_tile_takes_the_copy_but_a_periodic_edge_tile(kind, name,
                                                            shape, s, tile):
    spec = with_boundary(stencils.get(name, shape=shape), kind)
    plan = tiling.round_plan(spec, s, tile)
    floats = len(tiling.float_inputs(spec))
    inside = plan.tiles - plan.edge_tiles
    assert plan.tma and 0 < inside < plan.tiles
    assert plan.windows == floats * plan.tiles
    want = floats * (inside if kind == "periodic" else plan.tiles)
    assert tiling.tma_windows(spec, plan) == want
    # the plan itself does not depend on the rule
    zero = tiling.round_plan(with_boundary(spec, "zero"), s, tile)
    assert plan._replace(wrapped=0) == zero


LINE5 = """kernel: LINE5
iteration: 4
input float: in_1(300)
output float: out_1(0) = (in_1(-2) + in_1(-1) + in_1(0) + in_1(1) + in_1(2)) / 5
"""


def _halo_spec():
    jac = stencils.get("jacobi2d", shape=(60, 60))
    return bucket_plan(with_boundary(jac, "replicate"), (64, 64)).mspec


@pytest.mark.parametrize("case, spec, s, tile", [
    ("rows-not-16-byte", stencils.get("jacobi2d", shape=(256, 190)), 1,
     (64, 64)),
    ("rows-not-16-byte-3d", stencils.get("heat3d", shape=(40, 24, 30)), 2,
     (16, 8, 32)),
    ("bfloat16", as_bf16(stencils.get("jacobi2d", shape=(256, 192))), 1,
     (64, 64)),
    ("halo-maps", _halo_spec(), 2, (32, 32)),
    ("1d-256-cell-tile", lower(dsl.parse(LINE5)).spec, 1, (256,)),
    ("tiles-not-16-byte", stencils.get("jacobi2d", shape=(256, 192)), 1,
     (64, 30)),
], ids=lambda v: v if isinstance(v, str) else "")
def test_no_window_takes_the_copy_where_it_cannot(case, spec, s, tile):
    plan = tiling.round_plan(spec, s, tile)
    assert not plan.tma and tiling.tma_windows(spec, plan) == 0
    assert plan.windows > 0


POINTWISE = """kernel: SCALE
iteration: 2
input float: in_1(64, 64)
output float: out_1(0,0) = in_1(0,0) * 0.5
"""


@pytest.mark.parametrize("text, tile", [(LINE5, (64,)), (POINTWISE, (32, 64))],
                         ids=["1d", "radius-0"])
def test_no_window_takes_the_copy_without_a_dead_row(text, tile):
    """The copy's mbarrier sits in the first row of the window iterations
    write, which no stage touches in 2-D and 3-D with a halo: a 1-D
    window (its one row is live) and a radius-0 spec take no copy, though
    their rows are whole 16-byte units."""
    spec = lower(dsl.parse(text)).spec
    plan = tiling.round_plan(spec, 1, tile)
    assert spec.shape[-1] % 4 == 0 and plan.pitch % 4 == 0
    assert not plan.tma and tiling.tma_windows(spec, plan) == 0


# The benchmark's cells: configuration, iterations of the mix, and the
# ranker's first pick (s, tile_rows, buffer_depth).
PICKS = [
    ("jacobi2d.ens8.it64", "jacobi2d", 64, (8, 64, 2)),
    ("jacobi2d.ens32.it1", "jacobi2d", 1, (1, 128, 2)),
    ("heat3d.ens8.it64", "heat3d", 64, (2, 16, 2)),
    ("heat3d.ens8.it16", "heat3d", 16, (2, 16, 2)),
    ("heat3d.ens32.it1", "heat3d", 1, (1, 16, 2)),
    ("blur_jacobi2d.ens8.it64", "blur_jacobi2d", 64, (2, 64, 2)),
    ("heat3d_periodic.ens8.it64", "heat3d_periodic", 64, (2, 16, 2)),
]


@pytest.mark.parametrize("cell, name, iterations, pick", PICKS,
                         ids=[c[0] for c in PICKS])
def test_the_rankers_first_pick_at_each_cell(cell, name, iterations, pick):
    best = model.choose_best(stencils.get(name), DEFAULT_GPU,
                             iterations=iterations)[0].config
    assert (best.s, best.tile_rows, best.buffer_depth) == pick
