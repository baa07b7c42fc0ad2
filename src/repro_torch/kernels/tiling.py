"""The round plan of the CUDA tile kernel: one round's geometry and counts.

A round runs ``s`` fused iterations over a grid, one thread block per
tile (:data:`DEFAULT_TILES`, clipped to the grid).  A block stages, per
floating input, a window of its tile and ``h = s * r`` cells a side;
stage ``k`` of iteration ``j`` updates the tile dilated by ``e(j, k)``
(:func:`stage_regions`, the shrinking trapezoid), in 2-D and 3-D in
strips of :data:`STRIP_CELLS` cells that load each tap column once.

:func:`round_plan` is the one source of it: the launch
(:mod:`repro_torch.kernels.stencil`) takes its geometry and counters
from the plan, the ranker (:func:`repro_torch.core.model.predict_gpu`)
its prices, and the code generator (:mod:`repro_torch.kernels.cuda_build`)
emits ``STRIP_CELLS``, :func:`frame_width` and :func:`stage_tails`.
Nothing here imports torch, so neither does the ranker.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Sequence

from repro_torch.core.spec import Expr, StencilSpec, refs_in
from repro_torch.kernels.division import division_counts

# Interior tile per number of axes; the row extent can be overridden.
DEFAULT_TILES = {1: (256,), 2: (32, 64), 3: (8, 8, 32)}
# Cells a thread computes in one strip along the outermost real axis, per
# number of axes (the 1-D kernel walks single cells): the card's best of
# 4, 6, 8 and 12 at the benchmark's deep picks (PERF.md section 5).
STRIP_CELLS = {1: 1, 2: 6, 3: 8}
# Each framed window's buffer starts on a SMEM_ALIGN-byte boundary, where
# a tensor copy may write it.
SMEM_ALIGN = 128
# The most cells a tensor copy's box spans on one axis.
TMA_BOX_MAX = 256


def default_tile(ndim: int, tile_rows: int = 0) -> tuple[int, ...]:
    tile = DEFAULT_TILES[ndim]
    return ((tile_rows,) + tile[1:]) if tile_rows else tile


def index_inputs(spec: StencilSpec) -> tuple[str, ...]:
    """The streamed int32 index maps of a bucket spec (halo, then wrap)."""
    return tuple(spec.halo_index_inputs) + tuple(spec.wrap_index_inputs)


def float_inputs(spec: StencilSpec) -> list[str]:
    """The inputs the kernel stages in shared memory, in spec order."""
    skip = set(index_inputs(spec))
    return [n for n in spec.inputs if n not in skip]


def stage_tails(spec: StencilSpec) -> list[int]:
    """Per stage, the summed radii of the stages after it in one
    iteration: how far past the next stage's region it must reach."""
    radii = [st.radius for st in spec.stages]
    return [sum(radii[k + 1:]) for k in range(len(radii))]


def tap_reach(spec: StencilSpec) -> list[tuple[int, int]]:
    """Per axis, how far one iteration's taps reach below and above a
    cell: the sum over stages of each stage's largest tap offset to that
    side (0 where no tap of the stage lies that side).  ``s`` iterations
    reach ``s`` times as far; the window's halo ``h = s * r`` covers the
    larger side of the widest axis, so a stage whose taps are one-sided or
    narrower on some axis stages cells no tap reads."""
    reach = [[0, 0] for _ in range(spec.ndim)]
    for st in spec.stages:
        offsets = [ref.offsets for ref in refs_in(st.expr)]
        for d, side in enumerate(reach):
            side[0] += max([0] + [-int(o[d]) for o in offsets])
            side[1] += max([0] + [int(o[d]) for o in offsets])
    return [(lo, hi) for lo, hi in reach]


def frame_width(spec: StencilSpec) -> int:
    """Zero frame around every window in shared memory: the largest stage
    radius for a spec with streamed halo maps (whose blocks past the real
    region update whole windows), else 0 (every tap stays inside)."""
    if not spec.halo_index_inputs:
        return 0
    return max(st.radius for st in spec.stages)


class TapColumn(NamedTuple):
    """The taps of one stage on one array at one offset on the inner axes
    (every real axis but the first): ``inner`` is the offset with the
    first axis's component 0, ``lo``/``hi`` the least and greatest offset
    on the first axis.  A strip of ``n`` cells reads ``n + hi - lo`` cells
    of it."""

    name: str
    inner: tuple[int, ...]
    lo: int
    hi: int


def tap_columns(expr: Expr) -> list[TapColumn]:
    """The distinct (array, inner offset) columns of a stage's taps, in
    the order of their first tap."""
    span: dict[tuple[str, tuple[int, ...]], list[int]] = {}
    for ref in refs_in(expr):
        offs = tuple(int(o) for o in ref.offsets)
        key = (ref.name, (0,) + offs[1:])
        lo_hi = span.setdefault(key, [offs[0], offs[0]])
        lo_hi[0] = min(lo_hi[0], offs[0])
        lo_hi[1] = max(lo_hi[1], offs[0])
    return [TapColumn(n, inner, lo, hi) for (n, inner), (lo, hi) in span.items()]


class StageRegion(NamedTuple):
    """The cells one stage of one fused iteration updates in a block: the
    tile dilated by ``dilation`` on every axis, as ``lo`` (window
    coordinate of its first cell) and ``extent`` per axis."""

    stage: int
    dilation: int
    lo: tuple[int, ...]
    extent: tuple[int, ...]


def _clip_tile(spec: StencilSpec, tile: Sequence[int] | None) -> tuple[int, ...]:
    return tuple(
        min(int(t), n) for t, n in zip(tile or default_tile(spec.ndim), spec.shape)
    )


def stage_regions(
    spec: StencilSpec, s: int, tile: Sequence[int] | None = None
) -> list[StageRegion]:
    """The shrinking trapezoid of one round, in stage order.

    Stage ``k`` of iteration ``j`` updates the tile dilated by
    ``e(j, k) = (s - 1 - j) * r + tail_k`` (:func:`stage_tails`): every
    cell a later stage still reads, and no more.  Since ``e + r_k <= h``,
    no tap of an updated cell leaves the window.  The CUDA kernel
    evaluates this closed form (``tail_k`` is emitted into its source);
    :func:`round_plan` sums the extents.
    """
    tile = _clip_tile(spec, tile)
    r = spec.radius
    h = s * r
    tails = stage_tails(spec)
    out = []
    for j in range(s):
        for k, tail in enumerate(tails):
            e = (s - 1 - j) * r + tail
            out.append(StageRegion(
                k, e, tuple(h - e for _ in tile),
                tuple(t + 2 * e for t in tile),
            ))
    return out


def tap_loads(spec: StencilSpec, regions: Sequence[StageRegion]) -> int:
    """Shared-memory loads of taps one thread block issues over
    ``regions``.  In 2-D and 3-D each region is cut into strips of
    ``STRIP_CELLS`` cells along its first axis, one strip per column
    of the other axes: a whole strip loads ``STRIP_CELLS + hi - lo``
    cells of each of the stage's tap columns (:func:`tap_columns`), and
    the shorter strip at the region's end, like every cell of a 1-D
    region, loads each distinct tap of its stage once per cell."""
    taps = [len({(ref.name, tuple(ref.offsets)) for ref in refs_in(st.expr)})
            for st in spec.stages]
    if spec.ndim not in (2, 3):     # cell by cell (the kernel takes 1-3 axes)
        return sum(taps[reg.stage] * math.prod(reg.extent) for reg in regions)
    strip = STRIP_CELLS[spec.ndim]
    # the cells a whole strip of each stage loads
    columns = [sum(strip + col.hi - col.lo for col in tap_columns(st.expr))
               for st in spec.stages]
    total = 0
    for reg in regions:
        whole, short = divmod(reg.extent[0], strip)
        total += math.prod(reg.extent[1:]) * (
            whole * columns[reg.stage] + short * taps[reg.stage])
    return total


class RoundPlan(NamedTuple):
    """One round of ``s`` fused iterations over a grid (:func:`round_plan`)."""

    tile: tuple[int, ...]       # clipped to the grid
    h: int                      # the halo, s * r
    n_tiles: tuple[int, ...]    # per axis
    window: tuple[int, ...]     # the tile and h cells a side
    frame: int                  # zero cells around a window in shared memory
    pitch: int                  # floats of a framed window's row
    framed_cells: int           # floats from one framed window to the next
    n_buffers: int              # framed windows a block holds
    smem_bytes: int             # a block's dynamic shared memory
    geom: tuple[int, ...]       # the launch's geometry after the batch
    # per grid
    issued: int                 # cell updates
    useful: int
    tiles: int
    edge_tiles: int
    local_issued: int           # cell updates of the local stages
    local_useful: int
    window_cells: int           # staged floating-input cells
    reach_cells: int
    window_outside: int         # of them outside the grid
    wrapped: int                # the same, periodic only
    windows: int                # floating-input windows staged
    tma: bool                   # a window fits one tensor copy
    tap_loads: int              # shared-memory loads of taps
    flops: int                  # float32 operations of the issued updates
    divides_reciprocal: int     # divisions of the issued updates lowered
    divides_ieee: int           # to a reciprocal, and left as C `/`


def _in_grid(n: int, t: int, nt: int, e: int) -> int:
    """The cells inside ``[0, n)`` of an axis's ``nt`` tiles of ``t``
    cells, each dilated by ``e`` cells a side, summed over the tiles: the
    full extents less what the first tiles lose below 0 and the last above
    ``n`` (every tile starts inside the grid)."""
    total = nt * (t + 2 * e)
    i = 0
    while i < nt and i * t < e:
        total -= e - i * t
        i += 1
    i = nt - 1
    while i >= 0 and (i + 1) * t + e > n:
        total -= (i + 1) * t + e - n
        i -= 1
    return total


@functools.lru_cache(maxsize=256)
def round_plan(
    spec: StencilSpec, s: int, tile: tuple[int, ...] | None = None
) -> RoundPlan:
    """The plan of one round of ``s`` fused iterations on ``tile``, cached:
    the ranker weighs, and the launch runs, the same spec, depth and tile
    many times.  It is built for any depth and tile; the launch refuses
    what the kernel cannot run (``kernels/stencil.py::_launch_plan``).

    Per grid, every thread block evaluates each stage's whole region of
    :func:`stage_regions`, in edge tiles past the grid too: the tile
    count times their summed cells are issued (a block of a spec with
    halo-index maps may widen an axis to its whole window, which this
    count does not see), and the grid's cells times ``s`` times the
    stages of an iteration are useful; the local counts are the same over
    the ``local`` stages.  Edge tiles have a window that leaves the grid
    on some axis.  Every tile stages one window per floating input, and
    the taps reach the cells of the tile widened by ``s`` times
    :func:`tap_reach`.  Of the window cells, ``window_outside`` lie
    outside the grid.  Under the periodic rule they are wrapped, each
    fetched on its own from the opposite side of the grid; under every
    other rule none is (:func:`fixup_cells` counts the passes that give
    them the rule).  A window fits one tensor
    copy (``tma``; the kernel's head comment) where the spec is 2-D or 3-D,
    float32, without halo-index maps and of radius 1 or more, the grid's
    rows and the tile (unless one tile spans the row) are a multiple of 4
    cells on x, so every window starts on x at the same offset from a
    16-byte unit, and no axis of the copy's
    box (the window, its rows at ``pitch``) spans more than
    :data:`TMA_BOX_MAX` cells (:func:`tma_windows` counts the windows so
    loaded).  Shared memory (``smem_bytes``): the framed
    windows, rows ``pitch`` floats apart (the framed row rounded up to 4
    floats where there is no frame) and each window rounded up to
    :data:`SMEM_ALIGN` bytes, then the belt bounds of halo-index maps.
    Nothing of the plan depends on the boundary rule but ``wrapped``.
    Tap loads: the tile
    count times :func:`tap_loads` of the regions.  Divisions: each issued
    update of a stage times that stage's divisions of each lowering
    (:func:`~repro_torch.kernels.division.division_counts`)."""
    grid = tuple(spec.shape)
    h = s * spec.radius
    tile = _clip_tile(spec, tile)
    n_tiles = tuple(math.ceil(n / t) for n, t in zip(grid, tile))
    tiles = math.prod(n_tiles)
    window = tuple(t + 2 * h for t in tile)
    frame = frame_width(spec)
    framed = [w + 2 * frame for w in window]
    # a tensor copy writes rows of a multiple of 16 bytes
    pitch = framed[-1] if frame else -(-framed[-1] // 4) * 4
    align = SMEM_ALIGN // 4
    framed_cells = -(-math.prod(framed[:-1]) * pitch // align) * align
    floats = len(float_inputs(spec))
    n_buffers = floats + len(spec.local_stages) + 1
    belt = 6 * 4 if spec.halo_index_inputs else 0
    smem = n_buffers * framed_cells * 4 + belt
    pad = 3 - spec.ndim
    geom = (
        (1,) * pad + grid + (1,) * pad + tile
        + (0,) * pad + (h,) * spec.ndim + (s, smem)
    )
    regions = stage_regions(spec, s, tile)
    cells = [math.prod(reg.extent) for reg in regions]
    local = [not spec.stages[reg.stage].is_output for reg in regions]
    ops = [st.ops_per_cell for st in spec.stages]
    divides = [division_counts(st.expr) for st in spec.stages]
    inside = math.prod(
        sum(1 for i in range(nt) if i * t >= h and (i + 1) * t + h <= n)
        for n, t, nt in zip(grid, tile, n_tiles)
    )
    reach = math.prod(
        t + s * (lo + hi) for t, (lo, hi) in zip(tile, tap_reach(spec))
    )
    window_outside = floats * (tiles * math.prod(window) - math.prod(
        _in_grid(n, t, nt, h) for n, t, nt in zip(grid, tile, n_tiles)))
    return RoundPlan(
        tile, h, n_tiles, window, frame, pitch, framed_cells, n_buffers, smem,
        geom,
        issued=tiles * sum(cells),
        useful=math.prod(grid) * len(regions),
        tiles=tiles,
        edge_tiles=tiles - inside,
        local_issued=tiles * sum(c for c, loc in zip(cells, local) if loc),
        local_useful=math.prod(grid) * s * len(spec.local_stages),
        window_cells=tiles * floats * math.prod(window),
        reach_cells=tiles * floats * reach,
        window_outside=window_outside,
        wrapped=window_outside if spec.boundary.kind == "periodic" else 0,
        windows=tiles * floats,
        # a 2-D or 3-D float32 spec without halo maps, with a halo (the
        # copy's mbarrier sits in a row no stage touches), whose grid rows
        # and tiles are whole 16-byte units on x and whose box fits the copy
        tma=(spec.dtype == "float32" and not spec.halo_index_inputs
             and spec.ndim >= 2 and h > 0
             and grid[-1] % 4 == 0 and (tile[-1] % 4 == 0 or n_tiles[-1] == 1)
             and max(window[:-1] + (pitch,)) <= TMA_BOX_MAX),
        tap_loads=tiles * tap_loads(spec, regions),
        flops=tiles * sum(c * ops[reg.stage] for c, reg in zip(cells, regions)),
        divides_reciprocal=tiles * sum(
            c * divides[reg.stage][0] for c, reg in zip(cells, regions)),
        divides_ieee=tiles * sum(
            c * divides[reg.stage][1] for c, reg in zip(cells, regions)),
    )


def tma_windows(spec: StencilSpec, plan: RoundPlan) -> int:
    """Floating-input windows of one grid that a launch of ``plan`` loads
    by one tensor copy each, where it takes the copy: every tile's where
    a window fits the copy, but only the tiles inside the grid under the
    periodic rule (an edge tile wraps its halo cell by cell)."""
    if not plan.tma:
        return 0
    if spec.boundary.kind == "periodic":
        return plan.windows // plan.tiles * (plan.tiles - plan.edge_tiles)
    return plan.windows


def fixup_cells(spec: StencilSpec, plan: RoundPlan, copied: bool) -> int:
    """Cells that the boundary rule's own passes visit in the edge blocks
    of one grid, in a launch of ``plan``, ``copied`` where it loads its
    windows by tensor copies (the kernel's head comment, "Boundary rule").
    Each pass visits a box of a block and ends with a barrier.  After
    every stage, the replicate rule's pass visits each cell of the stage's
    region and tests it against the grid (``sasa_replicate_fixup``);
    zero and constant store their value inside the stage loop, with no
    pass.  After the load of float32 windows without halo-index maps,
    constant and replicate visit each window cell outside the grid
    (``sasa_fill_outside``, every floating input), and zero too where the
    windows come by row copies (the tensor copy fills zeros itself).  On
    specs with halo-index maps, replicate visits each cell of every
    loaded window, and the other rules fold into each cell's load, as
    every rule does on bfloat16 specs.  None under the periodic rule,
    whose windows wrap (``wrapped``)."""
    kind = spec.boundary.kind

    def edge(per_grid: int) -> int:     # every tile counts alike
        return per_grid // plan.tiles * plan.edge_tiles

    if kind == "periodic":
        return 0
    if spec.halo_index_inputs:
        load = edge(plan.window_cells) if kind == "replicate" else 0
    elif spec.dtype == "float32" and (kind != "zero" or not copied):
        load = plan.window_outside
    else:
        load = 0
    return load + (edge(plan.issued) if kind == "replicate" else 0)


# the per-grid counts of :func:`launch_counts`
LAUNCH_COUNTS = ("windows_tma", "fixup_cells")


def launch_counts(spec: StencilSpec, plan: RoundPlan,
                  copied: bool) -> dict[str, int]:
    """The per-grid counts of a launch of ``plan`` that depend on how it
    loads its windows, ``copied`` where by tensor copies: the windows so
    loaded (:func:`tma_windows`, 0 without the copy) and the cells the
    boundary rule's passes visit (:func:`fixup_cells`), under the names
    of :data:`LAUNCH_COUNTS`."""
    return dict(zip(LAUNCH_COUNTS, (
        tma_windows(spec, plan) if copied else 0,
        fixup_cells(spec, plan, copied))))


def smem_bytes_estimate(
    spec: StencilSpec, s: int, tile: Sequence[int] | None = None
) -> int:
    """Dynamic shared memory of one thread block: one framed float window
    per floating input, per local stage and for the next iterate, each
    aligned for a tensor copy, plus the per-axis belt bounds of a spec
    with halo-index maps.  The int32 index maps themselves are read from
    global memory and never staged."""
    return round_plan(spec, s, None if tile is None else tuple(tile)).smem_bytes
