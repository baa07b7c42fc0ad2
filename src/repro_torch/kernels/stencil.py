"""K1: the single-PE fused-stencil kernel on Hopper, with its plain version.

Replaces ``src/repro/kernels/stencil.py::stencil_pallas`` (one round of
``s`` fused iterations over one grid).  The TPU design DMA'd a
``(tile_rows + 2sr) x C_pad`` row block into VMEM per grid step, keeping
every column resident.  On Hopper a block has at most 227 KB of shared
memory, so the CUDA kernel (``csrc/stencil_tile.cuh``) tiles every axis:
each thread block owns an interior tile plus an ``h = s * r`` halo on every
side, loads each input window once, runs the ``s`` iterations in shared
memory and writes the tile.  Stage ``k`` of iteration ``j`` updates only
its region, the tile dilated by ``e(j, k) = (s - 1 - j) * r + tail_k``
(:func:`stage_regions`: the shrinking trapezoid).  The ranker
(:mod:`repro_torch.core.model`) prices the same regions.

What bounds it on this card: instructions per cell update, then HBM
bytes.  A round reads every input window and writes the grid once (a
9720x1024 f32 grid is 40 MB, a 4096x4096 one 64 MB); fusing ``s``
iterations divides the rounds, hence the traffic, by ``s`` while the
trapezoid's redundant updates grow with ``h / T`` per axis.  In 2-D and
3-D a thread computes a strip of ``STRIP_CELLS`` cells along the
outermost real axis and keeps each column of a stage's taps in registers
across it, so an update issues fewer shared loads than it has taps.

:func:`stencil_cuda` launches the kernel for a CUDA tensor and counts the
launch on ``stencil_cuda.launches``; for a CPU tensor it runs the plain
version :func:`stencil_torch_tiled` (counted on
``stencil_cuda.plain_calls``), which walks the same tiles with the
same per-axis boundary rule through :mod:`repro_torch.kernels.blockops`
and updates whole windows.

A launch carries the spans ``sasa.launch.alloc`` and
``sasa.launch.enqueue`` (:mod:`repro_torch.trace`), counts its cell
updates on ``launch_tile_kernel.updates_issued`` and ``.updates_useful``,
its thread blocks on ``.blocks``, of which ``.edge_blocks`` have a
window that leaves the grid, the cell updates of its ``local`` stages on
``.local_updates_issued`` and ``.local_updates_useful``, and the cells of
its floating-input windows on ``.window_cells``, of which ``.reach_cells``
lie in the box the taps reach (:func:`tap_reach`), and the shared-memory
loads of its stages' taps on ``.smem_tap_loads`` (:func:`tap_loads`).
"""
from __future__ import annotations

import functools
import math
from typing import Mapping, NamedTuple, Sequence

import torch

from repro_torch.core.platform import DEFAULT_GPU
from repro_torch.core.spec import StencilSpec, refs_in
from repro_torch.kernels import cuda_build
from repro_torch.kernels.blockops import (
    _fold_index,
    fused_iterations_on_block,
    torch_dtype,
)
from repro_torch.trace import span

# Interior tile per number of axes; the row extent can be overridden.
DEFAULT_TILES = {1: (256,), 2: (32, 64), 3: (8, 8, 32)}
# Cells a thread computes in one strip along the outermost real axis, per
# number of axes (the 1-D kernel walks single cells): the card's best of
# 4, 6, 8 and 12 at the benchmark's deep picks (PERF.md section 5).
STRIP_CELLS = {1: 1, 2: 6, 3: 8}


def default_tile(ndim: int, tile_rows: int = 0) -> tuple[int, ...]:
    tile = DEFAULT_TILES[ndim]
    return ((tile_rows,) + tile[1:]) if tile_rows else tile


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


def tap_loads(spec: StencilSpec, regions: Sequence["StageRegion"]) -> int:
    """Shared-memory loads of taps one thread block issues over
    ``regions``.  In 2-D and 3-D each region is cut into strips of
    ``STRIP_CELLS`` cells along its first axis, one strip per column
    of the other axes: a whole strip loads ``STRIP_CELLS + hi - lo``
    cells of each of the stage's tap columns
    (:func:`cuda_build.tap_columns`), and the shorter strip at the
    region's end, like every cell of a 1-D region, loads each distinct
    tap of its stage once per cell."""
    total = 0
    for reg in regions:
        expr = spec.stages[reg.stage].expr
        taps = len({(ref.name, tuple(ref.offsets)) for ref in refs_in(expr)})
        if spec.ndim == 1:
            total += taps * reg.extent[0]
            continue
        strip = STRIP_CELLS[spec.ndim]
        whole, short = divmod(reg.extent[0], strip)
        total += math.prod(reg.extent[1:]) * (
            whole * sum(strip + col.hi - col.lo
                        for col in cuda_build.tap_columns(expr))
            + short * taps)
    return total


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
    :func:`repro_torch.core.model.predict_gpu` sums the extents.
    """
    tile = _clip_tile(spec, tile)
    h = s * spec.radius
    out = []
    for j in range(s):
        for k, tail in enumerate(stage_tails(spec)):
            e = (s - 1 - j) * spec.radius + tail
            out.append(StageRegion(
                k, e, tuple(h - e for _ in tile),
                tuple(t + 2 * e for t in tile),
            ))
    return out


def plan_blocks(
    spec: StencilSpec, s: int, tile: Sequence[int] | None = None
) -> dict:
    """Static geometry of one round: tile, halo, window, tile counts, and
    the framed window each buffer occupies in shared memory."""
    r = spec.radius
    h = s * r
    grid = tuple(spec.shape)
    tile = _clip_tile(spec, tile)
    n_tiles = tuple(math.ceil(n / t) for n, t in zip(grid, tile))
    window = tuple(t + 2 * h for t in tile)
    frame = frame_width(spec)
    framed = tuple(w + 2 * frame for w in window)
    return dict(
        r=r, h=h, grid_shape=grid, tile=tile, n_tiles=n_tiles,
        window=window, tiles=math.prod(n_tiles),
        window_cells=math.prod(window), frame=frame,
        framed_cells=math.prod(framed),
        n_buffers=(len(cuda_build.float_inputs(spec))
                   + len(spec.local_stages) + 1),
    )


def smem_bytes_estimate(
    spec: StencilSpec, s: int, tile: Sequence[int] | None = None
) -> int:
    """Dynamic shared memory of one thread block: one framed float window
    per floating input, per local stage and for the next iterate, plus the
    per-axis belt bounds of a spec with halo-index maps.  The int32 index
    maps themselves are read from global memory and never staged."""
    g = plan_blocks(spec, s, tile)
    belt = 6 * 4 if spec.halo_index_inputs else 0
    return g["n_buffers"] * g["framed_cells"] * 4 + belt


# --------------------------------------------------------------------------
# Plain version: the kernel's tile walk in torch
# --------------------------------------------------------------------------


def tiled_round(
    spec: StencilSpec,
    arrays: Mapping[str, torch.Tensor],
    s: int,
    tile: Sequence[int] | None = None,
) -> torch.Tensor:
    """One round of ``s`` fused iterations over a ``(B,)``-leading batch,
    walking the CUDA kernel's tiles (all tiles at once, as a batch axis).

    Each tile's window is gathered with the boundary rule folded into the
    index (wrap for periodic, clamp otherwise, out-of-grid cells then
    re-imposed by the block body), the fused iterations run on the stacked
    windows, and the interiors are stitched back into the grid.
    """
    g = plan_blocks(spec, s, tile)
    nd = spec.ndim
    h = g["h"]
    first = arrays[spec.iterate_input]
    dev = first.device
    B = first.shape[0]
    index = []
    origins = []
    for d, (n, t, nt, w) in enumerate(
        zip(g["grid_shape"], g["tile"], g["n_tiles"], g["window"])
    ):
        org = torch.arange(nt, device=dev) * t - h
        coord = org[:, None] + torch.arange(w, device=dev)[None, :]
        view = [1] * (2 * nd)
        view[d], view[nd + d] = nt, w
        index.append(_fold_index(coord, n, spec.boundary).view(view))
        origins.append(org)
    origin = torch.stack(
        [o.flatten() for o in torch.meshgrid(*origins, indexing="ij")], dim=1
    )
    T = g["tiles"]
    windows = {
        n: a[(slice(None),) + tuple(index)].reshape((B, T) + g["window"])
        for n, a in arrays.items()
    }
    compute = torch.float32 if spec.dtype == "bfloat16" else None
    res = fused_iterations_on_block(
        spec, windows, s, origin, g["grid_shape"], compute_dtype=compute
    )
    inner = res[(Ellipsis,) + tuple(slice(h, h + t) for t in g["tile"])]
    inner = inner.reshape((B,) + g["n_tiles"] + g["tile"])
    perm = [0] + [x for d in range(nd) for x in (1 + d, 1 + nd + d)]
    inner = inner.permute(perm).reshape(
        (B,) + tuple(nt * t for nt, t in zip(g["n_tiles"], g["tile"]))
    )
    crop = (slice(None),) + tuple(slice(0, n) for n in g["grid_shape"])
    return inner[crop].to(torch_dtype(spec.dtype)).contiguous()


def stencil_torch_tiled(
    spec: StencilSpec,
    arrays: Mapping[str, torch.Tensor],
    s: int,
    tile: Sequence[int] | None = None,
) -> torch.Tensor:
    """Plain version of :func:`stencil_cuda`: one round over one grid."""
    one = {n: torch.as_tensor(a)[None] for n, a in arrays.items()}
    return tiled_round(spec, one, s, tile)[0]


# --------------------------------------------------------------------------
# The kernel
# --------------------------------------------------------------------------


def _device_of(spec: StencilSpec, arrays: Mapping[str, torch.Tensor]):
    devs = {torch.as_tensor(arrays[n]).device for n in spec.inputs}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {sorted(map(str, devs))}")
    return devs.pop()


class LaunchPlan(NamedTuple):
    """One launch's geometry after the batch (grid, tile, halo, s, shared
    memory bytes), and per batch entry the cell updates it issues and the
    useful ones, its tiles, its edge tiles (those whose window leaves the
    grid on some axis), the issued and useful updates of its ``local``
    stages, the cells of its floating-input windows and those of them
    inside the box the taps reach, and its shared-memory tap loads."""

    geom: list[int]
    issued: int
    useful: int
    tiles: int
    edge_tiles: int
    local_issued: int
    local_useful: int
    window_cells: int
    reach_cells: int
    tap_loads: int


@functools.lru_cache(maxsize=256)
def _launch_plan(
    spec: StencilSpec, s: int, tile: tuple[int, ...] | None
) -> LaunchPlan:
    """The launch geometry and update counts of one round;
    raises for what the kernel cannot run.  Cached: the same spec, depth
    and tile launch every round.

    Issued updates: every thread block evaluates each stage's whole
    region of :func:`stage_regions`, in edge tiles past the grid too, so
    a grid issues the tile count times their summed cells (a block of a
    spec with halo-index maps may widen an axis to its whole window,
    which this count does not see).  Useful updates: the grid's cells
    times ``s`` times the stages of an iteration.

    Edge tiles: the tiles whose window (the tile and ``h`` cells on every
    side) leaves the grid on some axis, which the kernel loads and updates
    with the boundary rule; the others are its interior blocks.

    Local updates: the same two counts over the ``local`` stages alone.
    Window cells: every tile stages one window per floating input;
    reach cells: of those, the cells inside the tile widened by ``s``
    times :func:`tap_reach` on each side of each axis.  Tap loads: the
    tile count times :func:`tap_loads` of the regions."""
    cuda_build.check_supported(spec)
    g = plan_blocks(spec, s, tile)
    smem = smem_bytes_estimate(spec, s, tile)
    if smem > DEFAULT_GPU.smem_per_block:
        raise ValueError(
            f"{spec.name}: s={s} tile={g['tile']} needs {smem} bytes of "
            f"shared memory, over the {DEFAULT_GPU.smem_per_block} a block "
            "may use; lower the fusion depth"
        )
    if g["tiles"] >= 2**31:
        raise ValueError(f"tile count {g['tiles']} out of range")
    # interior blocks address a window's cells in 32 bits from its first
    if g["window"][0] * math.prod(g["grid_shape"][1:]) >= 2**31:
        raise ValueError(f"{spec.name}: a window spans 2**31 grid cells")
    pad = 3 - spec.ndim
    geom = (
        [1] * pad + list(g["grid_shape"])
        + [1] * pad + list(g["tile"])
        + [0] * pad + [g["h"]] * spec.ndim
        + [s, smem]
    )
    regions = stage_regions(spec, s, tile)
    issued = g["tiles"] * sum(math.prod(r.extent) for r in regions)
    useful = math.prod(g["grid_shape"]) * len(regions)
    h = g["h"]
    inside = math.prod(
        sum(1 for i in range(nt) if i * t >= h and (i + 1) * t + h <= n)
        for n, t, nt in zip(g["grid_shape"], g["tile"], g["n_tiles"])
    )
    local = [r for r in regions if not spec.stages[r.stage].is_output]
    windows = g["tiles"] * len(cuda_build.float_inputs(spec))
    reach = math.prod(
        t + s * (lo + hi) for t, (lo, hi) in zip(g["tile"], tap_reach(spec))
    )
    return LaunchPlan(
        geom, issued, useful, g["tiles"], g["tiles"] - inside,
        g["tiles"] * sum(math.prod(r.extent) for r in local),
        math.prod(g["grid_shape"]) * s * len(spec.local_stages),
        windows * g["window_cells"], windows * reach,
        g["tiles"] * tap_loads(spec, regions),
    )


def launch_tile_kernel(
    spec: StencilSpec,
    batched: Sequence[torch.Tensor],
    s: int,
    tile: Sequence[int] | None = None,
) -> torch.Tensor:
    """Launch the tile kernel once over ``(B,) + spec.shape`` inputs (in
    ``spec.inputs`` order) on the current stream; returns the output.

    Floating inputs are passed as the kernel's windows, halo-index maps
    (int32) through their own pointer array; wrap-index maps are consumed
    by the round loop between rounds and not passed.

    Each launch adds its issued and useful cell updates
    (:class:`LaunchPlan`) to ``launch_tile_kernel.updates_issued`` and
    ``.updates_useful``, its blocks and edge blocks to ``.blocks`` and
    ``.edge_blocks``, its local stages' issued and useful updates to
    ``.local_updates_issued`` and ``.local_updates_useful``, and its
    staged window cells and those the taps reach to ``.window_cells`` and
    ``.reach_cells``, and its stages' shared-memory tap loads to
    ``.smem_tap_loads``."""
    plan = _launch_plan(spec, s, None if tile is None else tuple(tile))
    dtype = torch_dtype(spec.dtype)
    B = batched[0].shape[0]
    want = (B,) + tuple(spec.shape)
    index = set(cuda_build.index_inputs(spec))
    by_name = dict(zip(spec.inputs, batched))
    for n, a in by_name.items():
        dt = torch.int32 if n in index else dtype
        if a.device.type != "cuda" or a.dtype != dt or tuple(a.shape) != want:
            raise ValueError(
                f"input {n!r}: the kernel takes a CUDA {dt} tensor shaped "
                f"{want}, got {a.device} {a.dtype} {tuple(a.shape)}"
            )
        if not a.is_contiguous():
            raise ValueError(f"input {n!r} is not contiguous")
    if not 1 <= B <= 65535:
        raise ValueError(f"batch {B} out of range")
    lib = cuda_build.get_kernel(spec)
    device = batched[0].device
    with span("sasa.launch.alloc"):
        out = torch.empty(want, dtype=dtype, device=device)
    geom = [B] + plan.geom
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        with span("sasa.launch.enqueue"):
            rc = lib.launch(
                [by_name[n].data_ptr() for n in cuda_build.float_inputs(spec)],
                [by_name[n].data_ptr() for n in spec.halo_index_inputs],
                out.data_ptr(), geom, stream,
            )
    if rc != 0:
        raise RuntimeError(
            f"{spec.name}: tile kernel launch failed with cudaError {rc}"
        )
    launch_tile_kernel.updates_issued += B * plan.issued
    launch_tile_kernel.updates_useful += B * plan.useful
    launch_tile_kernel.blocks += B * plan.tiles
    launch_tile_kernel.edge_blocks += B * plan.edge_tiles
    launch_tile_kernel.local_updates_issued += B * plan.local_issued
    launch_tile_kernel.local_updates_useful += B * plan.local_useful
    launch_tile_kernel.window_cells += B * plan.window_cells
    launch_tile_kernel.reach_cells += B * plan.reach_cells
    launch_tile_kernel.smem_tap_loads += B * plan.tap_loads
    return out


launch_tile_kernel.updates_issued = 0
launch_tile_kernel.updates_useful = 0
launch_tile_kernel.blocks = 0
launch_tile_kernel.edge_blocks = 0
launch_tile_kernel.local_updates_issued = 0
launch_tile_kernel.local_updates_useful = 0
launch_tile_kernel.window_cells = 0
launch_tile_kernel.reach_cells = 0
launch_tile_kernel.smem_tap_loads = 0


def stencil_cuda(
    spec: StencilSpec,
    arrays: Mapping[str, torch.Tensor],
    s: int,
    tile: Sequence[int] | None = None,
) -> torch.Tensor:
    """One round of ``s`` fused iterations over one grid.

    A CUDA tensor goes through the tile kernel (counted on
    ``stencil_cuda.launches``); a CPU tensor through the plain version.
    """
    device = _device_of(spec, arrays)
    if device.type == "cpu":
        stencil_cuda.plain_calls += 1
        return stencil_torch_tiled(spec, arrays, s, tile)
    out = launch_tile_kernel(
        spec, [arrays[n][None] for n in spec.inputs], s, tile
    )
    stencil_cuda.launches += 1
    return out[0]


stencil_cuda.launches = 0
stencil_cuda.plain_calls = 0
