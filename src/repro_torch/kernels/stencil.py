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
trapezoid's redundant updates grow with ``h / T`` per axis.

:func:`stencil_cuda` launches the kernel for a CUDA tensor and counts the
launch on ``stencil_cuda.launches``; for a CPU tensor it runs the plain
version :func:`stencil_torch_tiled` (counted on
``stencil_cuda.plain_calls``), which walks the same tiles with the
same per-axis boundary rule through :mod:`repro_torch.kernels.blockops`
and updates whole windows.
"""
from __future__ import annotations

import functools
import math
from typing import Mapping, NamedTuple, Sequence

import torch

from repro_torch.core.platform import DEFAULT_GPU
from repro_torch.core.spec import StencilSpec
from repro_torch.kernels import cuda_build
from repro_torch.kernels.blockops import (
    _fold_index,
    fused_iterations_on_block,
    torch_dtype,
)

# Interior tile per number of axes; the row extent can be overridden.
DEFAULT_TILES = {1: (256,), 2: (32, 64), 3: (8, 8, 32)}


def default_tile(ndim: int, tile_rows: int = 0) -> tuple[int, ...]:
    tile = DEFAULT_TILES[ndim]
    return ((tile_rows,) + tile[1:]) if tile_rows else tile


def stage_tails(spec: StencilSpec) -> list[int]:
    """Per stage, the summed radii of the stages after it in one
    iteration: how far past the next stage's region it must reach."""
    radii = [st.radius for st in spec.stages]
    return [sum(radii[k + 1:]) for k in range(len(radii))]


def frame_width(spec: StencilSpec) -> int:
    """Zero frame around every window in shared memory: the largest stage
    radius for a spec with streamed halo maps (whose blocks past the real
    region update whole windows), else 0 (every tap stays inside)."""
    if not spec.halo_index_inputs:
        return 0
    return max(st.radius for st in spec.stages)


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


@functools.lru_cache(maxsize=256)
def _launch_plan(
    spec: StencilSpec, s: int, tile: tuple[int, ...] | None
) -> tuple[list[int], int]:
    """The launch geometry after the batch (grid, tile, halo, s, shared
    memory bytes) and the tile count; raises for what the kernel cannot
    run.  Cached: the same spec, depth and tile launch every round."""
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
    return geom, g["tiles"]


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
    by the round loop between rounds and not passed."""
    geom, _ = _launch_plan(spec, s, None if tile is None else tuple(tile))
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
    out = torch.empty(want, dtype=dtype, device=device)
    geom = [B] + geom
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.launch(
            [by_name[n].data_ptr() for n in cuda_build.float_inputs(spec)],
            [by_name[n].data_ptr() for n in spec.halo_index_inputs],
            out.data_ptr(), geom, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"{spec.name}: tile kernel launch failed with cudaError {rc}"
        )
    return out


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
