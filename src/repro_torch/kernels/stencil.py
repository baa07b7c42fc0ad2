"""K1: the single-PE fused-stencil kernel on Hopper, with its plain version.

Replaces ``src/repro/kernels/stencil.py::stencil_pallas`` (one round of
``s`` fused iterations over one grid).  The TPU design DMA'd a
``(tile_rows + 2sr) x C_pad`` row block into VMEM per grid step, keeping
every column resident.  On Hopper a block has at most 227 KB of shared
memory, so the CUDA kernel (``csrc/stencil_tile.cuh``) tiles every axis:
each thread block owns an interior tile plus an ``h = s * r`` halo on every
side, loads each input window once with the boundary rule folded into the
index arithmetic, runs the ``s`` iterations in shared memory and writes
the interior.

What bounds it on this card: HBM bytes.  A round reads every input window
and writes the grid once; for the stock 2-D sizes at ``s = 1`` and a 32x32
tile that is ``(n_inputs * 1.13 + 1) * R * C * 4`` bytes (a 9720x1024 f32
grid is 40 MB, a 4096x4096 one 64 MB).  Fusing ``s`` iterations divides
the rounds, hence the traffic, by ``s`` while the halo grows the window by
``(1 + 2h/T)`` per axis; the ranker (:mod:`repro_torch.core.model`) weighs
the two.

:func:`stencil_cuda` launches the kernel for a CUDA tensor and counts the
launch on ``stencil_cuda.launches``; for a CPU tensor it runs the plain
version :func:`stencil_torch_tiled`, which walks the same tiles with the
same per-axis boundary rule through :mod:`repro_torch.kernels.blockops`.
"""
from __future__ import annotations

import math
from typing import Mapping, Sequence

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
DEFAULT_TILES = {1: (256,), 2: (32, 32), 3: (8, 8, 32)}


def default_tile(ndim: int, tile_rows: int = 0) -> tuple[int, ...]:
    tile = DEFAULT_TILES[ndim]
    return ((tile_rows,) + tile[1:]) if tile_rows else tile


def plan_blocks(
    spec: StencilSpec, s: int, tile: Sequence[int] | None = None
) -> dict:
    """Static geometry of one round: tile, halo, window, tile counts."""
    r = spec.radius
    h = s * r
    grid = tuple(spec.shape)
    tile = tuple(
        min(int(t), n) for t, n in zip(tile or default_tile(spec.ndim), grid)
    )
    n_tiles = tuple(math.ceil(n / t) for n, t in zip(grid, tile))
    window = tuple(t + 2 * h for t in tile)
    return dict(
        r=r, h=h, grid_shape=grid, tile=tile, n_tiles=n_tiles,
        window=window, tiles=math.prod(n_tiles),
        window_cells=math.prod(window),
        n_buffers=spec.num_inputs + len(spec.local_stages) + 1,
    )


def smem_bytes_estimate(
    spec: StencilSpec, s: int, tile: Sequence[int] | None = None
) -> int:
    """Dynamic shared memory of one thread block: one float window per
    input, per local stage and for the next iterate."""
    g = plan_blocks(spec, s, tile)
    return g["n_buffers"] * g["window_cells"] * 4


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


def launch_tile_kernel(
    spec: StencilSpec,
    batched: Sequence[torch.Tensor],
    s: int,
    tile: Sequence[int] | None = None,
) -> torch.Tensor:
    """Launch the tile kernel once over ``(B,) + spec.shape`` inputs (in
    ``spec.inputs`` order) on the current stream; returns the output."""
    cuda_build.check_supported(spec)
    g = plan_blocks(spec, s, tile)
    smem = smem_bytes_estimate(spec, s, tile)
    if smem > DEFAULT_GPU.smem_per_block:
        raise ValueError(
            f"{spec.name}: s={s} tile={g['tile']} needs {smem} bytes of "
            f"shared memory, over the {DEFAULT_GPU.smem_per_block} a block "
            "may use; lower the fusion depth"
        )
    dtype = torch_dtype(spec.dtype)
    B = batched[0].shape[0]
    want = (B,) + tuple(spec.shape)
    for n, a in zip(spec.inputs, batched):
        if a.device.type != "cuda" or a.dtype != dtype or tuple(a.shape) != want:
            raise ValueError(
                f"input {n!r}: the kernel takes a CUDA {dtype} tensor shaped "
                f"{want}, got {a.device} {a.dtype} {tuple(a.shape)}"
            )
        if not a.is_contiguous():
            raise ValueError(f"input {n!r} is not contiguous")
    if not 1 <= B <= 65535 or g["tiles"] >= 2**31:
        raise ValueError(f"batch {B} or tile count {g['tiles']} out of range")
    lib = cuda_build.get_kernel(spec)
    device = batched[0].device
    out = torch.empty(want, dtype=dtype, device=device)
    pad = 3 - spec.ndim
    geom = (
        [B]
        + [1] * pad + list(g["grid_shape"])
        + [1] * pad + list(g["tile"])
        + [0] * pad + [g["h"]] * spec.ndim
        + [s, smem]
    )
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.launch(
            [a.data_ptr() for a in batched], out.data_ptr(), geom, stream
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
        return stencil_torch_tiled(spec, arrays, s, tile)
    out = launch_tile_kernel(
        spec, [arrays[n][None] for n in spec.inputs], s, tile
    )
    stencil_cuda.launches += 1
    return out[0]


stencil_cuda.launches = 0
