"""K1: the single-PE fused-stencil kernel on Hopper, with its plain version.

Replaces ``src/repro/kernels/stencil.py::stencil_pallas`` (one round of
``s`` fused iterations over one grid).  The TPU design DMA'd a
``(tile_rows + 2sr) x C_pad`` row block into VMEM per grid step, keeping
every column resident.  On Hopper a block has at most 227 KB of shared
memory, so the CUDA kernel (``csrc/stencil_tile.cuh``) tiles every axis:
each thread block loads its tile's window once, runs the ``s`` iterations
over the shrinking trapezoid in shared memory and writes the tile, as
:func:`repro_torch.kernels.tiling.round_plan` lays out.

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

A launch carries the spans ``sasa.launch.alloc`` and
``sasa.launch.enqueue`` (:mod:`repro_torch.trace`) and adds ``B`` times
a per-grid count of its round plan to each counter of :data:`COUNTERS`,
attributes of :func:`launch_tile_kernel`: the cell updates issued and the
useful ones (``.updates_issued``, ``.updates_useful``), the thread blocks
and those whose window leaves the grid (``.blocks``, ``.edge_blocks``),
the same two update counts over the ``local`` stages
(``.local_updates_issued``, ``.local_updates_useful``), the cells of the
floating-input windows and those the taps reach (``.window_cells``,
``.reach_cells``), the window cells wrapped round the grid under the
periodic rule (``.wrapped_cells``), the shared-memory tap loads
(``.smem_tap_loads``), the divisions lowered to a reciprocal and
those left as C ``/`` (``.divides_reciprocal``, ``.divides_ieee``;
:mod:`repro_torch.kernels.division`), and the floating-input windows
(``.windows``).  Beside the table, the counts that depend on how the
launch loads its windows (:func:`~repro_torch.kernels.tiling.launch_counts`):
``.windows_tma``, the windows loaded by one tensor copy each (0 in a
launch that does not take the copy), and ``.fixup_cells``, the cells the
boundary rule's passes visit in edge blocks after the load and after
every stage (0 under the periodic rule).
"""
from __future__ import annotations

import functools
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
from repro_torch.kernels.tiling import (
    LAUNCH_COUNTS,
    RoundPlan,
    float_inputs,
    index_inputs,
    launch_counts,
    round_plan,
    tap_reach,  # noqa: F401  (stencilbench's tests read it here)
    tma_windows,
)
from repro_torch.trace import span


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
    plan = round_plan(spec, s, None if tile is None else tuple(tile))
    grid = tuple(spec.shape)
    nd = spec.ndim
    h = plan.h
    first = arrays[spec.iterate_input]
    dev = first.device
    B = first.shape[0]
    index = []
    origins = []
    for d, (n, t, nt, w) in enumerate(
        zip(grid, plan.tile, plan.n_tiles, plan.window)
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
    windows = {
        n: a[(slice(None),) + tuple(index)].reshape((B, plan.tiles) + plan.window)
        for n, a in arrays.items()
    }
    compute = torch.float32 if spec.dtype == "bfloat16" else None
    res = fused_iterations_on_block(
        spec, windows, s, origin, grid, compute_dtype=compute
    )
    inner = res[(Ellipsis,) + tuple(slice(h, h + t) for t in plan.tile)]
    inner = inner.reshape((B,) + plan.n_tiles + plan.tile)
    perm = [0] + [x for d in range(nd) for x in (1 + d, 1 + nd + d)]
    inner = inner.permute(perm).reshape(
        (B,) + tuple(nt * t for nt, t in zip(plan.n_tiles, plan.tile))
    )
    crop = (slice(None),) + tuple(slice(0, n) for n in grid)
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


# Each counter of :func:`launch_tile_kernel` (module docstring) and the
# round plan's per-grid count a launch adds to it for each grid.
COUNTERS = {
    "updates_issued": "issued",
    "updates_useful": "useful",
    "blocks": "tiles",
    "edge_blocks": "edge_tiles",
    "local_updates_issued": "local_issued",
    "local_updates_useful": "local_useful",
    "window_cells": "window_cells",
    "reach_cells": "reach_cells",
    "wrapped_cells": "wrapped",
    "smem_tap_loads": "tap_loads",
    "divides_reciprocal": "divides_reciprocal",
    "divides_ieee": "divides_ieee",
    "windows": "windows",
}


@functools.lru_cache(maxsize=256)
def _launch_plan(
    spec: StencilSpec, s: int, tile: tuple[int, ...] | None
) -> RoundPlan:
    """The round plan of one launch (:func:`round_plan`, whose counts
    feed :data:`COUNTERS`); raises for what the kernel cannot run.
    Cached: the same spec, depth and tile launch every round."""
    cuda_build.check_supported(spec)
    plan = round_plan(spec, s, tile)
    if plan.smem_bytes > DEFAULT_GPU.smem_per_block:
        raise ValueError(
            f"{spec.name}: s={s} tile={plan.tile} needs {plan.smem_bytes} "
            f"bytes of shared memory, over the {DEFAULT_GPU.smem_per_block} "
            "a block may use; lower the fusion depth"
        )
    if plan.tiles >= 2**31:
        raise ValueError(f"tile count {plan.tiles} out of range")
    # interior blocks address a window's cells in 32 bits from its first
    if plan.window[0] * math.prod(spec.shape[1:]) >= 2**31:
        raise ValueError(f"{spec.name}: a window spans 2**31 grid cells")
    return plan


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
    by the round loop between rounds and not passed.  The windows are
    loaded by tensor copies where the plan admits them and every floating
    input lies 16-byte aligned.  Each launch adds ``B`` times the plan's counts to
    the counters of :data:`COUNTERS`, and ``B`` times those of
    :func:`~repro_torch.kernels.tiling.launch_counts` to theirs."""
    plan = _launch_plan(spec, s, None if tile is None else tuple(tile))
    dtype = torch_dtype(spec.dtype)
    B = batched[0].shape[0]
    want = (B,) + tuple(spec.shape)
    index = set(index_inputs(spec))
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
    ins = [by_name[n].data_ptr() for n in float_inputs(spec)]
    copied = tma_windows(spec, plan)
    tma = copied > 0 and all(p % 16 == 0 for p in ins)
    geom = (B,) + plan.geom + (int(tma),)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        with span("sasa.launch.enqueue"):
            rc = lib.launch(
                ins, [by_name[n].data_ptr() for n in spec.halo_index_inputs],
                out.data_ptr(), geom, stream,
            )
    if rc != 0:
        raise RuntimeError(
            f"{spec.name}: tile kernel launch failed with cudaError {rc}"
        )
    counters = vars(launch_tile_kernel)
    for name, count in COUNTERS.items():
        counters[name] += B * getattr(plan, count)
    for name, count in launch_counts(spec, plan, tma).items():
        counters[name] += B * count
    return out


vars(launch_tile_kernel).update(dict.fromkeys((*COUNTERS, *LAUNCH_COUNTS), 0))


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
