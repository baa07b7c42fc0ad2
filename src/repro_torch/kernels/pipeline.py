"""K2: the batch-in-grid tile kernel on Hopper, with its plain version.

Replaces ``src/repro/kernels/pipeline.py::stencil_pallas_batched``, which
ran K1's tile program over a ``(B, n_tiles)`` Pallas grid.  Here the batch
rides ``gridDim.z`` of the same CUDA tile kernel K1 launches
(``csrc/stencil_tile.cuh``): one launch per round serves all ``B`` grids,
and every thread block runs the body K1 runs, so the results are bitwise
equal to K1 per entry.  The TPU pipeline's double-buffered HBM->VMEM copy
of the next tile is scheduling, not semantics; its Hopper counterpart
(``cp.async``/TMA prefetch) is later work.

What bounds it on this card: HBM bytes, as K1 — per round every entry's
input windows are read and its grid written once (8 x 40 MB for a batch of
eight 9720x1024 f32 grids, over the 50 MB L2).

:func:`stencil_cuda_batched` launches the kernel for CUDA tensors (counted
on ``stencil_cuda_batched.launches``); CPU tensors run the plain version
:func:`stencil_torch_pipeline` (counted on
``stencil_cuda_batched.plain_calls``).  :func:`stencil_run_batched` is the round
loop, with streamed wrap margins re-imposed between rounds by a
``torch.gather`` at grid granularity, outside the kernel.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import torch

from repro_torch.core.spec import StencilSpec
from repro_torch.kernels.ops import run_rounds
from repro_torch.kernels.stencil import _device_of, launch_tile_kernel, tiled_round


def stencil_torch_pipeline(
    spec: StencilSpec,
    arrays: Mapping[str, torch.Tensor],
    s: int,
    tile: Sequence[int] | None = None,
) -> torch.Tensor:
    """Plain version of :func:`stencil_cuda_batched`: one round of ``s``
    fused iterations over a ``(B,) + spec.shape`` batch, walking the
    kernel's tiles with the batch as a leading axis."""
    return tiled_round(
        spec, {n: torch.as_tensor(a) for n, a in arrays.items()}, s, tile
    )


def stencil_cuda_batched(
    spec: StencilSpec,
    arrays: Mapping[str, torch.Tensor],
    s: int,
    tile: Sequence[int] | None = None,
) -> torch.Tensor:
    """One round of ``s`` fused iterations over a whole batch, the batch
    folded into the kernel grid.  CUDA tensors launch the kernel; CPU
    tensors run :func:`stencil_torch_pipeline`."""
    device = _device_of(spec, arrays)
    if device.type == "cpu":
        stencil_cuda_batched.plain_calls += 1
        return stencil_torch_pipeline(spec, arrays, s, tile)
    out = launch_tile_kernel(spec, [arrays[n] for n in spec.inputs], s, tile)
    stencil_cuda_batched.launches += 1
    return out


stencil_cuda_batched.launches = 0
stencil_cuda_batched.plain_calls = 0


def stencil_run_batched(
    spec: StencilSpec,
    arrays: Mapping[str, torch.Tensor],
    iterations: int | None = None,
    s: int = 1,
    tile: Sequence[int] | None = None,
) -> torch.Tensor:
    """Run the stencil to completion over a ``(B,)``-leading batch:
    ``ceil(iterations / s)`` rounds of :func:`stencil_cuda_batched`.

    Specs with streamed wrap margins cap the per-round depth at
    ``spec.wrap_round_depth`` and re-wrap the iterate between rounds.
    """
    it = spec.iterations if iterations is None else iterations
    return run_rounds(spec, arrays, it, s, stencil_cuda_batched, tile)
