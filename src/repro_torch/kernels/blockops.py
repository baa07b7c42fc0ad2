"""Fused multi-iteration stencil execution on a block (trapezoid scheme).

PyTorch port of ``repro.kernels.blockops``: the plain version of the tile
body that the CUDA kernel (``csrc/stencil_tile.cuh``) runs, shared by

  * the tiled plain executors (:func:`repro_torch.kernels.stencil.
    stencil_torch_tiled`, :func:`repro_torch.kernels.pipeline.
    stencil_torch_pipeline`), which walk the kernel's tiles, and
  * the dense executor (:func:`fused_iterations_dense`, one block per grid).

A block is a tensor whose trailing ``spec.ndim`` axes are the window; any
leading axes (batch, tile index) ride along.  ``origin`` gives the grid
coordinate of window cell 0 on every axis, either as a tuple of ints (one
block) or as an int tensor of shape ``(T, ndim)`` for a stack of ``T``
tiles on the axis just before the window.

Trapezoid correctness argument: a block carries ``h >= s * radius`` halo
cells on each side of every axis.  Each stage zero-pads at the block edge,
so each fused iteration invalidates ``radius`` cells at each edge, and
after ``s`` iterations the cells at distance ``>= h`` from the edge are
exact.  Callers consume only that interior.

Boundary handling differs from the reference in one respect.  The TPU
block held every column, so ``repro.kernels.blockops.boundary_fixup``
re-wrapped periodic columns and clamped replicate columns in-block.  The
GPU kernel tiles every axis, so here every axis is treated the way the
reference treats rows: out-of-grid cells are re-imposed after every stage
(zero, the constant, or the clamped in-block edge cell), and periodic
cells arrive as wrapped data and go stale under the trapezoid argument.
The interior results are the same.

Precision: with ``compute_dtype`` set (the tiled executors pass float32
for bfloat16 specs, as the CUDA kernel computes), every stage evaluates in
that type and rounds to ``Stage.dtype`` where it writes.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.spec import (
    Boundary,
    Stage,
    StencilSpec,
    ZERO_BOUNDARY,
    eval_expr,
    refs_in,
)


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a DSL dtype name."""
    return getattr(torch, str(name))


def _block_stage(
    stage: Stage,
    env: Mapping[str, torch.Tensor],
    ndim: int,
    compute_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """One stage over a block, zero-padding at block edges (same shape out)."""
    r = stage.radius
    used = {ref.name for ref in refs_in(stage.expr)}
    shape = next(iter(env.values())).shape[-ndim:]
    padded = {n: F.pad(env[n], [r, r] * ndim) for n in used}

    def get_ref(name, offsets):
        idx = (Ellipsis,) + tuple(
            slice(r + o, r + o + s) for o, s in zip(offsets, shape)
        )
        return padded[name][idx]

    out = eval_expr(stage.expr, get_ref)
    if not isinstance(out, torch.Tensor):   # a constant stage
        ref = next(iter(env.values()))
        out = torch.full_like(ref, out, dtype=compute_dtype or ref.dtype)
    out = out.to(torch_dtype(stage.dtype))
    return out if compute_dtype is None else out.to(compute_dtype)


def _fold_index(idx: torch.Tensor, n: int, boundary: Boundary) -> torch.Tensor:
    """Source index along one axis: wrap for periodic, else clamp (the
    zero/constant cells are overwritten by the caller's mask)."""
    if boundary.kind == "periodic":
        return torch.remainder(idx, n)
    return idx.clamp(0, n - 1)


def boundary_pad(
    a: torch.Tensor, pads: Sequence[tuple[int, int]], boundary: Boundary
) -> torch.Tensor:
    """Pad the trailing ``len(pads)`` axes with the boundary rule's fill.

    Built from index arithmetic, not ``F.pad``: like ``jnp.pad`` with
    ``mode="wrap"``/``"edge"``, a pad wider than the axis tiles the data
    again (``F.pad(mode="circular")`` refuses that).
    """
    nd = len(pads)
    out = a
    mask = None
    for d, (lo, hi) in enumerate(pads):
        axis = a.dim() - nd + d
        n = a.shape[axis]
        idx = torch.arange(-lo, n + hi, device=a.device)
        out = out.index_select(axis, _fold_index(idx, n, boundary))
        if boundary.kind in ("zero", "constant"):
            inside = (idx >= 0) & (idx < n)
            view = [1] * nd
            view[d] = idx.numel()
            m = inside.view(view)
            mask = m if mask is None else mask & m
    if mask is not None:
        out = torch.where(mask, out, out.new_tensor(boundary.value))
    return out


def _coords(origin, block_shape: Sequence[int], d: int, device) -> torch.Tensor:
    """Grid coordinate of every block cell along window axis ``d``,
    shaped to broadcast against a block (and its tile axis)."""
    return (
        _window_index(block_shape, d, device)
        + _origin_axis(origin, len(block_shape), d)
    )


def grid_mask(
    block_shape: Sequence[int],
    origin,
    grid_shape: Sequence[int],
    device=None,
) -> torch.Tensor:
    """True where a block cell maps to a real grid cell."""
    mask = None
    for d, n in enumerate(grid_shape):
        c = _coords(origin, block_shape, d, device)
        m = (c >= 0) & (c < n)
        mask = m if mask is None else mask & m
    return mask


def _gather_axis(block: torch.Tensor, tgt: torch.Tensor, d: int, nd: int):
    """``out[..., i, ...] = block[..., tgt[i], ...]`` along window axis d,
    with ``tgt`` broadcastable to the block (per-tile targets allowed)."""
    axis = block.dim() - nd + d
    shape = list(block.shape)
    return torch.gather(block, axis, tgt.expand(shape))


def boundary_fixup(
    block: torch.Tensor,
    origin,
    grid_shape: Sequence[int],
    boundary: Boundary = ZERO_BOUNDARY,
) -> torch.Tensor:
    """Re-impose the boundary rule on every out-of-grid cell of a block.

    In-grid cells are returned untouched.  Replicate copies the clamped
    nearest grid cell, which the block holds because every tiler starts
    its tiles inside the grid.  Periodic leaves the block as it is (wrapped
    cells arrive as data, see the module docstring).
    """
    kind = boundary.kind
    nd = len(grid_shape)
    shape = block.shape[-nd:]
    if kind in ("zero", "constant"):
        mask = grid_mask(shape, origin, grid_shape, block.device)
        return torch.where(mask, block, block.new_tensor(boundary.value))
    if kind == "periodic":
        return block
    out = block
    for d, n in enumerate(grid_shape):
        w = _window_index(shape, d, block.device)
        c = _coords(origin, shape, d, block.device)
        # block-local index of the clamped grid cell (origin = c - w)
        tgt = (c.clamp(0, n - 1) - c + w).clamp(0, shape[d] - 1)
        out = _gather_axis(out, tgt, d, nd)
    return out


def _window_index(block_shape: Sequence[int], d: int, device) -> torch.Tensor:
    """Block-local index along window axis ``d``, shaped to broadcast."""
    view = [1] * len(block_shape)
    view[d] = -1
    return torch.arange(block_shape[d], device=device).view(view)


def _origin_axis(origin, nd: int, d: int):
    """Origin along axis ``d``: an int, or a per-tile tensor shaped to
    broadcast against a block."""
    if isinstance(origin, torch.Tensor):
        return origin[:, d].view([-1] + [1] * nd)
    return int(origin[d])


def streamed_halo_fixup(
    block: torch.Tensor,
    env: Mapping[str, torch.Tensor],
    spec: StencilSpec,
    origin,
) -> torch.Tensor:
    """Re-impose a *streamed* (per-request) boundary on a block.

    ``spec.halo_index_inputs`` names one int32 input per axis holding the
    grid coordinate each cell copies from (identity on the real region,
    a clamp target on a bucket's padding belt).  The target is made
    block-local and clipped to the block; every producer emits monotone
    clamp maps, so the gather is a select against the lowest and highest
    target of each block, as in the reference.
    """
    nd = spec.ndim
    shape = block.shape[-nd:]
    win_axes = tuple(range(block.dim() - nd, block.dim()))
    out = block
    for d, name in enumerate(spec.halo_index_inputs):
        tgt = env[name].long() - _origin_axis(origin, nd, d)
        tgt = tgt.clamp(0, shape[d] - 1)
        lo = tgt.amin(dim=win_axes, keepdim=True)
        hi = tgt.amax(dim=win_axes, keepdim=True)
        w = _window_index(shape, d, block.device)
        one = list(out.shape)
        one[block.dim() - nd + d] = 1
        at_lo = torch.gather(out, block.dim() - nd + d, lo.expand(one))
        at_hi = torch.gather(out, block.dim() - nd + d, hi.expand(one))
        out = torch.where(w < lo, at_lo, torch.where(w > hi, at_hi, out))
    return out


def fused_iterations_on_block(
    spec: StencilSpec,
    blocks: Mapping[str, torch.Tensor],
    s: int,
    origin,
    grid_shape: Sequence[int],
    boundary: Boundary | None = None,
    compute_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Apply ``s`` fused iterations to a block; returns the iterated array.

    ``blocks`` maps every spec input to a same-shape block (halo included).
    Only the ``iterate_input`` evolves.  Streamed specs re-impose the
    per-request belt (:func:`streamed_halo_fixup`) on entry and after every
    stage, before the block-level boundary rule.
    """
    boundary = spec.boundary if boundary is None else boundary
    nd = spec.ndim
    env = dict(blocks)
    if compute_dtype is not None:
        env = {
            n: a.to(compute_dtype) if a.is_floating_point() else a
            for n, a in env.items()
        }

    def fixup(a):
        return boundary_fixup(a, origin, grid_shape, boundary)

    streamed = bool(spec.halo_index_inputs)
    if streamed:
        src = dict(env)
        env = {
            n: streamed_halo_fixup(a, src, spec, origin)
            for n, a in env.items()
        }
    env = {n: fixup(a) for n, a in env.items()}
    cur = env[spec.iterate_input]
    for _ in range(s):
        env[spec.iterate_input] = cur
        stage_env = dict(env)
        for stage in spec.stages:
            out = _block_stage(stage, stage_env, nd, compute_dtype)
            if streamed:
                out = streamed_halo_fixup(out, stage_env, spec, origin)
            out = fixup(out)  # the boundary is re-imposed at every stage
            stage_env[stage.name] = out
        cur = stage_env[spec.output_name]
    return cur


def wrap_round_fixup(
    out: torch.Tensor,
    env: Mapping[str, torch.Tensor],
    spec: StencilSpec,
) -> torch.Tensor:
    """Re-impose a streamed periodic wrap margin on the iterate.

    ``spec.wrap_index_inputs`` names one int32 grid-shaped input per axis
    holding the coordinate each cell copies from.  Called **between**
    fused rounds, at grid granularity: a ``torch.gather`` per axis.  Works
    on one grid or on a ``(B,)``-leading batch.
    """
    nd = spec.ndim
    for d, name in enumerate(spec.wrap_index_inputs):
        axis = out.dim() - nd + d
        tgt = torch.as_tensor(env[name], device=out.device).long()
        tgt = tgt.clamp(0, out.shape[axis] - 1).expand(out.shape)
        out = torch.gather(out, axis, tgt)
    return out


def fused_iterations_dense(
    spec: StencilSpec,
    arrays: Mapping[str, torch.Tensor],
    iterations: int,
    s: int,
) -> torch.Tensor:
    """Single-device fused execution: ``ceil(iterations / s)`` rounds over
    the whole grid held as one block.

    Non-zero boundaries pad every axis with an ``s * r``-deep boundary
    belt per round (index arithmetic, see :func:`boundary_pad`).  Specs
    carrying streamed wrap inputs cap the fused depth per round at
    ``spec.wrap_round_depth`` and re-wrap the iterate between rounds.
    """
    grid_shape = spec.shape
    nd = spec.ndim
    left = iterations
    cur = dict(arrays)
    out = cur[spec.iterate_input]
    boundary = spec.boundary
    r = spec.radius
    first = True
    while left > 0:
        step = min(s, left)
        if spec.wrap_index_inputs:
            step = min(step, max(spec.wrap_round_depth, 1))
            if not first:
                out = wrap_round_fixup(out, cur, spec)
                cur[spec.iterate_input] = out
        first = False
        if boundary.is_zero:
            out = fused_iterations_on_block(
                spec, cur, step, (0,) * nd, grid_shape
            )
        else:
            h = step * r
            padded = {
                n: boundary_pad(a, [(h, h)] * nd, boundary)
                for n, a in cur.items()
            }
            ext = fused_iterations_on_block(
                spec, padded, step, (-h,) * nd, grid_shape
            )
            out = ext[(Ellipsis,) + tuple(slice(h, h + n) for n in grid_shape)]
        cur[spec.iterate_input] = out
        left -= step
    return out
