"""Plain-torch oracle for stencil execution (exact boundary semantics).

PyTorch port of ``repro.kernels.ref``: every stage reads every array
through the spec's :class:`~repro_torch.core.spec.Boundary` extension —
zeros, a constant, the clamped edge cell, or the wrapped opposite edge —
over the whole grid, with no tiling and no fusion.  Works on one grid or
on a ``(B,)``-leading batch (the trailing ``spec.ndim`` axes are the grid).
"""
from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.core.spec import Boundary, Stage, StencilSpec, ZERO_BOUNDARY, eval_expr
from repro_torch.kernels.blockops import boundary_pad, torch_dtype


def apply_stage(
    stage: Stage,
    arrays: Mapping[str, torch.Tensor],
    boundary: Boundary = ZERO_BOUNDARY,
    ndim: int | None = None,
) -> torch.Tensor:
    """Apply one stencil stage over the full grid with the boundary rule."""
    first = next(iter(arrays.values()))
    ndim = first.dim() if ndim is None else ndim
    shape = first.shape[-ndim:]
    r = stage.radius
    padded = {
        name: boundary_pad(a, [(r, r)] * ndim, boundary)
        for name, a in arrays.items()
    }

    def get_ref(name, offsets):
        idx = (Ellipsis,) + tuple(
            slice(r + o, r + o + s) for o, s in zip(offsets, shape)
        )
        return padded[name][idx]

    out = eval_expr(stage.expr, get_ref)
    if not isinstance(out, torch.Tensor):
        out = torch.full_like(first, out)
    return out.to(torch_dtype(stage.dtype))


def stencil_step_ref(
    spec: StencilSpec, arrays: Mapping[str, torch.Tensor]
) -> torch.Tensor:
    """One full iteration (all local stages + output stage)."""
    env = dict(arrays)
    for stage in spec.stages:
        env[stage.name] = apply_stage(stage, env, spec.boundary, spec.ndim)
    return env[spec.output_name]


def stencil_iterations_ref(
    spec: StencilSpec,
    arrays: Mapping[str, torch.Tensor],
    iterations: int | None = None,
) -> torch.Tensor:
    """Run ``iterations`` ping-pong iterations (Section 2.1)."""
    it = spec.iterations if iterations is None else iterations
    env = dict(arrays)
    out = env[spec.iterate_input]
    for _ in range(it):
        out = stencil_step_ref(spec, env)
        env[spec.iterate_input] = out
    return out
