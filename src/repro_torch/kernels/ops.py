"""Public entry points over the stencil executors (PyTorch port).

``stencil_run`` is what a runner calls once the ranker has chosen a
configuration; it keeps the reference's round structure (``ceil(it/s)``
kernel launches, with a smaller fused depth for a ragged last round).
"""
from __future__ import annotations

from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.spec import StencilSpec
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.blockops import (
    fused_iterations_dense,
    torch_dtype,
    wrap_round_fixup,
)
from repro_torch.kernels.stencil import stencil_cuda
from repro_torch.trace import span

BACKENDS = ("ref", "torch", "cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch device; with none given, ``cuda`` — and a
    :class:`RuntimeError` when CUDA is absent (entry points never fall
    back to the CPU unasked)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain versions "
            "on the CPU"
        )
    return torch.device("cuda")


def _indexed(device) -> torch.device:
    """``device`` with its index: ``cuda`` names the current card, so one
    card has one name wherever a pool is used as a key."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_pool(devices=None, device=None) -> list[torch.device]:
    """The device pool of an entry point: ``devices`` as given (a device
    may repeat: ``[torch.device("cpu")] * 8`` or ``[cuda:0] * 4`` are
    pools of 8 and 4), else a pool of one (``device``), else every visible
    CUDA device -- and a :class:`RuntimeError` when CUDA is absent.  A
    CUDA device without an index is the current card (``cuda:0`` unless
    set otherwise)."""
    if devices is not None:
        if device is not None:
            raise ValueError("pass device= or devices=, not both")
        pool = [_indexed(d) for d in devices]
        if not pool:
            raise ValueError("empty device pool")
        return pool
    if device is not None:
        return [_indexed(device)]
    resolve_device()
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def to_device(
    spec: StencilSpec, arrays_np: Mapping[str, object], device=None
) -> dict[str, torch.Tensor]:
    """Place inputs (numpy arrays or tensors) on ``device`` in each input's
    declared dtype; a leading batch axis is kept, and a tensor already in
    place is returned as it is."""
    dev = resolve_device(device)
    out = {}
    for n, (dt, _) in spec.inputs.items():
        a = arrays_np[n]
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a))
        out[n] = a.to(device=dev, dtype=torch_dtype(dt)).contiguous()
    return out


def stencil_run(
    spec: StencilSpec,
    arrays: Mapping[str, torch.Tensor],
    iterations: int | None = None,
    s: int = 1,
    tile: Sequence[int] | None = None,
    backend: str = "cuda",
    device=None,
) -> torch.Tensor:
    """Run the stencil to completion with fusion depth ``s``.

    backend: ``'ref'`` (oracle), ``'torch'`` (dense fused rounds),
    ``'cuda'`` (the tile kernel K1 per round; its plain version when
    ``device`` is the CPU).  Inputs (numpy or tensors) are placed on
    ``device``, which defaults to ``cuda`` and raises without it.
    """
    it = spec.iterations if iterations is None else iterations
    arrays = to_device(spec, arrays, device)
    if backend == "ref":
        return _ref.stencil_iterations_ref(spec, arrays, it)
    if backend == "torch":
        return fused_iterations_dense(spec, dict(arrays), it, min(s, it))
    if backend != "cuda":
        raise ValueError(f"unknown backend {backend!r} (expected {BACKENDS})")
    return run_rounds(spec, arrays, it, s, stencil_cuda, tile)


def run_rounds(
    spec: StencilSpec,
    arrays: Mapping[str, torch.Tensor],
    iterations: int,
    s: int,
    round_fn: Callable[..., torch.Tensor],
    tile: Sequence[int] | None = None,
) -> torch.Tensor:
    """The round loop shared by every runner: ``ceil(iterations / s)``
    calls of ``round_fn(spec, env, step, tile)``, each one round of
    ``step <= s`` fused iterations, with the iterate rebound in between.

    Specs with streamed wrap margins cap the per-round depth at
    ``spec.wrap_round_depth`` and re-wrap the iterate between rounds.
    Each round, its wrap fix-up included, is one ``sasa.round`` span
    (:mod:`repro_torch.trace`).
    """
    env = dict(arrays)
    out = env[spec.iterate_input]
    left = iterations
    first = True
    while left > 0:
        with span("sasa.round"):
            step = min(s, left)
            if spec.wrap_index_inputs:
                step = min(step, max(spec.wrap_round_depth, 1))
                if not first:
                    out = wrap_round_fixup(out, env, spec)
                    env[spec.iterate_input] = out
            first = False
            out = round_fn(spec, env, step, tile)
            env[spec.iterate_input] = out
            left -= step
    return out
