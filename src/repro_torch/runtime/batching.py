"""Batched stencil execution on one device: one design, many grids.

PyTorch port of the single-device half of
``repro.runtime.batching.build_batched_runner``.  Every array of a batch
call is ``(B,) + spec.shape``; entries are independent and the spec's
boundary rule applies per grid.  The design's config picks the kernel:

  * ``cfg.buffer_depth >= 2`` — the batch-in-grid tile kernel K2
    (:func:`repro_torch.kernels.pipeline.stencil_run_batched`): one launch
    per round for the whole batch (``path == "tile_pipeline"``);
  * otherwise the single-PE kernel K1 per entry
    (:func:`repro_torch.kernels.ops.stencil_run`, ``path == "single_pe"``).

Both run the same tile program, so their results are bitwise equal.  On a
CPU device the same calls run the kernels' plain versions.

Every runner exposes the reference's dispatch phases: ``run.stage(arrays)``
places inputs on the device (through pinned host memory for CUDA),
``run.dispatch(staged)`` enqueues on the current stream without blocking
and records a CUDA event, ``run.ready(pending)`` polls that event
(``torch.cuda.Event.query``), and ``run.finalize(pending)`` waits and
returns numpy (bfloat16 results come back as float32, which numpy lacks).
``run(arrays)`` is the validated synchronous composition.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.model import ParallelismConfig
from repro_torch.core.spec import StencilSpec
from repro_torch.kernels import ops, pipeline
from repro_torch.kernels.blockops import torch_dtype
from repro_torch.kernels.stencil import default_tile


def resolve_backend(device: torch.device) -> str:
    """The CUDA kernels on a CUDA device; their plain versions elsewhere."""
    return "cuda" if device.type == "cuda" else "plain"


def validate_batch(
    spec: StencilSpec,
    arrays: Mapping[str, object],
    exact: bool = True,
) -> tuple[int, tuple[int, ...]]:
    """Check a batched input dict against ``spec``; returns ``(B, grid)``.

    Unknown or missing inputs and inconsistent batch shapes raise;
    ``exact=True`` pins the grid to ``spec.shape``.
    """
    unknown = sorted(set(arrays) - set(spec.inputs))
    if unknown:
        raise ValueError(
            f"unknown input(s) {unknown} for spec {spec.name!r} "
            f"(spec inputs: {sorted(spec.inputs)})"
        )
    full = None
    for n in spec.inputs:
        if n not in arrays:
            raise ValueError(
                f"batched runner missing input {n!r} "
                f"(spec inputs: {sorted(spec.inputs)})"
            )
        shape = tuple(np.shape(arrays[n]))
        if exact and (
            len(shape) != spec.ndim + 1 or shape[1:] != tuple(spec.shape)
        ):
            raise ValueError(
                f"batched runner expects {n} shaped (B,) + {spec.shape}, "
                f"got {shape}"
            )
        if full is None:
            if len(shape) != spec.ndim + 1:
                raise ValueError(
                    f"batched runner expects {n} shaped (B,) + grid, "
                    f"got {shape}"
                )
            full = shape
        elif shape != full:
            raise ValueError(
                f"inconsistent batch shapes: {n} is {shape}, "
                f"expected {full}"
            )
    return full[0], full[1:]


@dataclasses.dataclass
class Pending:
    """A dispatched batch: its output tensor and the event after it."""

    out: torch.Tensor
    event: torch.cuda.Event | None = None


def build_batched_runner(
    spec: StencilSpec,
    cfg: ParallelismConfig,
    iterations: int | None = None,
    device=None,
):
    """A runner mapping ``{name: (B,) + spec.shape}`` to ``(B,) +
    spec.shape`` for a single-device configuration.

    The kernel tile comes from ``cfg.tile_rows`` alone, the same field the
    ranker priced and checked against shared memory.
    ``device`` defaults to ``cuda`` and raises when CUDA is absent.
    Multi-device configs are not ported yet and raise.  The runner carries
    ``.path`` ("single_pe" or "tile_pipeline"), ``.backend``, ``.cfg``,
    ``.device`` and the dispatch phases described in the module docstring.
    """
    it = spec.iterations if iterations is None else iterations
    dev = ops.resolve_device(device)
    if cfg.variant != "temporal" and cfg.k > 1:
        raise NotImplementedError(
            f"{cfg.variant}(k={cfg.k}) needs several devices; multi-device "
            "designs are not ported yet"
        )
    s = max(min(cfg.s, it), 1)
    tile = default_tile(spec.ndim, cfg.tile_rows)
    backend = resolve_backend(dev)

    if cfg.buffer_depth >= 2:
        def fn(arrays: Mapping[str, torch.Tensor]) -> torch.Tensor:
            return pipeline.stencil_run_batched(spec, arrays, it, s=s, tile=tile)

        path = "tile_pipeline"
    else:
        def fn(arrays: Mapping[str, torch.Tensor]) -> torch.Tensor:
            B = next(iter(arrays.values())).shape[0]
            return torch.stack([
                ops.stencil_run(
                    spec, {n: a[b] for n, a in arrays.items()}, it, s=s,
                    tile=tile, backend="cuda", device=dev,
                )
                for b in range(B)
            ])

        path = "single_pe"

    def stage(arrays: Mapping[str, object]) -> dict[str, torch.Tensor]:
        staged = {}
        for n, (dt, _) in spec.inputs.items():
            a = arrays[n]
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(a)
            )
            if dev.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory()
            staged[n] = t.to(
                device=dev, dtype=torch_dtype(dt), non_blocking=True
            ).contiguous()
        return staged

    def dispatch(staged: Mapping[str, torch.Tensor]) -> Pending:
        out = fn(dict(staged))
        event = None
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
        return Pending(out, event)

    def ready(pending: Pending) -> bool:
        return pending.event is None or pending.event.query()

    def finalize(pending: Pending) -> np.ndarray:
        if pending.event is not None:
            pending.event.synchronize()
        out = pending.out.cpu()
        if out.dtype == torch.bfloat16:
            out = out.float()
        return out.numpy()

    def run(arrays: Mapping[str, object]) -> np.ndarray:
        validate_batch(spec, arrays)
        return finalize(dispatch(stage(arrays)))

    run.spec = spec
    run.cfg = cfg
    run.iterations = it
    run.path = path
    run.backend = backend
    run.device = dev
    run.tile = tile
    run.stage = stage
    run.dispatch = dispatch
    run.ready = ready
    run.finalize = finalize
    return run
