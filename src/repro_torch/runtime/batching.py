"""Batched stencil execution: one design, many grids, over a device pool.

PyTorch port of ``repro.runtime.batching``.  Every array of a batch call
is ``(B,) + spec.shape``; entries are independent and the spec's boundary
rule applies per grid.  The config and the pool pick the executor:

  * a row-partitioned config (spatial or hybrid, ``k > 1``), on a pool
    of more than one device, runs the shard runner of
    :func:`repro_torch.core.distribute.build_runner` over the first
    ``min(cfg.k, len(pool))`` devices (``path == "shard_map"``,
    ``backend == "torch"``: eager torch, no CUDA kernel);
  * everything else runs on the pool's first device, a temporal config
    on any pool: the tile kernel fuses its ``s`` stages on one card,
    which is what the reference's pipeline of ``s`` devices computes, and
    :func:`devices_used` is 1.  There ``cfg.buffer_depth >= 2``
    takes the batch-in-grid tile kernel K2
    (:func:`repro_torch.kernels.pipeline.stencil_run_batched`): one launch
    per round for the whole batch (``path == "tile_pipeline"``);
  * and the rest the single-PE kernel K1 per entry, through the round
    loop :func:`repro_torch.kernels.ops.run_rounds` on the staged
    tensors (``path == "single_pe"``).

K1 and K2 run the same tile program, so their results are bitwise equal.
On a CPU device the same calls run the kernels' plain versions.  A
row-partitioned config needing more devices than the pool holds is
**degraded**, as in the reference: it warns :class:`DegradedDesignWarning`
(or raises under ``strict``) and runs on what the pool has.

Every runner exposes the reference's dispatch phases: ``run.stage(arrays)``
places inputs on the device (through pinned host memory for CUDA),
``run.dispatch(staged)`` enqueues on the current stream without blocking
and records a CUDA event, ``run.ready(pending)`` polls that event
(``torch.cuda.Event.query``), and ``run.finalize(pending)`` waits and
returns numpy (bfloat16 results come back as float32, which numpy lacks).
``run(arrays)`` is the validated synchronous composition.  The kernel
runner's ``stage`` and ``dispatch`` are the spans ``sasa.stage`` and
``sasa.dispatch`` (:mod:`repro_torch.trace`); a dispatch carries the
runner's solve sequence number.

:func:`build_bucket_runner` wraps a runner built for a padded canonical
**bucket** shape so it serves any grid that fits inside the bucket, with
the real grid's boundary rule -- zero, constant, replicate, or periodic --
re-imposed from per-request streamed inputs (mask, halo-index maps, or
host-streamed wrap margins and wrap maps; see
:mod:`repro_torch.runtime.bucketing`).
"""
from __future__ import annotations

import dataclasses
import itertools
import warnings
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.distribute import build_runner
from repro_torch.core.model import ParallelismConfig
from repro_torch.core.spec import StencilSpec
from repro_torch.kernels import ops, pipeline
from repro_torch.kernels.ops import resolve_pool
from repro_torch.kernels.blockops import torch_dtype
from repro_torch.kernels.stencil import stencil_cuda
from repro_torch.kernels.tiling import default_tile
from repro_torch.runtime.bucketing import bucket_plan
from repro_torch.trace import span


class DegradedDesignWarning(RuntimeWarning):
    """A design is executing with less parallelism than its config claims."""


def devices_needed(cfg: ParallelismConfig) -> int:
    """Device count a config occupies (see ParallelismConfig.devices_needed)."""
    return cfg.devices_needed


def devices_used(cfg: ParallelismConfig, n_avail: int) -> int:
    """Devices a batched runner of ``cfg`` occupies on a pool of
    ``n_avail``: one for a temporal config (fused rounds of the tile
    kernel), else ``min(cfg.devices_needed, n_avail)``."""
    if cfg.variant == "temporal":
        return 1
    return min(cfg.devices_needed, n_avail)


def is_degraded(cfg: ParallelismConfig, n_avail: int) -> bool:
    """True when a pool of ``n_avail`` devices cannot realise ``cfg``'s
    parallelism.  A temporal design never is: its PE cascade runs as
    fused rounds of the tile kernel on one card, with the fusion depth
    (and the model's single-card prediction) preserved -- the reference's
    sanctioned one-device case, taken on every pool."""
    return cfg.variant != "temporal" and n_avail < cfg.devices_needed


def degraded_message(cfg: ParallelismConfig, n_avail: int) -> str:
    n_dev = min(cfg.devices_needed, n_avail)
    return (
        f"design {cfg.variant}(k={cfg.k}, s={cfg.s}) needs "
        f"{cfg.devices_needed} device(s) but only {n_avail} are available; "
        f"executing on {n_dev} loses the configured parallelism while "
        f"run.cfg still claims it"
    )


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
    devices=None,
    strict: bool = False,
):
    """A runner mapping ``{name: (B,) + spec.shape}`` to ``(B,) +
    spec.shape`` for a configuration on a device pool.

    The pool is ``devices`` (a device may repeat), or ``device`` alone,
    or every visible CUDA device; it raises when neither is given and CUDA
    is absent.  ``n = devices_used(cfg, len(pool))``: with ``n > 1`` the
    shard runner runs on ``pool[:n]``, else the K1/K2 tile kernel on
    ``pool[0]`` at fusion depth ``min(cfg.s, iterations)``, its tile from
    ``cfg.tile_rows`` alone (the field the ranker priced and checked
    against shared memory); a temporal config always takes the kernel.
    A degraded config (a row partition on a pool smaller than ``k``)
    warns :class:`DegradedDesignWarning`, or raises :class:`ValueError`
    under ``strict``.  The runner carries ``.path`` ("single_pe",
    "tile_pipeline" or "shard_map"), ``.backend``, ``.cfg``, ``.device``
    (the pool's first), ``.devices`` (those it runs on), ``.n_devices``,
    ``.devices_requested``, ``.degraded`` and the dispatch phases
    described in the module docstring.
    """
    it = spec.iterations if iterations is None else iterations
    pool = resolve_pool(devices, device)
    need = cfg.devices_needed
    n_dev = devices_used(cfg, len(pool))
    degraded = is_degraded(cfg, len(pool))
    if degraded:
        msg = degraded_message(cfg, len(pool))
        if strict:
            raise ValueError(msg)
        warnings.warn(msg, DegradedDesignWarning, stacklevel=2)
    if n_dev > 1:
        run = _shard_runner(spec, cfg, it, pool[:n_dev])
    else:
        run = _kernel_runner(spec, cfg, it, pool[0])
    run.devices_requested = need
    run.degraded = degraded
    return run


def _shard_runner(spec, cfg, it, pool):
    """The batched shard runner, validated like the kernel runner."""
    inner = build_runner(spec, cfg, iterations=it, devices=pool, batched=True)

    def run(arrays: Mapping[str, object]) -> np.ndarray:
        validate_batch(spec, arrays)
        return inner.finalize(inner.dispatch(inner.stage(arrays)))

    for attr in ("spec", "cfg", "iterations", "path", "backend", "device",
                 "devices", "n_devices", "tile",
                 "stage", "dispatch", "ready", "finalize"):
        setattr(run, attr, getattr(inner, attr))
    return run


def _kernel_runner(spec, cfg, it, dev):
    """K1 or K2 on one device (see the module docstring)."""
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
                ops.run_rounds(spec, {n: a[b] for n, a in arrays.items()},
                               it, s, stencil_cuda, tile)
                for b in range(B)
            ])

        path = "single_pe"

    def stage(arrays: Mapping[str, object]) -> dict[str, torch.Tensor]:
        with span("sasa.stage"):
            staged = {}
            for n, (dt, _) in spec.inputs.items():
                a = arrays[n]
                t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
                    np.require(a, requirements="CW")   # broadcast views copy
                )
                if dev.type == "cuda" and t.device.type == "cpu":
                    t = t.pin_memory()
                staged[n] = t.to(
                    device=dev, dtype=torch_dtype(dt), non_blocking=True
                ).contiguous()
            return staged

    solves = itertools.count()

    def dispatch(staged: Mapping[str, torch.Tensor]) -> Pending:
        with span("sasa.dispatch", next(solves)):
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
    run.devices = [dev]
    run.n_devices = 1
    run.tile = tile
    run.stage = stage
    run.dispatch = dispatch
    run.ready = ready
    run.finalize = finalize
    return run


def build_bucket_runner(
    spec: StencilSpec,
    bucket_shape: Sequence[int],
    cfg: ParallelismConfig,
    iterations: int | None = None,
    device=None,
    inner=None,
    wrap_rounds: int | None = None,
    devices=None,
):
    """Streamed-boundary wrapper: a design built for ``bucket_shape``
    serving any fitting grid with the spec's exact boundary semantics.

    The inner runner is a batched runner for the **streamed bucket spec**
    (:func:`repro_torch.runtime.bucketing.bucket_spec`); the wrapper
    stages each request through the bucket's host plan
    (:class:`repro_torch.runtime.bucketing.BucketPlan`): inputs are laid
    into the bucket with the boundary's margin fill (zeros/constant,
    clamped edge, or the wrapped periodic halo computed from the *real*
    shape), alongside the per-request streamed service inputs -- the
    ``_mask`` woven into every stage, the replicate halo-index maps the
    tile kernel consumes after every stage, or the periodic wrap maps the
    round loop consumes between rounds.

    ``run(arrays)`` takes one uniform-shape batch ``{name: (B,) + grid}``
    with ``grid + 2 * margins <= bucket_shape`` per axis and returns
    ``(B,) + grid``.  Serving layers that mix grid shapes in one
    micro-batch stage each entry through ``run.plan`` and drive
    ``run.stage`` / ``run.dispatch`` / ``run.finalize`` directly.

    Pass ``inner`` to wrap an already-built batched runner for the
    streamed bucket spec (the design-cache path).  ``wrap_rounds``
    (periodic only) serves from the narrow ``wrap_rounds * radius``
    margin.  ``device`` / ``devices`` are :func:`build_batched_runner`'s:
    a row-partitioned config on a pool runs the bucket spec on the
    shard runner, whose exchanges carry the replicate halo-index maps with
    the rows like every other input (a periodic spec there needs the wide
    margin: ``wrap_rounds=None``).
    """
    bucket_shape = tuple(int(b) for b in bucket_shape)
    plan = bucket_plan(
        spec, bucket_shape, iterations=iterations, wrap_rounds=wrap_rounds
    )
    mspec = plan.mspec
    if inner is None:
        inner = build_batched_runner(
            mspec, cfg, iterations=iterations, device=device,
            devices=devices,
        )

    def run(arrays: Mapping[str, object]) -> np.ndarray:
        B, grid = validate_batch(spec, arrays, exact=False)
        padded = {
            n: plan.place_entry(np.asarray(arrays[n]), batched=True)
            for n in spec.inputs
        }
        for sname, svc in plan.service_entry(grid).items():
            padded[sname] = np.broadcast_to(svc[None], (B,) + bucket_shape)
        out = inner(padded)
        return out[(slice(None),) + plan.out_index(grid)]

    run.spec = spec
    run.masked_spec = mspec
    run.mask_name = plan.mask_name
    run.bucket_shape = bucket_shape
    run.plan = plan
    run.wrap_rounds = plan.wrap_rounds
    run.inner = inner
    for attr in ("cfg", "iterations", "path", "backend", "device",
                 "devices", "n_devices", "devices_requested", "degraded",
                 "tile",
                 "stage", "dispatch", "ready", "finalize"):
        setattr(run, attr, getattr(inner, attr))
    return run
