"""SASA end-to-end automation flow (paper Sec. 4.3) on a pool of GPUs.

  DSL text ──parse──► StencilSpec ──IR lowering──► optimized spec
      ──analytical model (H100 × pool)──► ranked configs
      ──runner build──► batched runner (CUDA tile kernels, or shards)

PyTorch port of ``repro.core.autotune``.  The ranking is made on the
card's data-sheet row in a pool of ``len(devices)``
(:meth:`GPUPlatform.with_gpus`), and the runner comes from
:func:`repro_torch.runtime.batching.build_batched_runner` over that pool:
on one card the main path runs K1 (``buffer_depth=0``) or K2
(``buffer_depth=2``); a multi-device design runs the shard runner of
:mod:`repro_torch.core.distribute`.

As in the reference, the ranking is preflighted
(:func:`repro_torch.core.analysis.preflight`, over the pool, with the
device count the batched runner will use): the first feasible candidate
is built and every skipped one is kept as a diagnostic, after the
certified rounding-error bound (SASA500,
:func:`repro_torch.core.numerics.bound_diagnostic`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import analysis, dsl, model, numerics
from repro_torch.core.analysis import Diagnostic
from repro_torch.core.ir import PassReport, lower
from repro_torch.core.model import ParallelismConfig, Prediction
from repro_torch.core.platform import DEFAULT_GPU, GPUPlatform, gpu_platform_for
from repro_torch.core.spec import StencilSpec
from repro_torch.kernels.ops import resolve_pool


@dataclasses.dataclass
class TunedDesign:
    spec: StencilSpec   # the lowered (IR-optimized) spec the runner runs
    prediction: Prediction
    ranking: list[Prediction]
    runner: object  # callable(arrays) -> np.ndarray
    lowering: tuple[PassReport, ...] = ()
    # the certified bound (SASA500), then infeasible-candidate skips
    diagnostics: tuple[Diagnostic, ...] = ()

    @property
    def config(self) -> ParallelismConfig:
        return self.prediction.config


def ranking_pool(device=None, devices=None) -> list[torch.device] | None:
    """The pool a ranking is made for: the caller's, else every visible
    CUDA device, else ``None`` (one card of the default row)."""
    if devices is None and device is None and not torch.cuda.is_available():
        return None
    return resolve_pool(devices, device)


def _platform_for(pool, platform, clip: bool = False):
    """The platform a pool ranks on.

    With none given: the data-sheet row of the pool's first card (the
    H100 SXM row without CUDA) in a pool of ``len(pool)``.  An explicit
    platform keeps its own pool size for a ranking-only study and is
    clipped to the pool when a runner is built (``clip``), as the
    reference clips its chip count.
    """
    n = len(pool) if pool else 1
    if platform is None:
        dev = pool[0] if pool else None
        base = (gpu_platform_for(torch.cuda.get_device_name(dev))
                if dev is not None and dev.type == "cuda" else DEFAULT_GPU)
        return base.with_gpus(n)
    if clip:
        return platform.with_gpus(min(platform.num_gpus, n))
    return platform


def _single_grid_runner(batched):
    """``runner({name: grid})`` -> numpy grid, over a batched runner."""

    def runner(arrays):
        return batched({n: a[None] for n, a in arrays.items()})[0]

    runner.batched = batched
    runner.path = batched.path
    return runner


def _tune(source_or_spec, platform, iterations, device, devices, build,
          keep=None) -> TunedDesign:
    spec_in = (
        source_or_spec if isinstance(source_or_spec, StencilSpec)
        else dsl.parse(source_or_spec)
    )
    lowered = lower(spec_in)
    spec = lowered.spec  # ranking AND executors consume the optimized trees
    pool = resolve_pool(devices, device) if build else ranking_pool(
        device, devices
    )
    platform = _platform_for(pool, platform, clip=build)
    ranking = [
        p for p in model.choose_best(
            spec, platform, iterations=iterations, optimize=False
        )
        if keep is None or keep(p)
    ]
    if not ranking:
        raise RuntimeError(f"no candidate configuration for {spec.name!r}")
    # every port runner is a batched runner: a temporal config on the
    # pool's first device, a row partition over its first min(k, len(pool))
    verdicts = analysis.preflight(
        spec, [p.config for p in ranking], len(pool) if pool else 1,
        iterations=iterations, batched=True,
    )
    diags = [numerics.bound_diagnostic(spec, iterations=iterations)]
    diags += [v.diagnostic("info") for v in verdicts if not v.feasible]
    feasible = [p for p, v in zip(ranking, verdicts) if v.feasible]
    if not feasible:
        raise RuntimeError(
            f"no feasible configuration for {spec.name!r}:\n"
            + "\n".join(d.format() for d in diags[1:])
        )
    runner = None
    if build:
        # imported here: the runtime package imports this module
        from repro_torch.runtime.batching import build_batched_runner

        runner = _single_grid_runner(build_batched_runner(
            spec, feasible[0].config, iterations=iterations, devices=pool,
        ))
    return TunedDesign(spec, feasible[0], ranking, runner, lowered.reports,
                       tuple(diags))


def autotune(
    source_or_spec,
    platform: GPUPlatform | None = None,
    iterations: int | None = None,
    device=None,
    build: bool = True,
    devices=None,
    cache=None,
    store=None,
) -> TunedDesign:
    """The SASA entry point: DSL text (or a spec) -> ranked design + runner.

    The pool is ``devices`` (a device may repeat: ``[torch.device("cpu")]
    * 8`` runs shard designs on the host), or ``device`` alone, or every
    visible CUDA device; building without CUDA and without a pool raises
    (pass ``device="cpu"`` for the plain versions).  ``platform`` defaults
    to the data-sheet row of the pool's card, in a pool of its size.

    Pass a :class:`repro_torch.runtime.DesignCache` as ``cache`` to
    memoize the ranking and the runner across calls.  Pass a
    :class:`repro_torch.runtime.DesignStore` (or a path) as ``store`` to
    make that memoization persistent: a warm store skips the ranking and
    the kernel build.  Without ``cache`` a store-backed cache is created;
    with one, the store is attached to it (a cache bound to a *different*
    store is refused).
    """
    if store is not None:
        # imported here: the runtime package imports this module
        from repro_torch.runtime.cache import DesignCache
        from repro_torch.runtime.store import as_store

        store = as_store(store)
        if cache is None:
            cache = DesignCache(store=store)
        elif cache.store is None:
            cache.store = store
        elif cache.store is not store:
            raise ValueError(
                "autotune(store=...) conflicts with the cache's own store; "
                "pass one or the other"
            )
    if cache is None:
        return _tune(source_or_spec, platform, iterations, device, devices,
                     build)
    if not build:
        return cache.design(source_or_spec, platform=platform,
                            iterations=iterations, device=device,
                            devices=devices)
    cached = cache.get_or_build(source_or_spec, platform=platform,
                                iterations=iterations, device=device,
                                devices=devices)
    d = cached.design
    return dataclasses.replace(d, runner=_single_grid_runner(d.runner))


def soda_baseline(
    source_or_spec,
    platform: GPUPlatform | None = None,
    iterations: int | None = None,
    device=None,
    build: bool = True,
    devices=None,
) -> TunedDesign:
    """State-of-the-art baseline (SODA): temporal parallelism only.

    The paper's Sec. 5.4 comparison point: the same single-PE designs,
    but no spatial or hybrid candidate.  On one device every candidate is
    temporal, so it ranks as :func:`autotune` does; on a pool of more than
    one, :func:`autotune` also weighs the row-partitioned designs.
    """
    return _tune(source_or_spec, platform, iterations, device, devices,
                 build, keep=lambda p: p.config.variant == "temporal")
