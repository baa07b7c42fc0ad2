"""SASA end-to-end automation flow (paper Sec. 4.3), one-GPU edition.

  DSL text ──parse──► StencilSpec ──IR lowering──► optimized spec
      ──analytical model (H100)──► ranked configs
      ──runner build──► batched runner over the CUDA tile kernels

PyTorch port of the single-device path of ``repro.core.autotune``.  For
``k=1`` the reference builds through ``distribute.build_runner``, a
shard_map pipeline that never reaches its Pallas kernel.  Here the runner
comes from :func:`repro_torch.runtime.batching.build_batched_runner` for
the chosen config, so the main path runs K1 (``buffer_depth=0``) or K2
(``buffer_depth=2``).

As in the reference, the ranking is preflighted
(:func:`repro_torch.core.analysis.preflight`, over the runner's one
device): the first feasible candidate is built and every skipped one is
kept as a diagnostic, after the certified rounding-error bound (SASA500,
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
from repro_torch.kernels.ops import resolve_device


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


def _platform_for(device: torch.device | None, platform):
    if platform is not None:
        return platform
    if device is not None and device.type == "cuda":
        return gpu_platform_for(torch.cuda.get_device_name(device))
    return DEFAULT_GPU


def _single_grid_runner(batched):
    """``runner({name: grid})`` -> numpy grid, over a batched runner."""

    def runner(arrays):
        return batched({n: a[None] for n, a in arrays.items()})[0]

    runner.batched = batched
    runner.path = batched.path
    return runner


def _tune(source_or_spec, platform, iterations, device, build,
          keep=None) -> TunedDesign:
    spec_in = (
        source_or_spec if isinstance(source_or_spec, StencilSpec)
        else dsl.parse(source_or_spec)
    )
    lowered = lower(spec_in)
    spec = lowered.spec  # ranking AND executors consume the optimized trees
    dev = resolve_device(device) if build else None
    platform = _platform_for(dev, platform)
    ranking = [
        p for p in model.choose_best(
            spec, platform, iterations=iterations, optimize=False
        )
        if keep is None or keep(p)
    ]
    if not ranking:
        raise RuntimeError(f"no candidate configuration for {spec.name!r}")
    # one device, and every port runner is a batched single-device runner
    verdicts = analysis.preflight(
        spec, [p.config for p in ranking], 1, iterations=iterations,
        batched=True,
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
            spec, feasible[0].config, iterations=iterations, device=dev,
        ))
    return TunedDesign(spec, feasible[0], ranking, runner, lowered.reports,
                       tuple(diags))


def autotune(
    source_or_spec,
    platform: GPUPlatform | None = None,
    iterations: int | None = None,
    device=None,
    build: bool = True,
) -> TunedDesign:
    """The SASA entry point: DSL text (or a spec) -> ranked design + runner.

    ``device`` defaults to ``cuda``; with no device given and no CUDA
    present it raises (pass ``device="cpu"`` for the plain versions).
    ``platform`` defaults to the data-sheet row of the card's SKU.
    """
    return _tune(source_or_spec, platform, iterations, device, build)


def soda_baseline(
    source_or_spec,
    platform: GPUPlatform | None = None,
    iterations: int | None = None,
    device=None,
    build: bool = True,
) -> TunedDesign:
    """State-of-the-art baseline (SODA): temporal parallelism only.

    On one device every candidate is temporal, so this ranks as
    :func:`autotune` does; it is kept for the paper's Sec. 5.4 comparison.
    """
    return _tune(source_or_spec, platform, iterations, device, build,
                 keep=lambda p: p.config.variant == "temporal")
