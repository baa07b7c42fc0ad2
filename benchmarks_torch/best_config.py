"""Paper Table 3: the best parallelism configuration per benchmark -- the
port's counterpart of ``benchmarks/best_config.py``.

Reported as:
  * FPGA/U280 with the paper's synthesizer PE counts (the pure
    reproduction: matches Table 3 at iteration=64); these rows equal the
    reference's;
  * the reference's TPU-v5e 8-chip rows become the ranker's pick for one
    H100 (``h100x1``) and for a pool of four (``h100x4``), and on a card
    a measured row beside them: the one-card pick run at the paper's size
    (K1 or K2, as the ranker chose), its median ms per grid with the
    inputs on the card.
"""
from __future__ import annotations

import numpy as np

from benchmarks_torch.common import time_call
from repro_torch.configs import stencils
from repro_torch.core import model
from repro_torch.core.ir import lower
from repro_torch.core.platform import DEFAULT_FPGA, DEFAULT_GPU
from repro_torch.kernels import cuda_build
from repro_torch.kernels.ops import resolve_device
from repro_torch.runtime.batching import build_batched_runner

PAPER_PE = {
    "jacobi2d": 21, "jacobi3d": 15, "blur": 12, "seidel2d": 12,
    "dilate": 18, "hotspot": 9, "heat3d": 12, "sobel2d": 12,
}
PAPER_TABLE3 = {   # iter=64 / iter=2 published picks
    "jacobi2d": (("hybrid_s", 3, 7), ("spatial_r", 15, 1)),
    "jacobi3d": (("hybrid_s", 3, 5), ("spatial_r", 15, 1)),
    "blur": (("hybrid_s", 3, 4), ("spatial_r", 12, 1)),
    "seidel2d": (("hybrid_s", 3, 4), ("spatial_r", 12, 1)),
    "dilate": (("hybrid_s", 3, 6), ("hybrid_s", 6, 2)),
    "hotspot": (("hybrid_s", 3, 3), ("spatial_s", 9, 1)),
    "heat3d": (("hybrid_s", 3, 4), ("spatial_r", 12, 1)),
    "sobel2d": (("hybrid_s", 3, 4), ("hybrid_s", 3, 4)),
}


def _design_ms(spec, cfg, dev) -> tuple[float, str]:
    """Median ms of one run of the one-card design ``cfg`` over one grid
    of the lowered ``spec``, inputs staged on ``dev`` once, and the
    runner's path (``single_pe``: K1, ``tile_pipeline``: K2)."""
    run = build_batched_runner(spec, cfg, device=dev)
    rng = np.random.default_rng(0)
    staged = run.stage({
        n: rng.standard_normal((1,) + tuple(shape)).astype(dt)
        for n, (dt, shape) in spec.inputs.items()})
    return time_call(run.dispatch, staged) * 1e3, run.path


def _gpu_row(tag, name, it, best):
    c = best.config
    return (f"table3/{tag}/{name}/iter{it},{best.latency*1e6:.2f},"
            f"variant={c.variant};k={c.k};s={c.s};tile_rows={c.tile_rows};"
            f"buffer_depth={c.buffer_depth};bottleneck={best.bottleneck}")


def run(device=None):
    dev = resolve_device(device)
    rows, measure = [], []
    exact = {64: 0, 2: 0}
    for name, pe in PAPER_PE.items():
        for idx, it in enumerate((64, 2)):
            shape = (9720, 32, 32) if name in stencils.BENCHMARKS_3D \
                else (9720, 1024)
            spec = stencils.get(name, shape=shape, iterations=it)
            best = model.choose_best(spec, DEFAULT_FPGA,
                                     pe_res_override=pe)[0]
            got = (best.config.variant, best.config.k, best.config.s)
            want = PAPER_TABLE3[name][idx]
            exact[it] += got == want
            rows.append(
                f"table3/fpga/{name}/iter{it},{best.latency*1e6:.2f},"
                f"got={got[0]}(k={got[1]}.s={got[2]});"
                f"paper={want[0]}(k={want[1]}.s={want[2]});"
                f"match={got == want}")
            one = model.choose_best(spec, DEFAULT_GPU)[0]
            rows.append(_gpu_row("h100x1", name, it, one))
            rows.append(_gpu_row("h100x4", name, it, model.choose_best(
                spec, DEFAULT_GPU.with_gpus(4))[0]))
            measure.append((name, it, lower(spec).spec, one))
    rows.append(f"table3/summary,0.00,"
                f"exact_match_iter64={exact[64]}/8;"
                f"exact_match_iter2={exact[2]}/8;"
                f"note=iter2 cells are <1pct analytic near-ties decided "
                f"on-board by timing closure (Sec 5.3.6)")
    if dev.type == "cuda":
        cuda_build.build_many([spec for _, _, spec, _ in measure])
        for name, it, spec, pred in measure:
            ms, path = _design_ms(spec, pred.config, dev)
            rows.append(
                f"table3/h100x1_measured/{name}/iter{it},{ms*1e3:.2f},"
                f"path={path};predicted_us={pred.latency*1e6:.2f};"
                f"device={dev.type}")
    return rows
