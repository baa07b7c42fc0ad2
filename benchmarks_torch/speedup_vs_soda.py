"""Paper Sec. 5.4 headline: SASA (the best hybrid/spatial/temporal design)
over SODA (temporal only), averaged across kernels and iteration counts --
the port's counterpart of ``benchmarks/speedup_vs_soda.py``.

Paper: 3.74x average, 15.73x max (JACOBI3D at iteration=1) on U280.  The
same sweep runs on the modelled U280 (rows equal to the reference's) and,
in place of the reference's TPU-v5e 8-chip slice, on one H100 and on a
pool of four.  On one card every candidate is temporal, so SASA's design
space is SODA's and the speedup is 1 by construction.  Then one measured
point on the device given: fused temporal (s=16) against per-iteration
(s=1) on JACOBI2D 972x128, through ``ops.stencil_run`` (K1 on a card, its
plain version on the CPU).
"""
from __future__ import annotations

import numpy as np
import torch

from benchmarks_torch.common import time_call
from repro_torch.configs import stencils
from repro_torch.core import model
from repro_torch.core.platform import DEFAULT_FPGA, DEFAULT_GPU
from repro_torch.kernels import ops
from repro_torch.kernels.ops import resolve_device

PAPER_PE = {
    "jacobi2d": 21, "jacobi3d": 15, "blur": 12, "seidel2d": 12,
    "dilate": 18, "hotspot": 9, "heat3d": 12, "sobel2d": 12,
}
ITERS = [1, 2, 4, 8, 16, 32, 64]


def _sweep(platform, pe_override=None):
    speedups = {}
    for name, pe in PAPER_PE.items():
        shape = (9720, 32, 32) if name in stencils.BENCHMARKS_3D \
            else (9720, 1024)
        for it in ITERS:
            spec = stencils.get(name, shape=shape, iterations=it)
            kw = {"pe_res_override": pe} if pe_override else {}
            ranked = model.choose_best(spec, platform, **kw)
            best = ranked[0]
            temporal = min(
                (p for p in ranked if p.config.variant == "temporal"),
                key=lambda p: p.latency)
            speedups[(name, it)] = temporal.latency / best.latency
    return speedups


def run(device=None):
    dev = resolve_device(device)
    rows = []
    for label, plat, pe in [("fpga_u280", DEFAULT_FPGA, True),
                            ("h100x1", DEFAULT_GPU, False),
                            ("h100x4", DEFAULT_GPU.with_gpus(4), False)]:
        sp = _sweep(plat, pe)
        vals = np.array(list(sp.values()))
        mx = max(sp, key=sp.get)
        rows.append(
            f"sec5.4/speedup_vs_soda/{label},0.00,"
            f"avg={vals.mean():.2f}x;max={vals.max():.2f}x;"
            f"max_at={mx[0]}.iter{mx[1]};paper_avg=3.74x;paper_max=15.73x")
        for name in PAPER_PE:
            per = [sp[(name, it)] for it in ITERS]
            rows.append(
                f"sec5.4/speedup/{label}/{name},0.00,"
                f"avg={np.mean(per):.2f}x;iter1={sp[(name, 1)]:.2f}x;"
                f"iter64={sp[(name, 64)]:.2f}x")
    # measured on the device: fused temporal (s=16) vs per-iteration (s=1)
    spec = stencils.jacobi2d(shape=(972, 128), iterations=16)
    arrays = {"in_1": torch.ones((972, 128), dtype=torch.float32, device=dev)}
    t1 = time_call(ops.stencil_run, spec, arrays, 16, s=1, device=dev)
    t16 = time_call(ops.stencil_run, spec, arrays, 16, s=16, device=dev)
    rows.append(
        f"sec5.4/measured_fusion_speedup/jacobi2d,{t16*1e6:.2f},"
        f"s1_us={t1*1e6:.2f};speedup={t1/t16:.2f}x;device={dev.type}")
    return rows
