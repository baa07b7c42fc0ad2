"""Paper Figs. 10-17: throughput (GCell/s) of each parallelism against the
iteration count, per stencil kernel -- the port's counterpart of
``benchmarks/parallelism_sweep.py``.

Two layers of results per cell:
  * model-projected GCell/s of the best configuration of each variant,
    in place of the reference's TPU-v5e 8-chip slice on one H100
    (``h100x1``: the temporal designs, K1 and K2) and on a pool of four
    (``h100x4``: the row partitions too);
  * measured GCell/s of the single-device fused executor on the device
    given (``ops.stencil_run``: K1 on a card, its plain version on the
    CPU), on the reference's small grids, at the reference's fusion
    depths or, where the tile kernel's shared memory refuses one (JACOBI3D
    at s=16), at the deepest it takes; the row names the depth run.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmarks_torch.common import time_call
from repro_torch.configs import stencils
from repro_torch.core import model
from repro_torch.core.platform import DEFAULT_GPU
from repro_torch.kernels import ops
from repro_torch.kernels.ops import resolve_device
from repro_torch.kernels.ref import torch_dtype

BENCHES = ["jacobi2d", "jacobi3d", "blur", "seidel2d", "dilate", "hotspot",
           "heat3d", "sobel2d"]
ITERS = [1, 2, 4, 8, 16, 32, 64]


def run(device=None):
    dev = resolve_device(device)
    rows = []
    for name in BENCHES:
        shape = (9720, 32, 32) if name in stencils.BENCHMARKS_3D \
            else (9720, 1024)
        cells = float(np.prod(shape))
        for it in ITERS:
            spec = stencils.get(name, shape=shape, iterations=it)
            for tag, gpu in (("h100x1", DEFAULT_GPU),
                             ("h100x4", DEFAULT_GPU.with_gpus(4))):
                best_per_variant = {}
                for p in model.choose_best(spec, gpu):
                    cur = best_per_variant.get(p.config.variant)
                    if cur is None or p.latency < cur.latency:
                        best_per_variant[p.config.variant] = p
                for variant, p in sorted(best_per_variant.items()):
                    gcells = cells * it / p.latency / 1e9
                    rows.append(
                        f"fig10-17/{tag}/{name}/iter{it}/{variant},"
                        f"{p.latency*1e6:.2f},"
                        f"gcells_per_s={gcells:.2f};k={p.config.k};"
                        f"s={p.config.s};buffer_depth={p.config.buffer_depth};"
                        f"bottleneck={p.bottleneck}")
        # measured single-device fused execution (temporal path)
        meas_shape = (486, 64) if name not in stencils.BENCHMARKS_3D \
            else (243, 16, 16)
        for it, s in [(4, 4), (16, 16)]:
            spec = stencils.get(name, shape=meas_shape, iterations=it)
            s = model.smem_fusion_limit(spec, DEFAULT_GPU, cap=s)
            arrays = {n: torch.ones(shp, dtype=torch_dtype(dt), device=dev)
                      for n, (dt, shp) in spec.inputs.items()}
            t = time_call(ops.stencil_run, spec, arrays, it, s=s, device=dev)
            g = np.prod(meas_shape) * it / t / 1e9
            rows.append(
                f"fig10-17/measured/{name}/iter{it}_s{s},{t*1e6:.2f},"
                f"gcells_per_s={g:.3f};shape={'x'.join(map(str, meas_shape))};"
                f"device={dev.type}")
    return rows
