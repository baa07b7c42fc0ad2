"""Paper Fig. 1: computation intensity (OPs/byte) per stencil kernel and
against the iteration count (assuming optimal data reuse) -- the port's
counterpart of ``benchmarks/intensity.py``; its rows equal the
reference's.  No device runs: the rows are properties of the specs."""
from __future__ import annotations

from repro_torch.configs import stencils


def run(device=None):
    del device          # analytic rows; the harness passes every module one
    rows = []
    # Fig 1a: per-kernel intensity at iteration = 1
    for name in ["jacobi2d", "jacobi3d", "blur", "seidel2d", "dilate",
                 "hotspot", "heat3d", "sobel2d"]:
        spec = stencils.get(name, iterations=1)
        rows.append(
            f"fig1a/intensity/{name},0.00,"
            f"ops_per_cell={spec.ops_per_cell};points={spec.points};"
            f"intensity={spec.computation_intensity(1):.3f}")
    # Fig 1b: JACOBI2D intensity grows linearly with iterations
    for it in [1, 2, 4, 8, 16, 32, 64]:
        spec = stencils.jacobi2d(iterations=it)
        rows.append(
            f"fig1b/intensity/jacobi2d/iter{it},0.00,"
            f"intensity={spec.computation_intensity(it):.3f}")
    return rows
