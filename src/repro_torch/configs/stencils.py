"""The paper's stencil benchmark suite, written in the SASA DSL (Section 5.1).

PyTorch port: the same DSL text as ``repro.configs.stencils``, parsed by
the port's own front end.

Eight kernels: JACOBI2D, JACOBI3D, BLUR, SEIDEL2D, DILATE, HOTSPOT, HEAT3D,
SOBEL2D — plus the two-loop BLUR-JACOBI2D fusion example from Listing 4,
and three non-zero-boundary variants exercising the boundary-condition
machinery end to end (docs/DESIGN.md §Boundary semantics): a periodic
(torus) HEAT3D and replicate-edge BLUR/SOBEL image filters.

Input sizes follow the paper: 2D ∈ {256x256, 720x1024, 9720x1024, 4096x4096},
3D ∈ {256x16x16, 720x32x32, 9720x32x32, 4096x64x64}.  Iterations sweep
1..64 in powers of two.
"""
from __future__ import annotations

from repro_torch.core import dsl
from repro_torch.core.spec import StencilSpec

SIZES_2D = [(256, 256), (720, 1024), (9720, 1024), (4096, 4096)]
SIZES_3D = [(256, 16, 16), (720, 32, 32), (9720, 32, 32), (4096, 64, 64)]
ITERATIONS = [1, 2, 4, 8, 16, 32, 64]


def _fmt_shape(shape):
    return ", ".join(str(s) for s in shape)


def jacobi2d(shape=(9720, 1024), iterations=4) -> StencilSpec:
    """5-point 2D Jacobi (paper Listing 2)."""
    return dsl.parse(f"""
kernel: JACOBI2D
iteration: {iterations}
input float: in_1({_fmt_shape(shape)})
output float: out_1(0,0) = (in_1(0,1) + in_1(1,0) + in_1(0,0) + in_1(0,-1) + in_1(-1,0)) / 5
""")


def jacobi3d(shape=(9720, 32, 32), iterations=4) -> StencilSpec:
    """7-point 3D Jacobi."""
    return dsl.parse(f"""
kernel: JACOBI3D
iteration: {iterations}
input float: in_1({_fmt_shape(shape)})
output float: out_1(0,0,0) = (in_1(0,0,0) + in_1(0,0,1) + in_1(0,0,-1)
    + in_1(0,1,0) + in_1(0,-1,0) + in_1(1,0,0) + in_1(-1,0,0)) / 7
""")


def blur(shape=(9720, 1024), iterations=4) -> StencilSpec:
    """9-point 2D box blur."""
    return dsl.parse(f"""
kernel: BLUR
iteration: {iterations}
input float: in_1({_fmt_shape(shape)})
output float: out_1(0,0) = (in_1(-1,-1) + in_1(-1,0) + in_1(-1,1)
    + in_1(0,-1) + in_1(0,0) + in_1(0,1)
    + in_1(1,-1) + in_1(1,0) + in_1(1,1)) / 9
""")


def seidel2d(shape=(9720, 1024), iterations=4) -> StencilSpec:
    """9-point 2D Seidel-style smoother (Jacobi-ordered as in SODA)."""
    return dsl.parse(f"""
kernel: SEIDEL2D
iteration: {iterations}
input float: in_1({_fmt_shape(shape)})
output float: out_1(0,0) = ((in_1(-1,-1) + in_1(-1,0) + in_1(-1,1))
    + (in_1(0,-1) + in_1(0,0) + in_1(0,1))
    + (in_1(1,-1) + in_1(1,0) + in_1(1,1))) / 9
""")


def dilate(shape=(9720, 1024), iterations=4) -> StencilSpec:
    """13-point morphological dilation (Rodinia leukocyte tracking).

    Pure compare-select logic — no multiplies, so on the FPGA it uses no
    DSPs (paper Fig. 8).
    """
    return dsl.parse(f"""
kernel: DILATE
iteration: {iterations}
input float: in_1({_fmt_shape(shape)})
output float: out_1(0,0) = max(in_1(0,0),
    max(in_1(-1,-1), in_1(-1,0), in_1(-1,1)),
    max(in_1(0,-2), in_1(0,-1), in_1(0,1), in_1(0,2)),
    max(in_1(1,-1), in_1(1,0), in_1(1,1)),
    max(in_1(-2,0), in_1(2,0)))
""")


def hotspot(shape=(9720, 1024), iterations=4) -> StencilSpec:
    """Rodinia HOTSPOT: two inputs (power, temperature), one output.

    ``in_2`` (temperature) is the iterated array; ``in_1`` (power) is
    constant across iterations (paper Listing 3).
    """
    return dsl.parse(f"""
kernel: HOTSPOT
iteration: {iterations}
input float: in_1({_fmt_shape(shape)})
input float: in_2({_fmt_shape(shape)})
iterate: in_2
output float: out_1(0,0) = in_2(0,0) + 1.296 * (
    (in_2(-1,0) + in_2(1,0) - in_2(0,0) - in_2(0,0)) * 0.949219
    + in_1(0,0)
    + (in_2(0,-1) + in_2(0,1) - in_2(0,0) - in_2(0,0)) * 0.010535
    + (80 - in_2(0,0)) * 0.00000514403)
""")


def heat3d(shape=(9720, 32, 32), iterations=4) -> StencilSpec:
    """7-point 3D heat diffusion."""
    return dsl.parse(f"""
kernel: HEAT3D
iteration: {iterations}
input float: in_1({_fmt_shape(shape)})
output float: out_1(0,0,0) = 0.125 * (in_1(1,0,0) - 2 * in_1(0,0,0) + in_1(-1,0,0))
    + 0.125 * (in_1(0,1,0) - 2 * in_1(0,0,0) + in_1(0,-1,0))
    + 0.125 * (in_1(0,0,1) - 2 * in_1(0,0,0) + in_1(0,0,-1))
    + in_1(0,0,0)
""")


def sobel2d(shape=(9720, 1024), iterations=4) -> StencilSpec:
    """9-point Sobel edge filter (|Gx| + |Gy| approximation)."""
    return dsl.parse(f"""
kernel: SOBEL2D
iteration: {iterations}
input float: in_1({_fmt_shape(shape)})
output float: out_1(0,0) = abs(in_1(-1,-1) + 2 * in_1(0,-1) + in_1(1,-1)
        - in_1(-1,1) - 2 * in_1(0,1) - in_1(1,1))
    + abs(in_1(-1,-1) + 2 * in_1(-1,0) + in_1(-1,1)
        - in_1(1,-1) - 2 * in_1(1,0) - in_1(1,1))
""")


def blur_jacobi2d(shape=(9720, 1024), iterations=4) -> StencilSpec:
    """Two fused stencil loops via a ``local`` stage (paper Listing 4)."""
    return dsl.parse(f"""
kernel: BLUR-JACOBI2D
iteration: {iterations}
input float: in({_fmt_shape(shape)})
local float: temp(0,0) = (in(-1,0) + in(-1,1) + in(-1,2) + in(0,0) + in(0,1)
    + in(0,2) + in(1,0) + in(1,1) + in(1,2)) / 9
output float: out(0,0) = (temp(0,1) + temp(1,0) + temp(0,0) + temp(0,-1) + temp(-1,0)) / 5
""")


def heat3d_periodic(shape=(9720, 32, 32), iterations=4) -> StencilSpec:
    """7-point 3D heat diffusion on a torus (periodic boundary).

    The molecular-dynamics / spectral-solver setting: heat leaving one
    face re-enters the opposite one.  Exercises the wrapped halo that the
    CUDA tile kernel folds into its tile load.
    """
    return dsl.parse(f"""
kernel: HEAT3D-PERIODIC
iteration: {iterations}
boundary: periodic
input float: in_1({_fmt_shape(shape)})
output float: out_1(0,0,0) = 0.125 * (in_1(1,0,0) - 2 * in_1(0,0,0) + in_1(-1,0,0))
    + 0.125 * (in_1(0,1,0) - 2 * in_1(0,0,0) + in_1(0,-1,0))
    + 0.125 * (in_1(0,0,1) - 2 * in_1(0,0,0) + in_1(0,0,-1))
    + in_1(0,0,0)
""")


def blur_replicate(shape=(9720, 1024), iterations=4) -> StencilSpec:
    """9-point box blur with clamped (replicate) edges.

    The image-processing convention: edge pixels average a clamped
    neighbourhood instead of darkening toward the zero exterior.
    """
    return dsl.parse(f"""
kernel: BLUR-REPLICATE
iteration: {iterations}
boundary: replicate
input float: in_1({_fmt_shape(shape)})
output float: out_1(0,0) = (in_1(-1,-1) + in_1(-1,0) + in_1(-1,1)
    + in_1(0,-1) + in_1(0,0) + in_1(0,1)
    + in_1(1,-1) + in_1(1,0) + in_1(1,1)) / 9
""")


def sobel2d_replicate(shape=(9720, 1024), iterations=4) -> StencilSpec:
    """Sobel edge filter with clamped edges (no spurious border edges)."""
    return dsl.parse(f"""
kernel: SOBEL2D-REPLICATE
iteration: {iterations}
boundary: replicate
input float: in_1({_fmt_shape(shape)})
output float: out_1(0,0) = abs(in_1(-1,-1) + 2 * in_1(0,-1) + in_1(1,-1)
        - in_1(-1,1) - 2 * in_1(0,1) - in_1(1,1))
    + abs(in_1(-1,-1) + 2 * in_1(-1,0) + in_1(-1,1)
        - in_1(1,-1) - 2 * in_1(1,0) - in_1(1,1))
""")


BENCHMARKS = {
    "jacobi2d": jacobi2d,
    "jacobi3d": jacobi3d,
    "blur": blur,
    "seidel2d": seidel2d,
    "dilate": dilate,
    "hotspot": hotspot,
    "heat3d": heat3d,
    "sobel2d": sobel2d,
    "blur_jacobi2d": blur_jacobi2d,
    "heat3d_periodic": heat3d_periodic,
    "blur_replicate": blur_replicate,
    "sobel2d_replicate": sobel2d_replicate,
}

BENCHMARKS_2D = [
    "jacobi2d", "blur", "seidel2d", "dilate", "hotspot", "sobel2d",
    "blur_jacobi2d", "blur_replicate", "sobel2d_replicate",
]
BENCHMARKS_3D = ["jacobi3d", "heat3d", "heat3d_periodic"]


def get(name: str, shape=None, iterations: int = 4) -> StencilSpec:
    fn = BENCHMARKS[name.lower()]
    if shape is None:
        return fn(iterations=iterations)
    return fn(shape=shape, iterations=iterations)
