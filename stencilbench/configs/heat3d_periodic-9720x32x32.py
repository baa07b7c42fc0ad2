"""HEAT3D on a torus at the paper's 9720x32x32 (arXiv:2208.10770, Sec. 5.1).

The 7-point heat-diffusion sweep of ``heat3d-9720x32x32.py`` over a 3-D
float32 grid whose faces are joined: a neighbour past one face is the
cell at the opposite face (the periodic boundary).  Nothing is cut from
the source (``REDUCED`` is empty); the paper's listing states no
boundary, so the periodic rule is assumed, as is the input range.
"""
import torch

SOURCE = ("https://arxiv.org/abs/2208.10770 Sec. 5.1: HEAT3D at the input "
          "size 9720x32x32, float32, on a periodic (torus) boundary")
REDUCED: list[str] = []
ASSUMED = [
    "boundary: periodic (the paper's listing states none)",
    "inputs: uniform on [0, 1)",
]

# Frozen copy of the port's HEAT3D-PERIODIC; the harness fills in the
# grid, the iterations of the traffic mix and the dtype (DTYPE, or the
# control's).
DSL = """\
kernel: HEAT3D-PERIODIC
iteration: {iterations}
boundary: periodic
input {dtype}: in_1({shape})
output {dtype}: out_1(0,0,0) = 0.125 * (in_1(1,0,0) - 2 * in_1(0,0,0) + in_1(-1,0,0))
    + 0.125 * (in_1(0,1,0) - 2 * in_1(0,0,0) + in_1(0,-1,0))
    + 0.125 * (in_1(0,0,1) - 2 * in_1(0,0,0) + in_1(0,0,-1))
    + in_1(0,0,0)
"""
SHAPE = (9720, 32, 32)
# The precision the configuration states, a DSL and torch dtype name.
DTYPE = "float32"
# Each input's values: uniform on [lo, hi).
INPUTS = {"in_1": (0.0, 1.0)}

# Work of one cell update, counted on the expression as written: per axis
# a product by 2, a subtraction, an addition and a product by 0.125 (12),
# and three additions joining the four terms.
OPS_PER_UPDATE = 15
# Per cell and solve: the float32 input read once, the output written
# once.  The wrapped halo cells re-read cells of the grid, so they add
# nothing to the least traffic.
BYTES_PER_CELL = 8


def reference(inputs: dict[str, torch.Tensor], iterations: int) -> torch.Tensor:
    """``iterations`` sweeps over a ``(B, n0, n1, n2)`` batch, in the
    inputs' own dtype, each neighbour taken round the torus."""
    x = inputs["in_1"]

    def at(x, d, k):
        # the neighbour at offset k on grid axis d: rolling by -k puts
        # x[i + k] at i
        return torch.roll(x, shifts=-k, dims=1 + d)

    for _ in range(iterations):
        x = (0.125 * (at(x, 0, 1) - 2 * x + at(x, 0, -1))
             + 0.125 * (at(x, 1, 1) - 2 * x + at(x, 1, -1))
             + 0.125 * (at(x, 2, 1) - 2 * x + at(x, 2, -1))
             + x)
    return x
