"""HEAT3D at the paper's 9720x32x32 (arXiv:2208.10770, Sec. 5.1).

A 7-point heat-diffusion sweep over a 3-D float32 grid; cells outside the
grid read as zero (the DSL's default boundary).  Nothing is cut from the
source: ``REDUCED`` and ``ASSUMED`` are empty.
"""
import torch
import torch.nn.functional as F

SOURCE = ("https://arxiv.org/abs/2208.10770 Sec. 5.1: HEAT3D at the input "
          "size 9720x32x32, float32")
REDUCED: list[str] = []
ASSUMED: list[str] = []

# Frozen copy of the paper suite's HEAT3D; the harness fills in the grid,
# the iterations of the traffic mix and the dtype (DTYPE, or the
# control's).
DSL = """\
kernel: HEAT3D
iteration: {iterations}
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
# Per cell and solve: the float32 input read once, the output written once.
BYTES_PER_CELL = 8


def reference(inputs: dict[str, torch.Tensor], iterations: int) -> torch.Tensor:
    """``iterations`` sweeps over a ``(B, n0, n1, n2)`` batch, in the
    inputs' own dtype, neighbours outside the grid reading zero."""
    x = inputs["in_1"]
    for _ in range(iterations):
        p = F.pad(x, (1, 1, 1, 1, 1, 1))
        c = p[..., 1:-1, 1:-1, 1:-1]
        x = (0.125 * (p[..., 2:, 1:-1, 1:-1] - 2 * c + p[..., :-2, 1:-1, 1:-1])
             + 0.125 * (p[..., 1:-1, 2:, 1:-1] - 2 * c + p[..., 1:-1, :-2, 1:-1])
             + 0.125 * (p[..., 1:-1, 1:-1, 2:] - 2 * c + p[..., 1:-1, 1:-1, :-2])
             + c)
    return x
