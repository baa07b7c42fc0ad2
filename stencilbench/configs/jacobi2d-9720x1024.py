"""JACOBI2D at the paper's 9720x1024 (arXiv:2208.10770, Sec. 5.1, Listing 2).

A 5-point Jacobi sweep over a 2-D float32 grid; cells outside the grid
read as zero (the DSL's default boundary).  Nothing is cut from the
source: ``REDUCED`` and ``ASSUMED`` are empty.
"""
import torch
import torch.nn.functional as F

SOURCE = ("https://arxiv.org/abs/2208.10770 Sec. 5.1: JACOBI2D (Listing 2) "
          "at the input size 9720x1024, float32")
REDUCED: list[str] = []
ASSUMED: list[str] = []

# Frozen copy of the paper's Listing 2; the harness fills in the grid, the
# iterations of the traffic mix and the dtype (DTYPE, or the control's).
DSL = """\
kernel: JACOBI2D
iteration: {iterations}
input {dtype}: in_1({shape})
output {dtype}: out_1(0,0) = (in_1(0,1) + in_1(1,0) + in_1(0,0) + in_1(0,-1) + in_1(-1,0)) / 5
"""
SHAPE = (9720, 1024)
# The precision the configuration states, a DSL and torch dtype name.
DTYPE = "float32"
# Each input's values: uniform on [lo, hi).
INPUTS = {"in_1": (0.0, 1.0)}

# Work of one cell update, counted on the expression as written: four
# additions and one division.
OPS_PER_UPDATE = 5
# Per cell and solve: the float32 input read once, the output written once.
BYTES_PER_CELL = 8


def reference(inputs: dict[str, torch.Tensor], iterations: int) -> torch.Tensor:
    """``iterations`` sweeps over a ``(B, rows, cols)`` batch, in the
    inputs' own dtype: each cell becomes the mean of itself and its four
    neighbours, neighbours outside the grid reading zero."""
    x = inputs["in_1"]
    for _ in range(iterations):
        p = F.pad(x, (1, 1, 1, 1))
        x = (p[..., 1:-1, 2:] + p[..., 2:, 1:-1] + p[..., 1:-1, 1:-1]
             + p[..., 1:-1, :-2] + p[..., :-2, 1:-1]) / 5
    return x
