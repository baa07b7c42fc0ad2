"""BLUR-JACOBI2D at the paper's 9720x1024 (arXiv:2208.10770, Listing 4).

Two stencil loops fused into one iteration through a ``local`` stage: a
9-point blur whose taps cover rows -1..1 and columns 0..+2 (one-sided),
then a 5-point Jacobi sweep over the blurred grid, in float32.  Cells
outside the grid read as zero (the DSL's default boundary), for the local
stage's ``temp`` as for the input.  Nothing is cut from the source:
``REDUCED`` is empty.
"""
import torch
import torch.nn.functional as F

SOURCE = ("https://arxiv.org/abs/2208.10770 Listing 4: BLUR-JACOBI2D at the "
          "2D input size 9720x1024, float32")
REDUCED: list[str] = []
ASSUMED = ["inputs uniform on [0, 1): the paper states no input data"]

# Frozen copy of the paper's Listing 4; the harness fills in the grid, the
# iterations of the traffic mix and the dtype (DTYPE, or the control's) of
# the input, the local stage and the output alike.
DSL = """\
kernel: BLUR-JACOBI2D
iteration: {iterations}
input {dtype}: in({shape})
local {dtype}: temp(0,0) = (in(-1,0) + in(-1,1) + in(-1,2) + in(0,0) + in(0,1)
    + in(0,2) + in(1,0) + in(1,1) + in(1,2)) / 9
output {dtype}: out(0,0) = (temp(0,1) + temp(1,0) + temp(0,0) + temp(0,-1) + temp(-1,0)) / 5
"""
SHAPE = (9720, 1024)
# The precision the configuration states, a DSL and torch dtype name.
DTYPE = "float32"
# Each input's values: uniform on [lo, hi).
INPUTS = {"in": (0.0, 1.0)}

# Work of one cell update, counted on the expressions as written: the
# blur's eight additions and one division, the Jacobi's four additions and
# one division.
OPS_PER_UPDATE = 14
# Per cell and solve: the float32 input read once, the output written once
# (``temp`` lives only inside an iteration).
BYTES_PER_CELL = 8


def reference(inputs: dict[str, torch.Tensor], iterations: int) -> torch.Tensor:
    """``iterations`` sweeps over a ``(B, rows, cols)`` batch, in the
    inputs' own dtype: each sweep blurs the whole grid into ``temp`` (rows
    -1..1, columns 0..2 of each cell), then takes each cell's mean of
    ``temp`` at itself and its four neighbours; cells outside the grid
    read zero, in the input and in ``temp`` alike."""
    x = inputs["in"]
    for _ in range(iterations):
        p = F.pad(x, (0, 2, 1, 1))
        temp = (p[..., :-2, :-2] + p[..., :-2, 1:-1] + p[..., :-2, 2:]
                + p[..., 1:-1, :-2] + p[..., 1:-1, 1:-1] + p[..., 1:-1, 2:]
                + p[..., 2:, :-2] + p[..., 2:, 1:-1] + p[..., 2:, 2:]) / 9
        q = F.pad(temp, (1, 1, 1, 1))
        x = (q[..., 1:-1, 2:] + q[..., 2:, 1:-1] + q[..., 1:-1, 1:-1]
             + q[..., 1:-1, :-2] + q[..., :-2, 1:-1]) / 5
    return x
