"""HOTSPOT at the paper's 720x1024 (arXiv:2208.10770, Sec. 5.1, Listing 3).

Rodinia's chip thermal simulator (``hotspot.cu``, ``compute_tran_temp``):
a 0.016 m square chip cut into a 2-D float32 grid, whose temperature
``in_2`` steps under a power map ``in_1`` that no iteration changes.  The
listing's constants are Rodinia's for a 9720x1024 grid; at 720x1024 the
same formulas give the ones below (:func:`coefficients`).  The listing
states no boundary: Rodinia clamps each neighbour to the grid (adiabatic
chip edges), the replicate rule.  Nothing is cut from the source
(``REDUCED`` is empty).
"""
import math

import torch
import torch.nn.functional as F

SOURCE = ("https://arxiv.org/abs/2208.10770 Sec. 5.1, Listing 3: HOTSPOT at "
          "720x1024, float32; the listing's constants carried to that size "
          "by Rodinia compute_tran_temp's size law; replicate (clamped) "
          "edges")
REDUCED: list[str] = []
ASSUMED = [
    "boundary: replicate (Rodinia clamps each neighbour to the grid; the "
    "listing states no boundary)",
    "step/Cap: the listing's 1.296 at 9720x1024, carried to 720x1024 by "
    "the formula's rows * cols scaling",
    "amb_temp: 80, as the listing writes it",
    "inputs: power and temperature uniform on [0, 1)",
]

# Rodinia's chip: side in metres, K_SI and t_chip.
CHIP_SIDE = 0.016
K_SI = 100.0
T_CHIP = 0.0005
# The listing's step / Cap at 9720x1024, a tenth of Rodinia's
# PRECISION / (MAX_PD * gh * gw) there; it grows as rows * cols.
LISTING_STEP_CAP = 1.296


def _decimal(x: float, digits: int = 9) -> str:
    """``x`` to ``digits`` significant digits, in plain decimal notation."""
    places = max(digits - 1 - math.floor(math.log10(abs(x))), 0)
    return f"{x:.{places}f}".rstrip("0").rstrip(".")


def coefficients(rows: int, cols: int) -> dict[str, str]:
    """Rodinia's coefficients for the chip cut into ``rows x cols`` cells,
    as decimal literals: ``step_cap`` (step / Cap), ``ry`` (1/Ry, on the
    rows' neighbours), ``rx`` (1/Rx, on the columns') and ``rz`` (1/Rz,
    towards the ambient).  With ``gh = side / rows`` and ``gw = side /
    cols``: ``Ry = gh / (2 K_SI t_chip gw)``, ``Rx = gw / (2 K_SI t_chip
    gh)``, ``Rz = t_chip / (K_SI gh gw)``."""
    gh, gw = CHIP_SIDE / rows, CHIP_SIDE / cols
    return {
        "step_cap": _decimal(LISTING_STEP_CAP * rows * cols / (9720 * 1024)),
        "ry": _decimal(2 * K_SI * T_CHIP * gw / gh),
        "rx": _decimal(2 * K_SI * T_CHIP * gh / gw),
        "rz": _decimal(K_SI * gh * gw / T_CHIP),
    }


# The coefficients of the paper's 720x1024, kept on a smaller grid.
C = coefficients(720, 1024)
AMB_TEMP = "80"

# Listing 3 with Rodinia's coefficients at 720x1024; the harness fills in
# the grid, the iterations of the traffic mix and the dtype (DTYPE, or the
# control's).
DSL = f"""\
kernel: HOTSPOT
iteration: {{iterations}}
boundary: replicate
input {{dtype}}: in_1({{shape}})
input {{dtype}}: in_2({{shape}})
iterate: in_2
output {{dtype}}: out_1(0,0) = in_2(0,0) + {C["step_cap"]} * (
    (in_2(-1,0) + in_2(1,0) - in_2(0,0) - in_2(0,0)) * {C["ry"]}
    + in_1(0,0)
    + (in_2(0,-1) + in_2(0,1) - in_2(0,0) - in_2(0,0)) * {C["rx"]}
    + ({AMB_TEMP} - in_2(0,0)) * {C["rz"]})
"""
SHAPE = (720, 1024)
# The precision the configuration states, a DSL and torch dtype name.
DTYPE = "float32"
# Each input's values: uniform on [lo, hi).  in_1 is the power map, in_2
# the temperature the solve steps.
INPUTS = {"in_1": (0.0, 1.0), "in_2": (0.0, 1.0)}

# Work of one cell update, counted on the expression as written: per axis
# an addition, two subtractions and a product (8); the ambient term's
# subtraction and product (2); three additions joining the four terms
# inside the bracket, the product by step / Cap and the final addition.
OPS_PER_UPDATE = 15
# Per cell and solve: the float32 power and temperature read once, the
# temperature written once.
BYTES_PER_CELL = 12


def reference(inputs: dict[str, torch.Tensor], iterations: int) -> torch.Tensor:
    """``iterations`` steps of the temperature over a ``(B, rows, cols)``
    batch, in the inputs' own dtype, each neighbour clamped to the grid."""
    power, t = inputs["in_1"], inputs["in_2"]
    step_cap, ry, rx, rz = (float(C[k]) for k in ("step_cap", "ry", "rx", "rz"))
    amb = float(AMB_TEMP)
    for _ in range(iterations):
        p = F.pad(t, (1, 1, 1, 1), mode="replicate")
        north, south = p[..., :-2, 1:-1], p[..., 2:, 1:-1]
        west, east = p[..., 1:-1, :-2], p[..., 1:-1, 2:]
        t = t + step_cap * ((north + south - t - t) * ry + power
                            + (west + east - t - t) * rx + (amb - t) * rz)
    return t
