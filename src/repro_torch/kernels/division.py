"""How the tile kernel's stage code lowers a division ``x / d``.

The kernel's contract is one float32 rounding per operation, so every
division gives RN(x / d), bitwise what C ``/`` gives under
``-prec-div=true`` (``__fdiv_rn``).  C ``/`` rebuilds the reciprocal of
``d`` at each cell and ends in a range test and a branch to a slow path.
Where ``d`` is a constant (a ``Num``), :func:`lower_division` picks a
shorter sequence with the same result for every float32 ``x``, with
``y = RN(1/d)`` computed exactly on the host:

- ``reciprocal``: ``d = ±2^k`` with ``1/d`` a normal float32.  ``x * y``
  is one rounding of the same real number ``x / d``.
- ``correction``: ``d = ±D``, an odd integer with ``3 <= D < 2^22``.
  ``q0 = RN(x * y)``, ``e = fma(D, q0, -sign(d) x)``, ``e' = fminf(e,
  FLT_MAX)``, ``q = fma(-|y|, e', q0)`` (Markstein's correction).  Since
  ``D`` is an integer, ``D q0`` and ``x`` are multiples of 2^-149, and
  since ``D`` has at most 22 bits, ``e`` is exact: ``e = D q0 - sign(d)
  x``, and ``q0 + |y| (sign(d) x - D q0)`` lies within ``|e| |y - 1/d|``
  of ``x / d``, less than the distance from ``x / d`` to the nearest
  midpoint of float32 values (``D`` odd: ``x / d`` is never one, in the
  subnormal range either).  Written as ``fma(-|y|, e, q0)`` on a
  non-negative ``D`` the sequence keeps the sign of a zero quotient.  For
  ``x = ±inf`` (or NaN) ``e`` is NaN; ``fminf`` returns ``FLT_MAX`` for
  it and the last fma returns ``q0``, which is then ``x`` over ``d``'s
  sign: no branch.
- ``ieee``: any other divisor (an even or fractional constant, whose
  quotient can tie in the subnormal range or whose ``e`` can round, and
  every divisor that is not a ``Num``): C ``/``.

The code generator (:mod:`repro_torch.kernels.cuda_build`) emits what this
rule says and the round plan (:mod:`repro_torch.kernels.tiling`) counts
it.  Nothing here imports torch.
"""
from __future__ import annotations

import math
from fractions import Fraction
from typing import NamedTuple

import numpy as np

from repro_torch.core.spec import BinOp, Expr, Num, walk

# Largest odd divisor the correction takes (exclusive): up to 22 bits
# the correction term is exact and smaller than any midpoint distance.
CORRECTION_LIMIT = 1 << 22


class Division(NamedTuple):
    """The lowering of ``x / divisor``: ``kind`` is ``reciprocal``,
    ``correction`` or ``ieee``; ``reciprocal`` is RN(1/divisor) in
    float32 (``None`` for ``ieee``)."""

    kind: str
    divisor: float | None = None
    reciprocal: float | None = None


IEEE = Division("ieee")


def round_float32(v: Fraction) -> float:
    """RN(v) in float32 (ties to even, subnormals kept, overflow to inf)."""
    if v == 0:
        return 0.0
    sign = -1.0 if v < 0 else 1.0
    v = abs(v)
    e = v.numerator.bit_length() - v.denominator.bit_length()
    if Fraction(2) ** e > v:
        e -= 1
    lsb = max(e, -126) - 23
    m = round(v / Fraction(2) ** lsb)          # half to even
    if m * Fraction(2) ** lsb >= 2**128:
        return sign * float("inf")
    return sign * float(m) * 2.0**lsb


def lower_division(divisor: Expr) -> Division:
    """How the stage code divides by ``divisor`` (module docstring)."""
    if not isinstance(divisor, Num):
        return IEEE
    d = float(np.float32(divisor.value))
    if not np.isfinite(d) or d == 0:
        return IEEE
    y = round_float32(1 / Fraction(d))
    mantissa, _ = np.frexp(abs(d))
    if mantissa == 0.5:
        normal = 2.0**-126 <= abs(y) < math.inf
        return Division("reciprocal", d, y) if normal else IEEE
    if abs(d) < CORRECTION_LIMIT and abs(d) % 2 == 1 and abs(d) >= 3:
        return Division("correction", d, y)
    return IEEE


def division_counts(expr: Expr) -> tuple[int, int]:
    """``(reciprocal, ieee)``: the divisions of one evaluation of ``expr``
    lowered to a reciprocal (either form) and those left as C ``/``."""
    kinds = [lower_division(n.rhs).kind for n in walk(expr)
             if isinstance(n, BinOp) and n.op == "/"]
    ieee = kinds.count("ieee")
    return len(kinds) - ieee, ieee
