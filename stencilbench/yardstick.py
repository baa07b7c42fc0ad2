"""The yardstick: data-sheet peaks, the work of a solve, its least time,
the comparison that decides ``correct`` and the tail of the solves.

Nothing here reads the program's counters or spec fields: the work comes
from the configuration file's stated counts, so a roofline share is the
same whatever fusion depth, tile or kernel the program uses for it.
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Callable, Mapping, Sequence

import torch

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and float32 outside the
# tensor cores (an FMA counts as two operations), at the 700 W limit.
H100_HBM_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12


@dataclasses.dataclass(frozen=True)
class Work:
    """What a number of solves asks of the card, counted from the
    configuration's stated figures."""

    cell_updates: float
    flops: float
    bytes: float

    def times(self, n: int) -> "Work":
        return Work(self.cell_updates * n, self.flops * n, self.bytes * n)


def solve_work(ops_per_update: int, bytes_per_cell: int,
               shape: Sequence[int], grids: int, iterations: int) -> Work:
    """One solve: ``grids`` grids of ``shape`` advanced ``iterations``
    times; every input read once and the output written once per solve
    (``bytes_per_cell``), ``ops_per_update`` operations per cell update."""
    cells = math.prod(shape) * grids
    updates = cells * iterations
    return Work(float(updates), float(updates * ops_per_update),
                float(cells * bytes_per_cell))


def least_time_s(work: Work) -> float:
    """The least time the card could take: the larger of the bytes at the
    HBM rate and the operations at the float32 rate."""
    return max(work.bytes / H100_HBM_BYTES_PER_S,
               work.flops / H100_FP32_FLOPS)


def rel_err(out: torch.Tensor, inputs: Mapping[str, torch.Tensor],
            reference: Callable[..., torch.Tensor], iterations: int,
            block: int = 8) -> float:
    """``max |out - ref| / max |ref|`` over a whole ``(B,) + grid`` batch,
    the reference worked out again in float64 from ``inputs``, ``block``
    grids at a time so that it fits beside the batch.  NaN anywhere gives
    ``inf``."""
    err = 0.0
    scale = 0.0
    batch = out.shape[0]
    for lo in range(0, batch, block):
        hi = min(lo + block, batch)
        ref = reference(
            {n: a[lo:hi].to(torch.float64) for n, a in inputs.items()},
            iterations,
        )
        got = out[lo:hi].to(torch.float64)
        diff = (got - ref).abs()
        if not bool(torch.isfinite(diff).all()):
            return math.inf
        err = max(err, float(diff.max()))
        scale = max(scale, float(ref.abs().max()))
        del ref, got, diff
    return err / scale if scale > 0 else math.inf


def p95(values: Sequence[float]) -> float:
    """The 95th percentile (``statistics.quantiles``' exclusive method)."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=100)[94]
