"""The yardstick's arithmetic: the least time of a solve from the stated
counts at the data-sheet peaks, the 95th percentile, and the comparison
(blocked as unblocked, NaN never within a limit)."""
from __future__ import annotations

import math
import statistics

import pytest
import torch

from stencilbench import yardstick


@pytest.mark.parametrize("ops,shape,grids,it,want_s,by", [
    (5, (9720, 1024), 8, 64, 8 * 9720 * 1024 * 64 * 5 / 67e12, "ops"),
    (15, (9720, 32, 32), 8, 64, 8 * 9720 * 1024 * 64 * 15 / 67e12, "ops"),
    (5, (9720, 1024), 32, 1, 32 * 9720 * 1024 * 8 / 3.35e12, "bytes"),
    (15, (9720, 32, 32), 32, 1, 32 * 9720 * 1024 * 8 / 3.35e12, "bytes"),
])
def test_least_time_of_the_cells(ops, shape, grids, it, want_s, by):
    w = yardstick.solve_work(ops, 8, shape, grids, it)
    assert w.cell_updates == grids * math.prod(shape) * it
    assert yardstick.least_time_s(w) == pytest.approx(want_s)
    assert yardstick.least_time_s(w.times(7)) == pytest.approx(7 * want_s)
    other = (w.bytes / yardstick.H100_HBM_BYTES_PER_S if by == "ops"
             else w.flops / yardstick.H100_FP32_FLOPS)
    assert other < want_s


def test_p95_is_the_exclusive_percentile():
    v = [float(i) for i in range(1, 201)]
    assert yardstick.p95(v) == statistics.quantiles(v, n=100)[94]
    assert 190 < yardstick.p95(v) < 191
    assert yardstick.p95([3.0]) == 3.0


def double(inputs, iterations):
    x = inputs["in_1"]
    for _ in range(iterations):
        x = 2 * x
    return x


def test_rel_err_in_blocks_equals_whole_and_nan_is_inf():
    g = torch.Generator().manual_seed(0)
    x = torch.rand((11, 5, 4), generator=g)
    out = (4 * x).float()
    out[7, 2, 1] += 0.25
    whole = yardstick.rel_err(out, {"in_1": x}, double, 2, block=64)
    assert whole == pytest.approx(0.25 / float((4 * x.double()).abs().max()))
    assert yardstick.rel_err(out, {"in_1": x}, double, 2, block=3) == whole
    out[0, 0, 0] = float("nan")
    assert yardstick.rel_err(out, {"in_1": x}, double, 2) == math.inf
