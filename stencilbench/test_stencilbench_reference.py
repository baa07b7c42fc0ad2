"""Each configuration's plain reference against a direct loop over the
cells, on small grids: the DSL's expression as written, neighbours outside
the grid reading zero."""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from stencilbench.harness import load_module

CONFIGS = Path(__file__).parent / "configs"


def at(x, *idx):
    """``x[idx]``, or 0 outside the grid."""
    if all(0 <= i < n for i, n in zip(idx, x.shape)):
        return x[idx]
    return 0.0


def jacobi2d_loop(x, iterations):
    for _ in range(iterations):
        y = np.zeros_like(x)
        for i in range(x.shape[0]):
            for j in range(x.shape[1]):
                y[i, j] = (at(x, i, j + 1) + at(x, i + 1, j) + at(x, i, j)
                           + at(x, i, j - 1) + at(x, i - 1, j)) / 5
        x = y
    return x


def heat3d_loop(x, iterations):
    for _ in range(iterations):
        y = np.zeros_like(x)
        for i in range(x.shape[0]):
            for j in range(x.shape[1]):
                for k in range(x.shape[2]):
                    c = x[i, j, k]
                    y[i, j, k] = (
                        0.125 * (at(x, i + 1, j, k) - 2 * c + at(x, i - 1, j, k))
                        + 0.125 * (at(x, i, j + 1, k) - 2 * c + at(x, i, j - 1, k))
                        + 0.125 * (at(x, i, j, k + 1) - 2 * c + at(x, i, j, k - 1))
                        + c)
        x = y
    return x


CASES = [
    ("jacobi2d-9720x1024.py", jacobi2d_loop, (7, 5)),
    ("heat3d-9720x32x32.py", heat3d_loop, (5, 4, 6)),
]


@pytest.mark.parametrize("iterations", [1, 3])
@pytest.mark.parametrize("name,loop,shape", CASES, ids=[c[0] for c in CASES])
def test_reference_matches_a_direct_loop(name, loop, shape, iterations):
    cfg = load_module(CONFIGS / name, f"ref_{name}")
    assert len(cfg.SHAPE) == len(shape) and "boundary:" not in cfg.DSL
    rng = np.random.default_rng(7)
    grids = rng.uniform(0, 1, (2,) + shape)
    got = cfg.reference({"in_1": torch.from_numpy(grids)}, iterations).numpy()
    for b in range(2):
        np.testing.assert_allclose(got[b], loop(grids[b], iterations),
                                   rtol=1e-13, atol=1e-15)

