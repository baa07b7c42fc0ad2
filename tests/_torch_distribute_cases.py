"""Shared cases of the port's multi-device tests (``test_torch_distribute*``).

The case list is ``tests/_multidevice_main.py``'s, run in-process on the
pool ``[torch.device("cpu")] * 8`` (the counterpart of the reference's 8
forced host devices) and held against the reference's numpy oracle
(``test_conformance.numpy_oracle``) at the reference's tolerance.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

import test_conformance
from repro.configs import stencils as ref_stencils
from repro.core import dsl as ref_dsl
from repro.core.spec import Boundary as RefBoundary

from repro_torch.core import dsl as pt_dsl
from repro_torch.core.model import ParallelismConfig

POOL = [torch.device("cpu")] * 8
TOL = 2e-4      # rtol = atol, as tests/_multidevice_main.py::check
BUCKET_TILE = 16   # the pipeline tile the reference's checks pass

# tests/_multidevice_main.py: the stock kernels, ragged rows, 8 configs
STOCK_CASES = [
    (bench, shape, iters)
    for bench in ["jacobi2d", "hotspot", "dilate", "blur_jacobi2d"]
    for shape, iters in [((96, 20), 4), ((70, 13), 6)]
] + [(bench, (64, 6, 6), 4) for bench in ["heat3d", "jacobi3d"]]
STOCK_CFGS = [
    ParallelismConfig("spatial_s", k=4, s=1),
    ParallelismConfig("spatial_s", k=8, s=1),
    ParallelismConfig("spatial_r", k=2, s=1),
    ParallelismConfig("hybrid_s", k=4, s=2),
    ParallelismConfig("hybrid_s", k=2, s=3),
    ParallelismConfig("hybrid_r", k=2, s=2),
    ParallelismConfig("temporal", k=1, s=4),
    ParallelismConfig("temporal", k=1, s=3),  # iter not divisible
]
BOUNDARY_CFGS = [
    ParallelismConfig("spatial_s", k=8, s=1),   # per-iter ring exchange
    ParallelismConfig("spatial_s", k=4, s=1),
    ParallelismConfig("spatial_r", k=2, s=1),
    ParallelismConfig("hybrid_s", k=4, s=2),    # s*r ring per round
    ParallelismConfig("hybrid_r", k=2, s=2),
    ParallelismConfig("temporal", k=1, s=4),
]
BOUNDARIES = [
    RefBoundary("constant", 1.5), RefBoundary("replicate"),
    RefBoundary("periodic"),
]
BATCHED_CFGS = [
    ParallelismConfig("spatial_s", k=4, s=1),
    ParallelismConfig("spatial_r", k=2, s=1),
    ParallelismConfig("hybrid_s", k=4, s=2),
    ParallelismConfig("hybrid_r", k=2, s=2),
    ParallelismConfig("temporal", k=1, s=4),
]


def ref_spec(bench, shape, iters, boundary=None):
    spec = ref_stencils.get(bench, shape=shape, iterations=iters)
    return spec if boundary is None else dataclasses.replace(
        spec, boundary=boundary
    )


def port(spec):
    """The port's spec of a reference spec (through the DSL text)."""
    return pt_dsl.parse(ref_dsl.format_spec(spec))


def fits(cfg, shape, iters, radius) -> bool:
    """The reference's skip: ``*_r`` needs ``iter*r <= rows/device``."""
    if cfg.variant in ("spatial_r", "hybrid_r"):
        return iters * radius <= -(-shape[0] // cfg.k)
    return True


def inputs(spec, batch=None, seed=7):
    rng = np.random.default_rng(seed)
    return {
        n: rng.standard_normal(
            tuple(shp) if batch is None else (batch,) + tuple(shp)
        ).astype(dt)
        for n, (dt, shp) in spec.inputs.items()
    }


def oracle(spec, arrays, iters, b=None):
    """The reference's numpy oracle on one grid (entry ``b`` of a batch)."""
    one = arrays if b is None else {n: a[b] for n, a in arrays.items()}
    return test_conformance.numpy_oracle(spec, one, iters)


def assert_close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


def cfg_id(cfg) -> str:
    return f"{cfg.variant}-k{cfg.k}-s{cfg.s}"
