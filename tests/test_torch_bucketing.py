"""The port's shape bucketing against the JAX reference's.

``repro_torch.runtime.bucketing`` is a near-verbatim numpy port of
``repro.runtime.bucketing``.  For every boundary mode the bucket plan must
produce the same streamed spec (same DSL text), margins and service names,
and the host staging (placement, service arrays, batch filler) must be
exactly equal to the reference's on the same numpy inputs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro.configs import stencils as ref_stencils
from repro.core import dsl as ref_dsl
from repro.core.spec import Boundary as RefBoundary
import jax.numpy as jnp
from repro.kernels import ref as ref_oracle
from repro.runtime import bucketing as ref_bucketing

from repro_torch.core import dsl as pt_dsl
from repro_torch.core.autotune import autotune
from repro_torch.core.model import ParallelismConfig
from repro_torch import runtime
from repro_torch.runtime import DesignCache, bucketing

MODES = [RefBoundary("zero"), RefBoundary("constant", 25.0),
         RefBoundary("replicate"), RefBoundary("periodic")]


def _port(ref_spec):
    return pt_dsl.parse(ref_dsl.format_spec(ref_spec))


def _case(name, shape, boundary, iterations=3):
    ref_spec = dataclasses.replace(
        ref_stencils.get(name, shape=shape, iterations=iterations),
        boundary=boundary,
    )
    return ref_spec, _port(ref_spec)


CASES = [("jacobi2d", (20, 14)), ("hotspot", (18, 12)),
         ("heat3d_periodic", (10, 6, 7))]


@pytest.mark.parametrize("boundary", MODES, ids=lambda b: b.kind)
@pytest.mark.parametrize("name,shape", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("wrap_rounds", [None, 2])
def test_bucket_plan_matches_reference(boundary, name, shape, wrap_rounds):
    ref_spec, spec = _case(name, shape, boundary)
    bucket = tuple(n + 9 for n in shape)
    want = ref_bucketing.bucket_plan(ref_spec, bucket, 3, wrap_rounds)
    got = bucketing.bucket_plan(spec, bucket, 3, wrap_rounds)
    assert pt_dsl.format_spec(got.mspec) == ref_dsl.format_spec(want.mspec)
    assert got.mspec.halo_index_inputs == want.mspec.halo_index_inputs
    assert got.mspec.wrap_index_inputs == want.mspec.wrap_index_inputs
    assert got.mspec.wrap_round_depth == want.mspec.wrap_round_depth
    assert got.margins == want.margins
    assert got.service_names == want.service_names
    assert (got.mask_name, got.wrap_rounds) == (want.mask_name, want.wrap_rounds)
    assert got.fill == want.fill
    assert bucketing.padded_request_shape(spec, shape, 3, wrap_rounds) == \
        ref_bucketing.padded_request_shape(ref_spec, shape, 3, wrap_rounds)


@pytest.mark.parametrize("boundary", MODES, ids=lambda b: b.kind)
@pytest.mark.parametrize("name,shape", CASES, ids=[c[0] for c in CASES])
def test_host_staging_matches_reference(boundary, name, shape):
    ref_spec, spec = _case(name, shape, boundary)
    bucket = tuple(n + 9 for n in shape)
    wrap = 2 if boundary.kind == "periodic" else None
    want = ref_bucketing.bucket_plan(ref_spec, bucket, 3, wrap)
    got = bucketing.bucket_plan(spec, bucket, 3, wrap)
    rng = np.random.default_rng(3)
    for cut in (0, 1, 4):
        grid = tuple(max(n - cut, 1) for n in shape)
        for batched in (False, True):
            a = rng.standard_normal(((2,) if batched else ()) + grid)
            a = a.astype(np.float32)
            np.testing.assert_array_equal(
                got.place_entry(a, batched=batched),
                want.place_entry(a, batched=batched),
            )
        svc, ref_svc = got.service_entry(grid), want.service_entry(grid)
        assert svc.keys() == ref_svc.keys()
        for n in svc:
            assert svc[n].dtype == ref_svc[n].dtype
            np.testing.assert_array_equal(svc[n], ref_svc[n])
        assert got.out_index(grid) == want.out_index(grid)
    fill, ref_fill = got.service_filler(), want.service_filler()
    assert fill.keys() == ref_fill.keys()
    for n in fill:
        assert fill[n].dtype == ref_fill[n].dtype
        np.testing.assert_array_equal(fill[n], ref_fill[n])
    for n in spec.inputs:
        np.testing.assert_array_equal(got.filler_entry(n), want.filler_entry(n))


BUCKETERS = [
    dict(),
    dict(min_size=16),
    dict(ladder=((10, 40, 64), (16, 33))),
    dict(ladder=((10240,), (1024, 1088))),
    dict(max_shape=(64, 32)),
    dict(ladder=((8, 48),), max_shape=(32,)),
]
SHAPES = [(3, 2), (20, 13), (33, 16), (40, 33), (64, 32), (70, 5),
          (9720, 1024), (8000, 1050), (12,), (40,), (8, 8, 8)]


@pytest.mark.parametrize("kwargs", BUCKETERS, ids=str)
def test_shape_bucketer_matches_reference(kwargs):
    got = bucketing.ShapeBucketer(**kwargs)
    want = ref_bucketing.ShapeBucketer(**kwargs)
    assert (got.ladder, got.min_size, got.max_shape) == \
        (want.ladder, want.min_size, want.max_shape)
    for shape in SHAPES:
        try:
            expect = want.bucket_for(shape)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e).split(" ")[0]):
                got.bucket_for(shape)
            continue
        assert got.bucket_for(shape) == expect, (kwargs, shape)


def test_unbucketable_division_refused_like_reference():
    text = ("kernel: D\niteration: 1\ninput float: a(8, 8)\n"
            "input float: b(8, 8)\noutput float: out(0, 0) = a(0, 0) / b(0, 1)\n")
    with pytest.raises(ValueError, match="cannot be shape-bucketed"):
        ref_bucketing.masked_spec(ref_dsl.parse(text))
    with pytest.raises(ValueError, match="cannot be shape-bucketed"):
        bucketing.masked_spec(pt_dsl.parse(text))


# ---------------------------------------------------------------------------
# autotune(bucket=...) and devices_needed, ported from the reference's tests
# ---------------------------------------------------------------------------

RNG = np.random.default_rng(17)


def _jacobi2d(shape, iterations):
    return _port(ref_stencils.jacobi2d(shape=shape, iterations=iterations))


def test_autotune_bucket_runner_rejects_unknown_inputs():
    """``tests/test_bucketing.py``: the bucket-aware wrapper must not
    pre-filter a typo'd array name into silence."""
    d = autotune(_jacobi2d((16, 8), 2), cache=DesignCache(), bucket=True,
                 device="cpu")
    x = np.zeros((16, 8), np.float32)
    with pytest.raises(ValueError, match="unknown input"):
        d.runner({"in_1": x, "in_1_typo": x})


def test_autotune_bucket_path_matches_ref_and_shares_designs():
    """``tests/test_bucketing.py``: within 2e-4 of the reference's oracle,
    and a second spec in the same bucket is a pure cache hit."""
    cache = DesignCache()
    iters = 3
    for i, shape in enumerate([(20, 13), (28, 12)]):
        misses = cache.misses
        spec = ref_stencils.jacobi2d(shape=shape, iterations=iters)
        d = autotune(_port(spec), cache=cache, bucket=True, device="cpu")
        if i:
            assert cache.misses == misses
        x = RNG.standard_normal(shape).astype(np.float32)
        want = np.asarray(ref_oracle.stencil_iterations_ref(
            spec, {"in_1": jnp.asarray(x)}, iters))
        np.testing.assert_allclose(np.asarray(d.runner({"in_1": x})), want,
                                   rtol=2e-4, atol=2e-4)


def test_autotune_bucket_requires_cache():
    with pytest.raises(ValueError, match="requires cache"):
        autotune(_jacobi2d((16, 8), 2), bucket=True, device="cpu")


def test_devices_needed():
    """``tests/test_runtime.py::test_devices_needed``."""
    assert runtime.devices_needed(ParallelismConfig("temporal", k=1, s=4)) == 4
    assert runtime.devices_needed(ParallelismConfig("spatial_s", k=8, s=1)) == 8
    assert runtime.devices_needed(ParallelismConfig("hybrid_s", k=2, s=3)) == 2
