"""Bucketed serving over shard runners, against the reference's oracle,
on the pool ``[torch.device("cpu")] * 8``.

The bucketed part of ``tests/_multidevice_main.py``:
``build_bucket_runner`` over the shard runner for zero, constant,
replicate and periodic specs.  Replicate's int32 halo-index maps travel
with the rows like every other input; periodic serves from the wide
``iterations * radius`` margin (the shard runner refuses wrap maps).
Every grid within rtol = atol = 2e-4 of the oracle, including ragged
shapes and one whose real edge lands on a shard boundary, and the result
bitwise invariant across bucket rungs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from _torch_distribute_cases import (
    BATCHED_CFGS,
    BOUNDARY_CFGS,
    BUCKET_TILE,
    POOL,
    assert_close,
    cfg_id,
    inputs,
    oracle,
    port,
    ref_spec,
)
from repro.core.spec import Boundary as RefBoundary

from repro_torch.core import distribute
from repro_torch.core.model import ParallelismConfig
from repro_torch.runtime.batching import build_bucket_runner
from repro_torch.runtime.bucketing import bucket_spec, padded_request_shape

B = 2


def serve(spec_ref, bucket, cfg, iters=4):
    """One batch of B grids through the bucket runner; each entry held
    against the oracle.  Returns the output batch.  A temporal design
    runs its pipeline over the pool as the bucket runner's inner runner
    (the batched runner would fuse it on one device)."""
    spec = port(spec_ref)
    arrays = inputs(spec, batch=B)
    cfg = dataclasses.replace(cfg, tile_rows=BUCKET_TILE)
    inner = None
    if cfg.variant == "temporal":
        inner = distribute.build_runner(
            bucket_spec(spec, bucket), cfg, iterations=iters,
            devices=POOL[:cfg.devices_needed], tile_rows=BUCKET_TILE,
            batched=True,
        )
    run = build_bucket_runner(
        spec, bucket, cfg, iterations=iters, devices=POOL, inner=inner,
    )
    assert run.path == "shard_map" and run.wrap_rounds is None
    got = run(arrays)
    assert got.shape == (B,) + tuple(spec.shape)
    for b in range(B):
        assert_close(got[b], oracle(spec_ref, arrays, iters, b),
                     f"bucketed {spec.name} {cfg} grid {b}")
    return got


@pytest.mark.parametrize("cfg", BATCHED_CFGS, ids=cfg_id)
@pytest.mark.parametrize("bench", ["jacobi2d", "hotspot"])
def test_zero_boundary_bucket(bench, cfg):
    """A design built for a padded bucket, with the streamed mask woven
    into every stage, on rows that do not divide the pool."""
    serve(ref_spec(bench, (70, 13), 4), (96, 20), cfg)


HALO_CASES = [
    ("jacobi2d", (70, 13), (96, 24)),
    ("jacobi2d", (48, 13), (96, 24)),    # edge on the k=4 boundary
    ("hotspot", (70, 13), (96, 24)),
    ("heat3d", (40, 6, 6), (64, 16, 16)),
]


@pytest.mark.parametrize("cfg", BOUNDARY_CFGS, ids=cfg_id)
@pytest.mark.parametrize(
    "bench,shape,bucket", HALO_CASES,
    ids=[f"{b}-{'x'.join(map(str, s))}" for b, s, _ in HALO_CASES],
)
@pytest.mark.parametrize("kind", ["replicate", "periodic"])
def test_halo_streamed_bucket(kind, bench, shape, bucket, cfg):
    spec_ref = ref_spec(bench, shape, 4, RefBoundary(kind))
    need = padded_request_shape(port(spec_ref), shape, 4)
    assert all(n <= b for n, b in zip(need, bucket)), (need, bucket)
    serve(spec_ref, bucket, cfg)


@pytest.mark.parametrize("kind", ["replicate", "periodic"])
def test_bucket_rungs_bitwise(kind):
    """The minimal-fit streamed design and a wider rung agree exactly on
    a multi-device config."""
    spec = port(ref_spec("jacobi2d", (70, 13), 4, RefBoundary(kind)))
    arrays = inputs(spec, batch=B)
    cfg = ParallelismConfig("spatial_s", k=4, s=1)
    minimal = padded_request_shape(spec, (70, 13), 4)
    # round rows up so every rung shares the k=4 row sharding geometry
    minimal = (-(-minimal[0] // 4) * 4,) + tuple(minimal[1:])
    base = build_bucket_runner(spec, minimal, cfg, iterations=4,
                               devices=POOL)(arrays)
    wide = build_bucket_runner(spec, (96, 24), cfg, iterations=4,
                               devices=POOL)(arrays)
    np.testing.assert_array_equal(base, wide, err_msg=f"rungs {kind}")


@pytest.mark.parametrize("cfg", [
    ParallelismConfig("spatial_s", k=8, s=1),
    ParallelismConfig("hybrid_s", k=4, s=2),
], ids=cfg_id)
@pytest.mark.parametrize("bench,shape,bucket", [
    ("heat3d_periodic", (40, 6, 6), (64, 16, 16)),
    ("blur_replicate", (70, 13), (96, 24)),
    ("sobel2d_replicate", (70, 13), (96, 24)),
])
def test_stock_bucketed(bench, shape, bucket, cfg):
    serve(ref_spec(bench, shape, 4), bucket, cfg)


@pytest.mark.parametrize("cfg", [
    ParallelismConfig("spatial_s", k=4, s=1),
    ParallelismConfig("hybrid_s", k=4, s=2),
    ParallelismConfig("temporal", k=1, s=4),
], ids=cfg_id)
def test_constant_boundary_bucket(cfg):
    """mask + offset and the margin fill of a constant boundary."""
    serve(ref_spec("jacobi2d", (70, 13), 4, RefBoundary("constant", 1.5)),
          (96, 20), cfg)
