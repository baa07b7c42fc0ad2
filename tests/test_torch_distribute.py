"""The port's multi-device runners (``repro_torch.core.distribute``) against
the JAX package, on the in-process pool ``[torch.device("cpu")] * 8``.

The stock-kernel part of ``tests/_multidevice_main.py`` (every variant,
ragged rows, a fusion depth that does not divide the iterations), the
non-zero-boundary stock kernels, the ragged periodic refusal and batched
runners; every result within rtol = atol = 2e-4 of the reference's numpy
oracle, as the reference's own checks hold its runners.  The refusals
match the reference's ``build_runner`` in type and wording, and batched
entries are bitwise equal to single-grid runs of the same shard runner.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_distribute_cases import (
    BATCHED_CFGS,
    POOL,
    STOCK_CASES,
    STOCK_CFGS,
    assert_close,
    cfg_id,
    fits,
    inputs,
    oracle,
    port,
    ref_spec,
)
from repro.core import distribute as ref_distribute
from repro.core.model import ParallelismConfig as RefConfig
from repro.core.spec import Boundary as RefBoundary
from repro.runtime.bucketing import masked_spec as ref_masked_spec

from repro_torch.core import distribute
from repro_torch.core.model import ParallelismConfig
from repro_torch.runtime.batching import build_batched_runner


def check(spec_ref, cfg, iters, arrays=None, what=""):
    spec = port(spec_ref)
    arrays = inputs(spec) if arrays is None else arrays
    run = distribute.build_runner(
        spec, cfg, iterations=iters, devices=POOL[:cfg.devices_needed],
        tile_rows=16,
    )
    assert (run.path, run.backend) == ("shard_map", "torch")
    got = run(arrays)
    assert got.shape == tuple(spec.shape)
    assert_close(got, oracle(spec_ref, arrays, iters), what)
    return run


@pytest.mark.parametrize("cfg", STOCK_CFGS, ids=cfg_id)
@pytest.mark.parametrize(
    "bench,shape,iters", STOCK_CASES,
    ids=[f"{b}-{'x'.join(map(str, s))}-it{i}" for b, s, i in STOCK_CASES],
)
def test_stock_kernels_match_oracle(bench, shape, iters, cfg):
    spec_ref = ref_spec(bench, shape, iters)
    if not fits(cfg, shape, iters, spec_ref.radius):
        pytest.skip("the reference skips *_r with iter*r > rows/device")
    run = check(spec_ref, cfg, iters, what=f"{bench}{shape} {cfg}")
    if cfg.variant != "temporal":
        # spatial shards exchange real rows; the reference's R_pad
        assert run.R_pad == -(-shape[0] // cfg.k) * cfg.k
        assert run.halo_bytes > 0


@pytest.mark.parametrize("boundary", [
    RefBoundary("constant", 2.0), RefBoundary("replicate"),
], ids=["constant", "replicate"])
def test_ragged_rows_are_exact(boundary):
    """70 rows over k=4: a padded last shard, still exact."""
    spec_ref = ref_spec("jacobi2d", (70, 13), 4, boundary)
    check(spec_ref, ParallelismConfig("spatial_s", k=4, s=1), 4,
          what=f"ragged {boundary.kind}")


@pytest.mark.parametrize("bench,shape", [
    ("heat3d_periodic", (64, 6, 6)),
    ("blur_replicate", (96, 20)),
    ("sobel2d_replicate", (96, 20)),
])
@pytest.mark.parametrize("cfg", [
    ParallelismConfig("spatial_s", k=8, s=1),
    ParallelismConfig("hybrid_s", k=4, s=2),
], ids=cfg_id)
def test_nonzero_boundary_stock_kernels(bench, shape, cfg):
    check(ref_spec(bench, shape, 4), cfg, 4, what=f"stock {bench} {cfg}")


def _refusal(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def _ref_refusal(spec_ref, cfg, k, iters):
    return _refusal(lambda: ref_distribute.build_runner(
        spec_ref, RefConfig(cfg.variant, k=cfg.k, s=cfg.s),
        iterations=iters, devices=list(jax.devices()) * k, tile_rows=16,
    ))


REFUSALS = {
    # (reference spec, config, iterations)
    "ragged-periodic": (
        ref_spec("jacobi2d", (70, 13), 4, RefBoundary("periodic")),
        ParallelismConfig("spatial_s", k=4), 4,
    ),
    "halo-spans-neighbours": (
        ref_spec("jacobi2d", (16, 8), 3),
        ParallelismConfig("spatial_r", k=8), 3,
    ),
    "replicate-empty-shard": (
        ref_spec("jacobi2d", (4, 8), 3, RefBoundary("replicate")),
        ParallelismConfig("spatial_s", k=8), 3,
    ),
    "wrap-margins": (
        ref_masked_spec(
            ref_spec("jacobi2d", (16, 8), 2, RefBoundary("periodic")),
            wrap_rounds=1,
        ),
        ParallelismConfig("spatial_s", k=2), 2,
    ),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_match_reference_wording(case):
    """Every refusal of the reference's ``build_runner`` is the port's,
    with the same type and message (the reference on a repeated-device
    pool of the same size)."""
    spec_ref, cfg, iters = REFUSALS[case]
    if case == "wrap-margins":
        from repro_torch.runtime.bucketing import masked_spec

        spec = masked_spec(
            port(ref_spec("jacobi2d", (16, 8), 2, RefBoundary("periodic"))),
            wrap_rounds=1,
        )
    else:
        spec = port(spec_ref)
    got = _refusal(lambda: distribute.build_runner(
        spec, cfg, iterations=iters, devices=POOL[:cfg.k], tile_rows=16,
    ))
    assert got == _ref_refusal(spec_ref, cfg, cfg.k, iters)
    if case == "ragged-periodic":
        assert "wraparound" in got


def test_exchange_halo_edges_and_ring():
    """Edge shards receive zeros, the ring closes 0 <-> k-1, a pool of
    one wraps to its own opposite edge, and only rows that change shard
    count as moved bytes."""
    mesh = distribute.Mesh(POOL[:3], ndim=2)
    shards = [torch.full((2, 3), float(i + 1)) for i in range(3)]
    open_ = distribute.exchange_halo(shards, 1, mesh)
    assert float(open_[0][0].abs().sum()) == 0.0       # top edge: zeros
    assert float(open_[2][1].abs().sum()) == 0.0       # bottom edge: zeros
    assert torch.equal(open_[1][0], shards[0][-1:])
    assert torch.equal(open_[1][1], shards[2][:1])
    assert mesh.moved_bytes == 4 * 3 * 4               # 4 rows of 3 floats
    ring = distribute.exchange_halo(shards, 1, mesh, wrap=True)
    assert torch.equal(ring[0][0], shards[2][-1:])
    assert torch.equal(ring[2][1], shards[0][:1])
    one = distribute.Mesh(POOL[:1], ndim=2)
    up, down = distribute.exchange_halo(shards[:1], 1, one, wrap=True)[0]
    assert torch.equal(up, shards[0][-1:]) and torch.equal(down, shards[0][:1])
    zeros = distribute.exchange_halo(shards[:1], 1, one)[0][0]
    assert zeros.shape == (1, 3) and float(zeros.abs().sum()) == 0.0
    assert one.moved_bytes == 0
    ext = distribute._extend(shards, 2, mesh, wrap=True)
    assert [e.shape for e in ext] == [(6, 3)] * 3


@pytest.mark.parametrize("cfg", BATCHED_CFGS, ids=cfg_id)
def test_batched_runner_matches_oracle_and_single_grids(cfg):
    """B independent grids through one shard dispatch: each entry within
    tolerance of the oracle, and bitwise equal to a single-grid run of
    the same shard runner (no coupling across the batch axis).  The
    batched runner takes a temporal design to the tile kernel on the
    pool's first device; its pipeline over the pool is the shard
    runner's own batched mode."""
    B = 3
    spec_ref = ref_spec("jacobi2d", (96, 20), 4)
    spec = port(spec_ref)
    xb = inputs(spec, batch=B)
    tiled = dataclasses.replace(cfg, tile_rows=16)
    run = build_batched_runner(spec, tiled, iterations=4, devices=POOL)
    assert not run.degraded
    if cfg.variant == "temporal":
        assert (run.path, run.n_devices) == ("single_pe", 1)
        fused = run(xb)
        for b in range(B):
            assert_close(fused[b], oracle(spec_ref, xb, 4, b), f"fused {b}")
        run = distribute.build_runner(
            spec, tiled, iterations=4, devices=POOL[:cfg.devices_needed],
            tile_rows=16, batched=True,
        )
    assert run.path == "shard_map" and run.n_devices == cfg.devices_needed
    got = run(xb)
    assert got.shape == (B, 96, 20)
    single = distribute.build_runner(
        spec, tiled, iterations=4, devices=POOL[:cfg.devices_needed],
        tile_rows=16,
    )
    for b in range(B):
        assert_close(got[b], oracle(spec_ref, xb, 4, b), f"batched {cfg} {b}")
        np.testing.assert_array_equal(got[b], single({"in_1": xb["in_1"][b]}))


def test_batch_tile_chunks_bitwise():
    """cfg.batch_tile runs a larger batch in sequential chunks: the same
    bits as the whole batch at once."""
    spec = port(ref_spec("hotspot", (64, 12), 3))
    xb = inputs(spec, batch=4)
    cfg = ParallelismConfig("hybrid_s", k=4, s=2)
    whole = distribute.build_runner(spec, cfg, devices=POOL[:4], batched=True)
    chunked = distribute.build_runner(
        spec, dataclasses.replace(cfg, batch_tile=2), devices=POOL[:4],
        batched=True,
    )
    np.testing.assert_array_equal(chunked(xb), whole(xb))


def test_dispatch_phases_and_halo_bytes():
    """stage / dispatch / ready / finalize compose to run(); the halo
    bytes are the reference's collective bytes for spatial_s: 2 halos of
    r rows per inner shard boundary per iteration, counted once per
    receiving shard."""
    spec = port(ref_spec("jacobi2d", (64, 10), 3))
    x = inputs(spec)
    run = distribute.build_runner(
        spec, ParallelismConfig("spatial_s", k=4), devices=POOL[:4],
    )
    pending = run.dispatch(run.stage(x))
    assert run.ready(pending)
    out = run.finalize(pending)
    np.testing.assert_array_equal(out, run(x))
    # 3 iterations x 3 inner boundaries x 2 directions x 1 row x 10 floats
    assert run.halo_bytes == 3 * 3 * 2 * 10 * 4
    assert run.devices == POOL[:4] and run.mesh.k == 4
