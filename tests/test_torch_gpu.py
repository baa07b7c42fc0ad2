"""The port's CUDA tile kernels against their plain versions, on the card.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode).  They import only the port, so they also run where JAX is not
installed::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import stencils
from repro_torch.core.ir import lower
from repro_torch.core.platform import DEFAULT_GPU
from repro_torch.core.spec import Boundary
from repro_torch.kernels import ops, pipeline, stencil
from repro_torch.runtime.bucketing import bucket_plan

RTOL = {"float32": 2e-4, "bfloat16": 2e-2}   # tests/test_kernels.py::tol


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tile kernel has no CPU mode")
    return torch.device("cuda")


def _check(spec, device, seed, tile_rows=(0,)):
    """Kernel vs plain at s up to 8 on the default tile and on each row
    extent of ``tile_rows`` whose block fits in shared memory."""
    rng = np.random.default_rng(seed)
    arrays = {
        n: rng.standard_normal((2,) + tuple(spec.shape)).astype(np.float32)
        for n in spec.inputs
    }
    t = ops.to_device(spec, arrays, device)
    for rows in tile_rows:
        tile = stencil.default_tile(spec.ndim, rows)
        for s in (1, 2, 4, 8):
            if stencil.smem_bytes_estimate(spec, s, tile) > DEFAULT_GPU.smem_per_block:
                continue
            both = pipeline.stencil_cuda_batched(spec, t, s, tile)
            for b in range(2):
                one = {n: a[b] for n, a in t.items()}
                got = stencil.stencil_cuda(spec, one, s, tile)
                want = stencil.stencil_torch_tiled(spec, one, s, tile)
                scale = max(1.0, float(want.float().abs().max()))
                err = float((got.float() - want.float()).abs().max())
                assert err <= RTOL[spec.dtype] * scale, (spec.name, s, tile, err)
                assert torch.equal(both[b], got), (spec.name, s, tile, b)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(stencils.BENCHMARKS))
def test_kernel_matches_plain_on_card(cuda_device, name):
    """Edge blocks only (the small shape), then interior blocks at s = 8
    too, on the default tile and a taller one."""
    three = name in stencils.BENCHMARKS_3D
    for shape in ([(37, 6, 41), (37, 40, 41)] if three
                  else [(70, 45), (200, 150)]):
        _check(lower(stencils.get(name, shape=shape, iterations=4)).spec,
               cuda_device, 11, tile_rows=(0, 16 if three else 64))


@pytest.mark.gpu
def test_constant_boundary_and_bf16_on_card(cuda_device):
    spec = lower(stencils.jacobi2d(shape=(50, 66))).spec
    _check(dataclasses.replace(spec, boundary=Boundary("constant", 1.5)),
           cuda_device, 12)
    bf16 = dataclasses.replace(
        spec,
        inputs={"in_1": ("bfloat16", (50, 66))},
        stages=tuple(dataclasses.replace(st, dtype="bfloat16")
                     for st in spec.stages),
    )
    _check(bf16, cuda_device, 13)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["replicate", "periodic"])
def test_streamed_kernels_match_plain_on_card(cuda_device, kind):
    """Bucket specs with per-entry maps (two real grids and the all-zero
    filler): kernel vs plain per round, K2 bitwise K1 per entry."""
    spec = dataclasses.replace(
        lower(stencils.get("sobel2d_replicate", shape=(70, 45), iterations=4)).spec,
        boundary=Boundary(kind),
    )
    plan = bucket_plan(spec, (90, 70), iterations=4,
                       wrap_rounds=2 if kind == "periodic" else None)
    rng = np.random.default_rng(14)
    entries = []
    for shape in ((70, 45), (61, 40)):
        e = {n: plan.place_entry(rng.standard_normal(shape).astype(np.float32))
             for n in spec.inputs}
        e.update(plan.service_entry(shape))
        entries.append(e)
    e = {n: plan.filler_entry(n) for n in spec.inputs}
    e.update(plan.service_filler())
    entries.append(e)
    mspec = plan.mspec
    t = ops.to_device(mspec, {n: np.stack([x[n] for x in entries])
                              for n in mspec.inputs}, cuda_device)
    for tile in (None, (16, 16)):     # (16, 16): tiles wholly in padding
        for s in (1, 2, 4, 8):
            both = pipeline.stencil_cuda_batched(mspec, t, s, tile)
            for b in range(3):
                one = {n: a[b] for n, a in t.items()}
                got = stencil.stencil_cuda(mspec, one, s, tile)
                want = stencil.stencil_torch_tiled(mspec, one, s, tile)
                scale = max(1.0, float(want.abs().max()))
                assert float((got - want).abs().max()) <= RTOL["float32"] * scale
                assert torch.equal(both[b], got), (kind, s, tile, b)


@pytest.mark.gpu
def test_store_round_trip_on_card(cuda_device, tmp_path, monkeypatch):
    """The store's executable tier in one process with private build
    roots: cold runs ``nvcc`` once and writes one executable entry; a warm
    cache, seeing an empty build root and no loaded library (as a fresh
    process does), builds nothing, loads the library from the store and
    serves a bitwise equal result."""
    from repro_torch.configs import stencils as stock
    from repro_torch.kernels import cuda_build
    from repro_torch.runtime import DesignCache, environment_tag

    def fresh_process(build_root):
        monkeypatch.setattr(cuda_build, "BUILD_ROOT", build_root)
        monkeypatch.setattr(cuda_build, "_LOADED", {})
        monkeypatch.setattr(cuda_build, "_BY_SPEC", {})

    spec = stock.jacobi2d(shape=(200, 150), iterations=4)
    rng = np.random.default_rng(15)
    arrays = {"in_1": rng.standard_normal((2, 200, 150)).astype(np.float32)}
    store = tmp_path / "store"

    fresh_process(tmp_path / "kernels_cold")
    cold = DesignCache(store=str(store))
    out_cold = cold.get_or_build(spec, device=cuda_device).runner(arrays)
    assert cold.autotune_calls == 1 and cold.jit_builds == 1
    entries = list((store / environment_tag() / "executables").glob("*.pkl"))
    assert len(entries) == 1

    fresh_process(tmp_path / "kernels_warm")
    warm = DesignCache(store=str(store))
    cached = warm.get_or_build(spec, device=cuda_device)
    out_warm = cached.runner(arrays)
    assert warm.autotune_calls == 0 and warm.jit_builds == 0
    assert warm.store.stats.executable_hits == 1
    key = cuda_build.kernel_key(cached.design.spec)
    assert (tmp_path / "kernels_warm" / key / "libsasa.so").is_file()
    np.testing.assert_array_equal(out_cold, out_warm)
