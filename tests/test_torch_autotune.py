"""The PyTorch port's ranking and end-to-end autotune against the reference.

  * The paper-exact FPGA model (Part 1 of ``core/model.py``) ranks every
    stock kernel exactly as the reference does.
  * ``autotune(dsl, device="cpu")`` builds a runner through the port's
    batched runner (the CUDA kernels' plain versions on the CPU) that
    agrees with the numpy oracle within ``tolerance_for``.
  * With no device given and no CUDA present, ``autotune`` raises.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import test_conformance
from repro.configs import stencils as ref_stencils
from repro.core import dsl as ref_dsl
from repro.core import model as ref_model
from repro.core import numerics
from repro.core.platform import DEFAULT_FPGA as REF_FPGA
from repro.core.platform import DEFAULT_TPU as REF_TPU

from repro_torch.core import dsl as pt_dsl
from repro_torch.core import model
from repro_torch.core.autotune import autotune, soda_baseline
from repro_torch.core.model import ParallelismConfig
from repro_torch.core.platform import DEFAULT_FPGA, DEFAULT_GPU, H100_PCIE, gpu_platform_for
from repro_torch.kernels import ops, tiling
from repro_torch.runtime import DesignCache, ShapeBucketer
from repro_torch.runtime.batching import (
    DegradedDesignWarning,
    build_batched_runner,
)
from repro_torch.serve import StencilServer


def _port(ref_spec):
    return pt_dsl.parse(ref_dsl.format_spec(ref_spec))


def _ranked(preds):
    return [
        (p.config.variant, p.config.k, p.config.s, p.latency, p.hbm_bytes)
        for p in preds
    ]


@pytest.mark.parametrize("name", list(ref_stencils.BENCHMARKS))
def test_fpga_ranking_matches_reference(name):
    ref_spec = ref_stencils.get(name, iterations=16)
    want = ref_model.choose_best(ref_spec, REF_FPGA)
    got = model.choose_best(_port(ref_spec), DEFAULT_FPGA)
    assert _ranked(got) == _ranked(want)


@pytest.mark.parametrize("name", list(ref_stencils.BENCHMARKS))
def test_gpu_candidates_fit_shared_memory(name):
    spec = _port(ref_stencils.get(name, iterations=64))
    preds = model.choose_best(spec, DEFAULT_GPU)
    assert preds and all(p.config.variant == "temporal" for p in preds)
    assert {p.config.buffer_depth for p in preds} == {0, 2}
    for p in preds:
        assert p.smem_bytes <= DEFAULT_GPU.smem_per_block
        assert p.latency >= max(p.compute_term, p.memory_term) > 0
    s_max = model.smem_fusion_limit(spec, DEFAULT_GPU)
    assert tiling.smem_bytes_estimate(spec, s_max) <= DEFAULT_GPU.smem_per_block
    assert tiling.smem_bytes_estimate(spec, s_max + 1) > DEFAULT_GPU.smem_per_block


def test_gpu_platform_rows():
    assert gpu_platform_for("NVIDIA H100 80GB HBM3") is DEFAULT_GPU
    assert gpu_platform_for("NVIDIA H100 PCIe") is H100_PCIE
    assert DEFAULT_GPU.smem_per_block == 232_448
    assert DEFAULT_GPU.l2_bytes == 50 * 2**20


F6_KERNELS = ["jacobi2d", "heat3d", "hotspot", "blur_jacobi2d", "sobel2d"]


@pytest.mark.parametrize("name", F6_KERNELS)
def test_one_card_ranks_k2_first_at_paper_sizes(name):
    """At the paper's sizes the reference's one-chip ranking puts its
    batched kernel (``buffer_depth=2``) first; so does the port's one-card
    ranking, which prices K2's launch once per micro-batch."""
    ref_spec = ref_stencils.get(name)
    want = ref_model.choose_best(ref_spec, REF_TPU.with_chips(1))[0]
    got = model.choose_best(_port(ref_spec), DEFAULT_GPU)[0]
    assert want.config.buffer_depth == 2 and want.config.batch_tile == 8
    assert got.config.buffer_depth == 2 and got.config.batch_tile == 8
    assert got.config.variant == "temporal" and got.config.k == 1


@pytest.mark.parametrize("name", F6_KERNELS)
def test_k1_and_k2_no_longer_price_equal(name):
    """K1 and K2 of the same depth and tile do the same work; K2 pays a
    grid's share (1/batch_tile) of one launch a round, K1 a whole one."""
    spec = _port(ref_stencils.get(name))
    by_cfg = {}
    for c in model.gpu_candidate_configs(spec, DEFAULT_GPU):
        by_cfg.setdefault((c.s, c.tile_rows), {})[c.buffer_depth] = (
            model.predict_gpu(spec, c, DEFAULT_GPU))
    assert by_cfg
    for pair in by_cfg.values():
        k1, k2 = pair[0], pair[2]
        assert k2.config.batch_tile == 8
        assert (k1.compute_term, k1.memory_term) == (k2.compute_term,
                                                     k2.memory_term)
        saved = k1.rounds * DEFAULT_GPU.launch_s * (1 - 1 / 8)
        assert k1.latency - k2.latency == pytest.approx(saved, rel=1e-9)


def test_bucketed_paper_size_registration_routes_through_k2():
    """A bucketed server on the CPU, registered at the paper's JACOBI2D
    size, routes a paper-size request to a K2 bucket design (the route
    only: the grid is not run)."""
    spec = _port(ref_stencils.get("jacobi2d", iterations=16))
    srv = StencilServer(device="cpu", max_batch=4, cache=DesignCache(),
                        bucketing=ShapeBucketer(ladder=((10240,), (1024, 1088))),
                        warmup=False)
    reg = srv.register("jacobi2d", spec)
    entry = reg.cached.runner_for((9720, 1024), count=0)
    assert entry.config.buffer_depth == 2
    assert entry.runner.path == "tile_pipeline"


CASES = [
    ("jacobi2d", (20, 13), 5),
    ("hotspot", (17, 21), 4),
    ("blur_jacobi2d", (19, 16), 3),
    ("sobel2d_replicate", (18, 12), 3),
    ("heat3d_periodic", (9, 6, 7), 3),
]


@pytest.mark.parametrize("name,shape,iters", CASES)
def test_autotune_runner_matches_oracle(name, shape, iters):
    ref_spec = ref_stencils.get(name, shape=shape, iterations=iters)
    rng = np.random.default_rng(1)
    arrays = {
        n: rng.standard_normal(shape).astype(np.float32)
        for n in ref_spec.inputs
    }
    want = test_conformance.numpy_oracle(ref_spec, arrays, iters)
    bound = numerics.tolerance_for(ref_spec, iters, arrays)
    design = autotune(ref_dsl.format_spec(ref_spec), device="cpu")
    # K2 pays a grid's share of one launch a micro-batch, so on one card
    # it ranks ahead of K1 at the same depth and tile at every size
    assert design.runner.path == "tile_pipeline"
    # the certified bound, and no skipped candidate on one device
    assert [d.code for d in design.diagnostics] == ["SASA500"]
    got = design.runner(arrays)
    assert got.shape == shape and np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= bound


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 17, 42])
def test_autotune_random_specs_match_oracle(seed):
    ref_spec, arrays, iters = test_conformance.random_spec(seed)
    want = test_conformance.numpy_oracle(ref_spec, arrays, iters)
    bound = numerics.tolerance_for(ref_spec, iters, arrays)
    design = autotune(_port(ref_spec), device="cpu")
    got = design.runner(arrays)
    assert float(np.abs(got - want).max()) <= bound


def test_autotune_without_device_raises_when_cuda_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        autotune(ref_dsl.format_spec(ref_stencils.jacobi2d(shape=(8, 8))))
    spec = _port(ref_stencils.jacobi2d(shape=(8, 8)))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_batched_runner(spec, ParallelismConfig("temporal"))
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.stencil_run(spec, {"in_1": np.zeros((8, 8), np.float32)})
    # ranking alone needs no device
    assert autotune(spec, build=False).runner is None


def test_batched_runner_paths_agree_bitwise():
    spec = _port(ref_stencils.hotspot(shape=(21, 18), iterations=5))
    rng = np.random.default_rng(9)
    batch = {
        n: rng.standard_normal((4, 21, 18)).astype(np.float32)
        for n in spec.inputs
    }
    k2 = build_batched_runner(
        spec, ParallelismConfig("temporal", s=2, buffer_depth=2, tile_rows=8),
        device="cpu",
    )
    k1 = build_batched_runner(
        spec, ParallelismConfig("temporal", s=2, tile_rows=8), device="cpu",
    )
    assert (k2.path, k1.path) == ("tile_pipeline", "single_pe")
    assert k1.tile == k2.tile == (8, 64)
    assert k1.backend == k2.backend == "plain"
    pending = k2.dispatch(k2.stage(batch))
    assert k2.ready(pending)
    np.testing.assert_array_equal(k2.finalize(pending), k1(batch))
    with pytest.raises(ValueError, match="unknown input"):
        k1({**batch, "typo": batch["in_1"]})
    # a multi-device config on a one-device pool degrades, as the
    # reference's does: it warns and runs the single-device kernel
    with pytest.warns(DegradedDesignWarning, match="needs 2 device"):
        degraded = build_batched_runner(
            spec, ParallelismConfig("spatial_s", k=2), device="cpu"
        )
    assert (degraded.degraded, degraded.n_devices) == (True, 1)
    assert degraded.path == "single_pe"


def test_soda_baseline_is_temporal():
    spec = _port(ref_stencils.jacobi2d(shape=(16, 16), iterations=4))
    design = soda_baseline(spec, device="cpu")
    assert design.config.variant == "temporal"
    x = np.random.default_rng(0).standard_normal((16, 16)).astype(np.float32)
    assert design.runner({"in_1": x}).shape == (16, 16)
