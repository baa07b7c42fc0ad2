"""The PyTorch port's executors against the JAX reference's.

On the CPU ``stencil_run(backend="cuda")`` and ``stencil_run_batched`` run
the plain versions of the CUDA tile kernels (the kernels' own tile walk
and boundary rule).  They are held against:

  * the reference's Pallas kernel in interpret mode, on a reduced
    ``tests/test_kernels.py`` matrix (bf16 and ragged shapes included),
    with that file's tolerances;
  * the conformance suite's numpy oracle on its 200 seed-pinned random
    specs, within ``repro.core.numerics.tolerance_for``;
  * each other: the batch-in-grid executor equals the per-entry one
    bitwise.

The kernels themselves run only on the card: ``tests/test_torch_gpu.py``
holds them against these plain versions there and skips elsewhere.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_conformance
from repro.configs import stencils as ref_stencils
from repro.core import dsl as ref_dsl
from repro.core import numerics
from repro.kernels import blockops as ref_blockops
from repro.kernels import ops as ref_ops
from repro.core.spec import Boundary as RefBoundary

from repro_torch.core import dsl as pt_dsl
from repro_torch.core.ir import lower
from repro_torch.core.spec import Boundary
from repro_torch.kernels import blockops, cuda_build, ops, pipeline, stencil

RTOL_F32 = 2e-4   # tests/test_kernels.py::tol
RTOL_BF16 = 3e-2  # tests/test_kernels.py::test_bfloat16_kernel


def _port(ref_spec):
    """The reference spec carried across as DSL text."""
    return pt_dsl.parse(ref_dsl.format_spec(ref_spec))


def _inputs(ref_spec, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {
        n: rng.standard_normal(shape).astype(dtype)
        for n, (_, shape) in ref_spec.inputs.items()
    }


def _pallas(ref_spec, arrays, iters, s, tile_rows=8):
    jarr = {n: jnp.asarray(a, dtype=ref_spec.inputs[n][0]) for n, a in arrays.items()}
    out = ref_ops.stencil_run(
        ref_spec, jarr, iters, s=s, tile_rows=tile_rows, backend="pallas",
        interpret=True,
    )
    return np.asarray(out, dtype=np.float32)


def _cuda_plain(ref_spec, arrays, iters, s, tile=None):
    spec = lower(_port(ref_spec)).spec
    got = ops.stencil_run(
        spec, arrays, iters, s=s, tile=tile, backend="cuda", device="cpu"
    )
    return got.float().numpy()


# --------------------------------------------------------------------------
# Against the reference's Pallas kernel (interpret mode)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(ref_stencils.BENCHMARKS))
@pytest.mark.parametrize("iters,s", [(3, 1), (5, 4)])
def test_cuda_plain_matches_pallas(name, iters, s):
    shape = (24, 6, 6) if name in ref_stencils.BENCHMARKS_3D else (24, 17)
    ref_spec = ref_stencils.get(name, shape=shape, iterations=iters)
    arrays = _inputs(ref_spec, 42)
    want = _pallas(ref_spec, arrays, iters, s)
    tile = (4, 4, 4) if len(shape) == 3 else (8, 8)
    got = _cuda_plain(ref_spec, arrays, iters, s, tile)
    np.testing.assert_allclose(got, want, rtol=RTOL_F32, atol=RTOL_F32)


@pytest.mark.parametrize("name", ["jacobi2d", "hotspot", "dilate", "blur_jacobi2d"])
@pytest.mark.parametrize("shape", [(7, 5), (33, 9), (64, 128)])
def test_cuda_plain_shape_sweep(name, shape):
    ref_spec = ref_stencils.get(name, shape=shape, iterations=2)
    arrays = _inputs(ref_spec, 7)
    want = _pallas(ref_spec, arrays, 2, 2)
    got = _cuda_plain(ref_spec, arrays, 2, 2)
    np.testing.assert_allclose(got, want, rtol=RTOL_F32, atol=RTOL_F32)


@pytest.mark.parametrize(
    "boundary", [RefBoundary("constant", 1.5), RefBoundary("periodic"),
                 RefBoundary("replicate")], ids=lambda b: b.kind,
)
def test_cuda_plain_boundaries_match_pallas(boundary):
    ref_spec = dataclasses.replace(
        ref_stencils.get("blur_jacobi2d", shape=(21, 19), iterations=5),
        boundary=boundary,
    )
    arrays = _inputs(ref_spec, 3)
    want = _pallas(ref_spec, arrays, 5, 2)
    got = _cuda_plain(ref_spec, arrays, 5, 2, tile=(8, 8))
    np.testing.assert_allclose(got, want, rtol=RTOL_F32, atol=RTOL_F32)


BF16_DSL = """
kernel: J2D_BF16
iteration: 2
input bfloat16: x(16, 24)
output bfloat16: y(0,0) = (x(0,1) + x(1,0) + x(0,0) + x(0,-1) + x(-1,0)) / 5
"""


def test_bfloat16_matches_pallas():
    ref_spec = ref_dsl.parse(BF16_DSL)
    x = np.random.default_rng(42).standard_normal((16, 24)).astype(np.float32)
    want = _pallas(ref_spec, {"x": x}, 2, 2)
    got = _cuda_plain(ref_spec, {"x": x}, 2, 2, tile=(8, 8))
    np.testing.assert_allclose(got, want, rtol=RTOL_BF16, atol=RTOL_BF16)


# --------------------------------------------------------------------------
# Against the numpy oracle on the 200 conformance seeds
# --------------------------------------------------------------------------


@pytest.mark.parametrize("block", range(8))
def test_conformance_seeds_within_certified_bound(block):
    for seed in range(block * 25, (block + 1) * 25):
        ref_spec, arrays, iters = test_conformance.random_spec(seed)
        want = test_conformance.numpy_oracle(ref_spec, arrays, iters)
        bound = numerics.tolerance_for(ref_spec, iters, arrays)
        spec = _port(ref_spec)
        low = lower(spec).spec
        runs = {
            "ref": ops.stencil_run(spec, arrays, iters, backend="ref",
                                   device="cpu"),
            "torch": ops.stencil_run(low, arrays, iters, s=2, backend="torch",
                                     device="cpu"),
            "cuda": ops.stencil_run(low, arrays, iters, s=2,
                                    tile=(4,) * spec.ndim, backend="cuda",
                                    device="cpu"),
        }
        for name, got in runs.items():
            diff = float(np.abs(got.numpy() - want).max())
            assert diff <= bound, (
                f"seed {seed} [{name}] {spec.boundary.kind} {spec.shape}: "
                f"{diff:.3g} > certified {bound:.3g}"
            )


# --------------------------------------------------------------------------
# Batch-in-grid vs per entry (bitwise on the CPU)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(0, 40, 5))
def test_batched_matches_per_entry_bitwise(seed):
    ref_spec, arrays, iters = test_conformance.random_spec(seed)
    spec = lower(_port(ref_spec)).spec
    rng = np.random.default_rng(seed + 10_000)
    batch = {
        n: np.stack([a] + [rng.standard_normal(a.shape).astype(a.dtype)
                           for _ in range(2)])
        for n, a in arrays.items()
    }
    t = ops.to_device(spec, batch, "cpu")
    tile = (4,) * spec.ndim
    got = pipeline.stencil_run_batched(spec, t, iters, s=2, tile=tile)
    for b in range(3):
        one = {n: a[b] for n, a in t.items()}
        want = ops.stencil_run(spec, one, iters, s=2, tile=tile,
                               backend="cuda", device="cpu")
        assert torch.equal(got[b], want), f"seed {seed} entry {b}"


# --------------------------------------------------------------------------
# Building blocks
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["zero", "constant", "replicate", "periodic"])
def test_boundary_pad_wider_than_axis(kind):
    """Pads wider than the axis tile again, as jnp.pad/np.pad do."""
    b = Boundary(kind, 1.5 if kind == "constant" else 0.0)
    rb = RefBoundary(kind, b.value)
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    pads = [(7, 5), (9, 2)]
    got = blockops.boundary_pad(torch.from_numpy(a), pads, b).numpy()
    want = np.asarray(ref_blockops.boundary_pad(jnp.asarray(a), pads, rb))
    np.testing.assert_array_equal(got, want)


def test_streamed_halo_fixup_matches_reference():
    """Clamp-map belts agree with the reference's (rows and columns)."""
    rng = np.random.default_rng(5)
    block = rng.standard_normal((9, 11)).astype(np.float32)
    rows = np.clip(np.arange(9) - 3 + 1, 2, 6)
    cols = np.clip(np.arange(11) - 2, 1, 7)
    idx0 = np.broadcast_to(rows[:, None], (9, 11)).astype(np.int32)
    idx1 = np.broadcast_to(cols[None, :], (9, 11)).astype(np.int32)
    ref_spec = ref_dsl.parse(
        "kernel: S\ninput float: a(9, 11)\ninput int: i0(9, 11)\n"
        "input int: i1(9, 11)\niterate: a\noutput float: b(0,0) = a(0,0)\n"
    )
    ref_spec = dataclasses.replace(ref_spec, halo_index_inputs=("i0", "i1"))
    spec = dataclasses.replace(_port(ref_spec), halo_index_inputs=("i0", "i1"))
    row0, col_pad = -1, 2
    want = np.asarray(ref_blockops.streamed_halo_fixup(
        jnp.asarray(block), {"i0": jnp.asarray(idx0), "i1": jnp.asarray(idx1)},
        ref_spec, row0, (col_pad,),
    ))
    got = blockops.streamed_halo_fixup(
        torch.from_numpy(block),
        {"i0": torch.from_numpy(idx0), "i1": torch.from_numpy(idx1)},
        spec, (row0, -col_pad),
    ).numpy()
    np.testing.assert_array_equal(got, want)


def test_wrap_round_fixup_matches_reference():
    rng = np.random.default_rng(6)
    out = rng.standard_normal((2, 7, 8)).astype(np.float32)
    w0 = np.broadcast_to((2 + (np.arange(7) - 2) % 3)[:, None], (7, 8))
    w1 = np.broadcast_to((1 + (np.arange(8) - 1) % 5)[None, :], (7, 8))
    ref_spec = ref_dsl.parse(
        "kernel: W\ninput float: a(7, 8)\ninput int: w0(7, 8)\n"
        "input int: w1(7, 8)\niterate: a\noutput float: b(0,0) = a(0,0)\n"
    )
    ref_spec = dataclasses.replace(
        ref_spec, wrap_index_inputs=("w0", "w1"), wrap_round_depth=1
    )
    spec = dataclasses.replace(
        _port(ref_spec), wrap_index_inputs=("w0", "w1"), wrap_round_depth=1
    )
    env = {"w0": w0.astype(np.int32), "w1": w1.astype(np.int32)}
    for b in range(2):
        want = np.asarray(ref_blockops.wrap_round_fixup(
            jnp.asarray(out[b]), {k: jnp.asarray(v) for k, v in env.items()},
            ref_spec,
        ))
        got = blockops.wrap_round_fixup(
            torch.from_numpy(out), {k: torch.from_numpy(v) for k, v in env.items()},
            spec,
        )[b].numpy()
        np.testing.assert_array_equal(got, want)


def test_plan_blocks_and_smem_estimate():
    spec = lower(_port(ref_stencils.get("hotspot", shape=(9720, 1024)))).spec
    g = stencil.plan_blocks(spec, 4)
    assert g["tile"] == (32, 32) and g["h"] == 4
    assert g["window"] == (40, 40)
    assert g["n_tiles"] == (304, 32) and g["tiles"] == 304 * 32
    # two inputs + the next iterate, as float
    assert stencil.smem_bytes_estimate(spec, 4) == 3 * 40 * 40 * 4
    small = stencil.plan_blocks(lower(_port(
        ref_stencils.get("jacobi2d", shape=(7, 5)))).spec, 2)
    assert small["tile"] == (7, 5)       # clipped to the grid


def test_cuda_kernel_refuses_what_it_cannot_run():
    ref_spec = ref_dsl.parse(
        "kernel: M\ninput float: a(6, 6)\ninput double: b(6, 6)\n"
        "iterate: a\noutput float: c(0,0) = a(0,0) + b(0,0)\n"
    )
    with pytest.raises(NotImplementedError):
        cuda_build.check_supported(_port(ref_spec))
    spec = dataclasses.replace(
        lower(_port(ref_stencils.get("jacobi2d", shape=(6, 6)))).spec,
        wrap_index_inputs=("in_1", "in_1"), wrap_round_depth=1,
    )
    with pytest.raises(NotImplementedError):
        cuda_build.check_supported(spec)


def test_generated_source_is_exact_and_structural():
    spec = lower(_port(ref_stencils.get("hotspot", shape=(64, 64)))).spec
    tu, body = cuda_build.generate(spec)
    assert "#define SASA_N_IN 2" in tu and "#define SASA_ITER 1" in tu
    # 1.296 as its exact float32 value, in hex
    assert f"({float(np.float32(1.296)).hex()}f)" in body
    other = lower(_port(ref_stencils.get("hotspot", shape=(9720, 1024),
                                         iterations=9))).spec
    assert cuda_build.kernel_key(spec) == cuda_build.kernel_key(other)
