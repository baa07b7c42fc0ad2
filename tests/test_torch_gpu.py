"""The port's CUDA tile kernels against their plain versions, on the card.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode).  They import only the port, so they also run where JAX is not
installed::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
from __future__ import annotations

import ctypes
import dataclasses
import subprocess
from fractions import Fraction

import numpy as np
import pytest
import torch

from repro_torch.configs import stencils
from repro_torch.core import dsl, numerics
from repro_torch.core.ir import lower
from repro_torch.core.platform import DEFAULT_GPU
from repro_torch.core.spec import Boundary, Num
from repro_torch.kernels import (
    cuda_build, division, ops, pipeline, ref, stencil, tiling,
)
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
        tile = tiling.default_tile(spec.ndim, rows)
        for s in (1, 2, 4, 8):
            if tiling.smem_bytes_estimate(spec, s, tile) > DEFAULT_GPU.smem_per_block:
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


# HEAT3D grids whose rows span the 16x8x32 tile's 32 cells, and 30 (not a
# multiple of 4): every window overhangs both ends of its row, and the
# blocks of the middle z and y tiles overhang nothing else.
EDGE_ROWS_3D = [(40, 24, 32), (40, 24, 30)]


@pytest.mark.gpu
@pytest.mark.parametrize("name, boundary", [
    *(pytest.param(n, None, id=n) for n in stencils.BENCHMARKS),
    *(pytest.param("heat3d", b, id=f"heat3d-rows-{b}")
      for b in ("zero", "constant", "replicate", "periodic")),
])
def test_kernel_matches_plain_on_card(cuda_device, name, boundary):
    """Edge blocks only (the small shape), then interior blocks at s = 8
    too, on the default tile and a taller one.  With a boundary: the
    ``EDGE_ROWS_3D`` grids under that rule (s = 1, 2, 4 on 16x8x32, up to
    8 on the default tile)."""
    three = name in stencils.BENCHMARKS_3D
    if boundary is not None:
        shapes = EDGE_ROWS_3D
    elif three:
        shapes = [(37, 6, 41), (37, 40, 41)]
    else:
        shapes = [(70, 45), (200, 150)]
    for shape in shapes:
        spec = lower(stencils.get(name, shape=shape, iterations=4)).spec
        if boundary is not None:
            spec = dataclasses.replace(spec, boundary=Boundary(
                boundary, 1.5 if boundary == "constant" else 0.0))
        _check(spec, cuda_device, 11, tile_rows=(0, 16 if three else 64))


BOUNDARIES = ("zero", "constant", "replicate", "periodic")
# Every stock kernel under its own rule, and the benchmark's three under
# each rule; bfloat16 JACOBI2D and HEAT3D.
STRIP_CASES = [
    *((n, None, "float32") for n in stencils.BENCHMARKS),
    *((n, b, "float32") for n in ("jacobi2d", "blur_jacobi2d", "heat3d")
      for b in BOUNDARIES),
    ("jacobi2d", None, "bfloat16"), ("heat3d", None, "bfloat16"),
]


# Rows of 45 or 41 cells take the row copies; 48 or 40 cells make rows of
# whole 16-byte units, where float32 windows take the tensor copy.
STRIP_GRIDS = {"rows-odd": ((70, 45), (37, 20, 41)),
               "rows-16-byte": ((70, 48), (37, 20, 40))}


def _strip_spec(name, boundary, dtype, grid="rows-odd"):
    three = name in stencils.BENCHMARKS_3D
    spec = lower(stencils.get(name, shape=STRIP_GRIDS[grid][three],
                              iterations=4)).spec
    if boundary is not None:
        spec = dataclasses.replace(spec, boundary=Boundary(
            boundary, 1.5 if boundary == "constant" else 0.0))
    if dtype != "float32":
        spec = dataclasses.replace(
            spec,
            inputs={n: (dtype, sh) for n, (_, sh) in spec.inputs.items()},
            stages=tuple(dataclasses.replace(st, dtype=dtype)
                         for st in spec.stages),
        )
    return spec


@pytest.fixture(scope="module")
def strip_kernels():
    """Builds every kernel of ``STRIP_CASES`` at once (nvcc in parallel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tile kernel has no CPU mode")
    cuda_build.build_many([_strip_spec(*c) for c in STRIP_CASES])


@pytest.mark.gpu
@pytest.mark.parametrize("grid", list(STRIP_GRIDS))
@pytest.mark.parametrize("name, boundary, dtype", STRIP_CASES,
                         ids=["-".join(str(x) for x in c) for c in STRIP_CASES])
def test_strip_walk_is_bitwise_the_plain_version_on_card(
        cuda_device, strip_kernels, name, boundary, dtype, grid):
    """K2 against the plain version (``blockops.fused_iterations_on_block``
    on the CPU), bitwise, at s = 1, 2, 8.  2-D on 13x64 tiles (walk
    extents 13 + 2e: a short strip in every column) and the default tile;
    3-D on 5x8x32 tiles (one short strip a column, edge blocks on every
    axis) and the default tile; a grid of 70x45 or 37x20x41 (row copies)
    or 70x48 or 37x20x40 (float32: the tensor copy, but in periodic edge
    blocks, here all) leaves partial tiles at every far edge.  The
    launches count the windows of the tensor copy on ``.windows_tma``."""
    spec = _strip_spec(name, boundary, dtype, grid)
    rng = np.random.default_rng(16)
    arrays = {
        n: torch.from_numpy(rng.standard_normal((2,) + tuple(spec.shape))
                            .astype(np.float32)).to(getattr(torch, dtype))
        for n in spec.inputs
    }
    on_card = {n: a.to(cuda_device) for n, a in arrays.items()}
    three = spec.ndim == 3
    copied = 0
    for tile in ((5, 8, 32) if three else (13, 64),
                 tiling.default_tile(spec.ndim)):
        for s in (1, 2, 8):
            if tiling.smem_bytes_estimate(spec, s, tile) > DEFAULT_GPU.smem_per_block:
                continue
            before = stencil.launch_tile_kernel.windows_tma
            got = pipeline.stencil_cuda_batched(spec, on_card, s, tile).cpu()
            moved = stencil.launch_tile_kernel.windows_tma - before
            plan = tiling.round_plan(spec, s, tuple(tile))
            assert moved == 2 * tiling.tma_windows(spec, plan), (s, tile)
            copied += moved
            want = stencil.tiled_round(spec, arrays, s, tile)
            assert torch.equal(got, want), (spec.name, boundary, s, tile)
    assert (copied > 0) == (grid == "rows-16-byte" and dtype == "float32"
                            and spec.boundary.kind != "periodic")


# A 1-D spec: the kernel walks its stages cell by cell.
LINE5 = """kernel: LINE5
iteration: 4
input float: in_1(300)
output float: out_1(0) = (in_1(-2) + in_1(-1) + in_1(0) + in_1(1) + in_1(2)) / 5
"""


@pytest.mark.gpu
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_a_1d_spec_takes_the_flat_walk_on_card(cuda_device, boundary):
    spec = dataclasses.replace(lower(dsl.parse(LINE5)).spec, boundary=Boundary(
        boundary, 1.5 if boundary == "constant" else 0.0))
    rng = np.random.default_rng(17)
    arrays = {"in_1": torch.from_numpy(
        rng.standard_normal((2, 300)).astype(np.float32))}
    on_card = {n: a.to(cuda_device) for n, a in arrays.items()}
    for tile in ((64,), (256,)):
        for s in (1, 2, 8):
            got = pipeline.stencil_cuda_batched(spec, on_card, s, tile).cpu()
            want = stencil.tiled_round(spec, arrays, s, tile)
            assert torch.equal(got, want), (boundary, s, tile)


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
    # (16, 16): tiles wholly in padding; (13, 20): short strips too
    for tile in (None, (16, 16), (13, 20)):
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
def test_periodic_heat3d_at_the_benchmarks_pick_on_card(cuda_device):
    """HEAT3D on a torus as the benchmark's periodic cell runs it (B = 8,
    s = 2, 16x8x32 tiles; every block wraps its halo), on a 64x32x32
    grid: 16 iterations on the card against the plain version within the
    certified bound, and one launch adds B times the plan's wrapped cells
    to ``.wrapped_cells``."""
    B, s, tile, iterations = 8, 2, (16, 8, 32), 16
    spec = lower(stencils.heat3d_periodic((64, 32, 32),
                                          iterations=iterations)).spec
    plan = tiling.round_plan(spec, s, tile)
    assert plan.edge_tiles == plan.tiles and plan.wrapped > 0
    rng = np.random.default_rng(18)
    x = torch.from_numpy(rng.uniform(0, 1, (B, 64, 32, 32)).astype(np.float32))
    on_card = {"in_1": x.to(cuda_device)}
    before = stencil.launch_tile_kernel.wrapped_cells
    pipeline.stencil_cuda_batched(spec, on_card, s, tile)
    assert stencil.launch_tile_kernel.wrapped_cells - before == B * plan.wrapped
    got = pipeline.stencil_run_batched(spec, on_card, iterations, s=s,
                                       tile=tile).cpu()
    want = pipeline.stencil_run_batched(spec, {"in_1": x}, iterations, s=s,
                                        tile=tile)
    for b in range(B):
        bound = numerics.tolerance_for(spec, iterations, {"in_1": x[b].numpy()})
        err = float((got[b].double() - want[b].double()).abs().max())
        assert err <= bound, (b, err, bound)


# Listing 3 with Rodinia's coefficients at 720x1024 and clamped edges, as
# the benchmark's HOTSPOT configuration states it
# (stencilbench/configs/hotspot-720x1024.py).
HOTSPOT_720 = """kernel: HOTSPOT
iteration: 16
boundary: replicate
input float: in_1(720, 1024)
input float: in_2(720, 1024)
iterate: in_2
output float: out_1(0,0) = in_2(0,0) + 0.096 * (
    (in_2(-1,0) + in_2(1,0) - in_2(0,0) - in_2(0,0)) * 0.0703125
    + in_1(0,0)
    + (in_2(0,-1) + in_2(0,1) - in_2(0,0) - in_2(0,0)) * 0.142222222
    + (80 - in_2(0,0)) * 0.0000694444444)
"""


@pytest.mark.gpu
def test_replicate_hotspot_at_the_benchmarks_pick_on_card(cuda_device):
    """HOTSPOT with clamped edges as the benchmark's cell runs it: 720x1024
    on 64x64 tiles at s = 8 (52 of 192 blocks edge blocks, two windows a
    block, the power window held through every fused iteration), every
    window by the tensor copy.  B = 2: one round bitwise the plain version,
    adding B times the plan's windows to ``.windows_tma`` and its fixup
    count to ``.fixup_cells``; K1 on one grid bitwise K2; 16 iterations
    against the float64 oracle (``kernels/ref.py``) within the certified
    bound."""
    B, s, tile, iterations = 2, 8, (64, 64), 16
    spec = lower(dsl.parse(HOTSPOT_720)).spec
    plan = tiling.round_plan(spec, s, tile)
    assert plan.tma and (plan.tiles, plan.edge_tiles) == (192, 52)
    rng = np.random.default_rng(20)
    arrays = {n: torch.from_numpy(rng.uniform(0, 1, (B, 720, 1024))
                                  .astype(np.float32)) for n in spec.inputs}
    on_card = {n: a.to(cuda_device) for n, a in arrays.items()}
    f = stencil.launch_tile_kernel
    before = (f.windows_tma, f.fixup_cells)
    both = pipeline.stencil_cuda_batched(spec, on_card, s, tile)
    assert (f.windows_tma - before[0], f.fixup_cells - before[1]) == (
        B * plan.windows, B * tiling.fixup_cells(spec, plan, True))
    assert torch.equal(both.cpu(), stencil.tiled_round(spec, arrays, s, tile))
    one = {n: a[0] for n, a in on_card.items()}
    assert torch.equal(stencil.stencil_cuda(spec, one, s, tile), both[0])
    got = pipeline.stencil_run_batched(spec, on_card, iterations, s=s,
                                       tile=tile).cpu()
    f64 = dataclasses.replace(
        spec, inputs={n: ("float64", shp) for n, (_, shp) in spec.inputs.items()},
        stages=tuple(dataclasses.replace(st, dtype="float64")
                     for st in spec.stages))
    want = ref.stencil_iterations_ref(
        f64, {n: a.double() for n, a in arrays.items()}, iterations)
    for b in range(B):
        bound = numerics.tolerance_for(
            spec, iterations, {n: a[b].numpy() for n, a in arrays.items()})
        err = float((got[b].double() - want[b]).abs().max())
        assert err <= bound, (b, err, bound)


@pytest.mark.gpu
@pytest.mark.parametrize("name, shape, s, tile", [
    ("heat3d_periodic", (40, 24, 96), 1, (8, 8, 32)),
    ("heat3d_periodic", (40, 24, 96), 2, (8, 8, 32)),
    ("jacobi2d", (400, 256), 1, (128, 64)),
    ("jacobi2d", (256, 200), 3, (64, 64)),
])
def test_periodic_interior_blocks_take_the_tensor_copy_on_card(
        cuda_device, name, shape, s, tile):
    """Under the periodic rule the blocks inside the grid take the tensor
    copy while the edge blocks copy rows and wrap, with every window
    ``(-h) mod 4`` floats into its buffer: bitwise the plain version, and
    ``.windows_tma`` grows by the interior blocks' windows alone."""
    spec = dataclasses.replace(lower(stencils.get(name, shape=shape)).spec,
                               boundary=Boundary("periodic"))
    plan = tiling.round_plan(spec, s, tile)
    assert 0 < plan.tiles - plan.edge_tiles < plan.tiles and plan.h % 4
    rng = np.random.default_rng(19)
    x = torch.from_numpy(rng.standard_normal((3,) + shape).astype(np.float32))
    before = stencil.launch_tile_kernel.windows_tma
    got = pipeline.stencil_cuda_batched(spec, {"in_1": x.to(cuda_device)},
                                        s, tile).cpu()
    assert (stencil.launch_tile_kernel.windows_tma - before
            == 3 * (plan.tiles - plan.edge_tiles))
    assert torch.equal(got, stencil.tiled_round(spec, {"in_1": x}, s, tile))


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


# Divisors whose sequence the exhaustive test runs: the rule admits the
# odd integers and refuses the even and fractional ones
# (``kernels/division.py``).
DIVISORS = [3.0, 5.0, 6.0, 7.0, 9.0, 10.0, 25.0, 1.5, 0.3, -5.0]
ADMITTED = {3.0, 5.0, 7.0, 9.0, 25.0, -5.0}

_DIVISION_MAIN = r"""
#include <cuda_runtime.h>
#include <math.h>

__global__ void sasa_count(int which, unsigned long long* bad,
                           unsigned int* first) {
  unsigned long long n = 0;
  unsigned int lo = 0xFFFFFFFFu;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x
           + threadIdx.x; i < (1ull << 32);
       i += (unsigned long long)gridDim.x * blockDim.x) {
    const float x = __uint_as_float((unsigned int)i);
    float got = 0.0f, want = 0.0f;
    switch (which) {
SASA_CASES
    }
    if (__float_as_uint(got) != __float_as_uint(want)
        && !(isnan(got) && isnan(want))) {
      ++n;
      lo = min(lo, (unsigned int)i);
    }
  }
  if (n) {
    atomicAdd(bad, n);
    atomicMin(first, lo);
  }
}

extern "C" int sasa_count_all(int which, unsigned long long* bad,
                              unsigned int* first) {
  unsigned long long* d_bad;
  unsigned int* d_first;
  cudaMalloc(&d_bad, sizeof *d_bad);
  cudaMalloc(&d_first, sizeof *d_first);
  cudaMemset(d_bad, 0, sizeof *d_bad);
  cudaMemset(d_first, 0xFF, sizeof *d_first);
  sasa_count<<<132 * 16, 256>>>(which, d_bad, d_first);
  cudaMemcpy(bad, d_bad, sizeof *bad, cudaMemcpyDeviceToHost);
  cudaMemcpy(first, d_first, sizeof *first, cudaMemcpyDeviceToHost);
  cudaFree(d_bad);
  cudaFree(d_first);
  return (int)cudaGetLastError();
}
"""


def _division_case(which, how, d) -> str:
    """One ``case`` of the counting kernel: the stage code the generator
    emits for ``x / d`` lowered as ``how``, against ``__fdiv_rn``."""
    em = cuda_build._Emitter({})
    lit = cuda_build.float_literal(d)
    result = em.divide("x", lit, how)
    return "\n".join([
        f"    case {which}: {{", *("  " + ln for ln in em.lines),
        f"      got = {result};", f"      want = __fdiv_rn(x, {lit});",
        "      break;", "    }"])


@pytest.fixture(scope="module")
def fdiv_mismatches(tmp_path_factory):
    """Mismatches and the first mismatching bit pattern over all 2^32
    float32 ``x``, per divisor: of the emitted lowering, and of the
    correction sequence forced on every divisor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    cases, index = [], {}
    for d in DIVISORS:
        how = division.lower_division(Num(d))
        forced = division.Division(
            "correction", d, division.round_float32(1 / Fraction(d)))
        for label, h in (("emitted", how), ("forced", forced)):
            index[(d, label)] = len(cases)
            cases.append(_division_case(len(cases), h, d))
    work = tmp_path_factory.mktemp("division")
    (work / "division.cu").write_text(
        _DIVISION_MAIN.replace("SASA_CASES", "\n".join(cases)))
    so = work / "libdivision.so"
    proc = subprocess.run(
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
         str(work / "division.cu"), "-o", str(so)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    assert proc.returncode == 0, proc.stdout
    fn = ctypes.CDLL(str(so)).sasa_count_all
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong),
                   ctypes.POINTER(ctypes.c_uint)]
    fn.restype = ctypes.c_int
    counts = {}
    for key, which in index.items():
        bad, first = ctypes.c_ulonglong(), ctypes.c_uint()
        assert fn(which, ctypes.byref(bad), ctypes.byref(first)) == 0
        counts[key] = (bad.value, first.value)
    return counts


@pytest.mark.gpu
@pytest.mark.parametrize("d", DIVISORS)
def test_emitted_division_equals_fdiv_rn_for_every_float(
        cuda_device, fdiv_mismatches, d):
    """Over all 2^32 bit patterns of ``x``, built with ``NVCC_FLAGS``: the
    stage code for ``x / d`` equals ``__fdiv_rn(x, d)`` bitwise (NaN
    equals NaN), for the divisors the rule admits (the correction
    sequence) and for those it refuses (C ``/``).  The forced sequence's
    count on a refused divisor is printed: what the rule guards against."""
    kind = division.lower_division(Num(d)).kind
    assert kind == ("correction" if d in ADMITTED else "ieee")
    bad, first = fdiv_mismatches[(d, "emitted")]
    assert bad == 0, (d, hex(first))
    forced, first = fdiv_mismatches[(d, "forced")]
    if d in ADMITTED:
        assert forced == 0
    print(f"divisor {d}: forced correction mismatches {forced}"
          + (f", first 0x{first:08x}" if forced else ""))
