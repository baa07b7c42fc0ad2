"""The PyTorch port's executors against the JAX reference's.

On the CPU ``stencil_run(backend="cuda")`` and ``stencil_run_batched`` run
the plain versions of the CUDA tile kernels (the kernels' own tile walk
and boundary rule).  They are held against:

  * the reference's Pallas kernel in interpret mode, on a reduced
    ``tests/test_kernels.py`` matrix (bf16 and ragged shapes included),
    with that file's tolerances;
  * each other: the batch-in-grid executor equals the per-entry one
    bitwise.

The kernels themselves run only on the card: ``tests/test_torch_gpu.py``
holds them against these plain versions there and skips elsewhere.  Here
the generated sources of bucket specs (streamed halo and wrap maps) are
checked, and the shared-memory estimate that sizes them.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import re
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_conformance
from repro.configs import stencils as ref_stencils
from repro.core import dsl as ref_dsl
from repro.kernels import blockops as ref_blockops
from repro.kernels import ops as ref_ops
from repro.core.spec import Boundary as RefBoundary

from repro_torch.configs import stencils as pt_stencils
from repro_torch.core import dsl as pt_dsl
from repro_torch.core.ir import lower
from repro_torch.core.spec import BinOp, Boundary, Num, Ref, Var, walk
from repro_torch.kernels import blockops, cuda_build, division, ops, pipeline, stencil, tiling
from repro_torch.runtime.bucketing import bucket_plan

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
    g = tiling.round_plan(spec, 4)
    assert g.tile == (32, 64) and g.h == 4
    assert g.window == (40, 72) and g.frame == 0
    assert g.n_tiles == (304, 16) and g.tiles == 304 * 16
    # two inputs + the next iterate, as float (72-float rows, 11,520-byte
    # windows: whole 128-byte units)
    assert g.pitch == 72 and g.framed_cells == 40 * 72
    assert tiling.smem_bytes_estimate(spec, 4) == 3 * 40 * 72 * 4
    assert g.smem_bytes == 3 * 40 * 72 * 4 and g.n_buffers == 3
    assert tiling.round_plan(spec, 4, (64, 64)).window == (72, 72)
    small = tiling.round_plan(lower(_port(
        ref_stencils.get("jacobi2d", shape=(7, 5)))).spec, 2)
    assert small.tile == (7, 5)       # clipped to the grid
    # a plan builds for any spec; the launch refuses what the kernel
    # cannot run (here four axes), the plain version walks it
    four = lower(pt_dsl.parse(
        "kernel: K4\ninput float: a(4, 4, 4, 6)\n"
        "output float: b(0,0,0,0) = (a(-1,0,0,0) + a(0,0,0,1)) / 2\n")).spec
    assert tiling.round_plan(four, 1, (4, 4, 4, 4)).tiles == 2
    with pytest.raises(NotImplementedError):
        stencil._launch_plan(four, 1, (4, 4, 4, 4))
    grid = torch.rand(4, 4, 4, 6)
    out = stencil.stencil_torch_tiled(four, {"a": grid}, 1, (4, 4, 4, 4))
    assert out.shape == grid.shape
    # a replicate bucket spec stages the data and the mask as float
    # windows (+ the next iterate), each inside a zero frame of the largest
    # stage radius (rows of 74 floats, not rounded: 42 x 74 floats rounded
    # up to 128 bytes); its two int32 halo maps are read from global
    # memory, and only the per-axis belt bounds sit in shared memory
    jac = lower(_port(ref_stencils.get("jacobi2d", shape=(60, 60)))).spec
    rep = bucket_plan(dataclasses.replace(jac, boundary=Boundary("replicate")),
                      (64, 64)).mspec
    assert rep.num_inputs == 4 and tiling.round_plan(rep, 4).n_buffers == 3
    assert tiling.round_plan(rep, 4).frame == 1
    assert tiling.round_plan(rep, 4).pitch == 74
    assert tiling.smem_bytes_estimate(rep, 4) == 3 * 12544 + 6 * 4
    wrap = bucket_plan(dataclasses.replace(jac, boundary=Boundary("periodic")),
                       (64, 64), wrap_rounds=2).mspec
    assert tiling.smem_bytes_estimate(wrap, 2, (32, 32)) == \
        tiling.smem_bytes_estimate(jac, 2, (32, 32))


def test_cuda_kernel_refuses_what_it_cannot_run():
    ref_spec = ref_dsl.parse(
        "kernel: M\ninput float: a(6, 6)\ninput double: b(6, 6)\n"
        "iterate: a\noutput float: c(0,0) = a(0,0) + b(0,0)\n"
    )
    with pytest.raises(NotImplementedError):    # mixed floating dtypes
        cuda_build.check_supported(_port(ref_spec))
    # an index input that is not int32
    spec = dataclasses.replace(
        lower(_port(ref_stencils.get("jacobi2d", shape=(6, 6)))).spec,
        wrap_index_inputs=("in_1", "in_1"), wrap_round_depth=1,
    )
    with pytest.raises(NotImplementedError, match="not int32"):
        cuda_build.check_supported(spec)


@pytest.mark.parametrize("kind", ["zero", "constant", "replicate", "periodic"])
def test_cuda_kernel_takes_bucket_specs(kind):
    """Bucket specs build: int32 halo maps get their own pointer array
    (SASA_N_HALO), wrap maps never reach the kernel, and only the floating
    inputs are staged (SASA_N_IN)."""
    jac = lower(_port(ref_stencils.get("jacobi2d", shape=(20, 14)))).spec
    spec = dataclasses.replace(jac, boundary=Boundary(kind, 2.0 if kind == "constant" else 0.0))
    plan = bucket_plan(spec, (40, 40), wrap_rounds=2 if kind == "periodic" else None)
    cuda_build.check_supported(plan.mspec)
    tu, body = cuda_build.generate(plan.mspec)
    floats = 1 if kind == "periodic" else 2                # data (+ mask)
    assert f"#define SASA_N_IN {floats}\n" in tu
    halo = 2 if kind == "replicate" else 0
    assert f"#define SASA_N_HALO {halo}\n" in tu
    assert tiling.float_inputs(plan.mspec) == list(plan.mspec.inputs)[:floats]


# A 1-D spec: the kernel walks it cell by cell.
ONE_D = """kernel: LINE5
iteration: 4
input float: in_1(300)
output float: out_1(0) = (in_1(-2) + in_1(-1) + in_1(0) + in_1(1) + in_1(2)) / 5
"""


def test_generated_source_is_exact_and_structural():
    spec = lower(_port(ref_stencils.get("hotspot", shape=(64, 64)))).spec
    tu, body = cuda_build.generate(spec)
    assert "#define SASA_N_IN 2" in tu and "#define SASA_ITER 1" in tu
    # 1.296 as its exact float32 value, in hex
    assert f"({float(np.float32(1.296)).hex()}f)" in body
    other = lower(_port(ref_stencils.get("hotspot", shape=(9720, 1024),
                                         iterations=9))).spec
    assert cuda_build.kernel_key(spec) == cuda_build.kernel_key(other)
    # 2-D: a strip of SASA_STRIP cells loads each column of taps (array,
    # inner offset) once, from the cell's flat index plus a constant
    # offset (the column's first row), into registers; a tap of cell r is
    # a register, and each operation runs over the strip's cells before
    # the next.  The stage call carries its tail of the trapezoid
    # (stage_regions at s = 1).
    assert "#define SASA_NDIM 2\n#define SASA_STRIP 6\n" in tu
    assert "struct sasa_strip<0> {" in body
    assert ("float t0[SASA_STRIP + 2];\n"
            "    sasa_column(t0, sasa_at<0, -1, 0>(env[1], c, g), w);") in body
    assert "sasa_column(t3, sasa_at<0, 0, 1>(env[1], c, g), w);" in body
    assert ("for (int r = 0; r < SASA_STRIP; ++r) n0[r] = "
            "(t0[r + 0] + t0[r + 2]);") in body
    assert "n1[r] = (n0[r] - t0[r + 1]);" in body
    # the short strip at a region's end takes the stage cell by cell
    assert "sasa_tap<0, -1, 0>(env[1], c, g)" in body
    assert "#define SASA_STAGE_CALLS SASA_STAGE(0, 0, nxt)" in body
    assert "#define SASA_RADIUS 1\n" in tu and "#define SASA_FRAME 0\n" in tu
    blur = lower(_port(ref_stencils.get("blur_jacobi2d", shape=(64, 64)))).spec
    assert [r.dilation for r in tiling.stage_regions(blur, 1)] == [1, 0]
    assert "SASA_STAGE(0, 1, buf[SASA_N_IN + 0]) SASA_STAGE(1, 0, nxt)" in \
        cuda_build.generate(blur)[1]
    # 1-D keeps the cell-by-cell stage: a tap is the cell's flat index plus
    # a constant offset
    line = lower(pt_dsl.parse(ONE_D)).spec
    tu1, body1 = cuda_build.generate(line)
    assert "#define SASA_STRIP 1\n" in tu1 and "sasa_strip" not in body1
    assert "sasa_tap<0, 0, -1>(env[0], c, g)" in body1
    # and neither the template's tap nor its column load has a bounds
    # check
    src = (cuda_build.CSRC / "stencil_tile.cuh").read_text()
    tap = src[src.index("sasa_tap(const float* b"):]
    tap = tap[:tap.index("}")]
    assert "return b[c + OZ * g.st[0] + OY * g.st[1] + OX];" in tap
    assert "if" not in tap and "<" not in tap.split(")", 1)[1]
    col = src[src.index("sasa_column(float (&t)[L]"):]
    col = col[col.index("{") + 1:col.index("\n}")]
    assert "for (int i = 0; i < L; ++i) t[i] = p[i * w];" in col
    assert "if" not in col and col.count("<") == 1


# --------------------------------------------------------------------------
# The shrinking trapezoid (what the kernel updates per stage)
# --------------------------------------------------------------------------


def _region_mask(reg, full, window, tiles_shape):
    """True on the cells of ``reg``; ``full`` (``tiles_shape + (nd,)``,
    bool) marks axes a block updates whole."""
    mask = None
    nd = len(window)
    for d, w in enumerate(window):
        idx = torch.arange(w).view([1] * len(tiles_shape) + [-1 if e == d else 1
                                                           for e in range(nd)])
        m = (idx >= reg.lo[d]) & (idx < reg.lo[d] + reg.extent[d])
        m = m | full[(Ellipsis, d) + (None,) * nd]
        mask = m if mask is None else mask & m
    return mask


def _trapezoid_block(spec, blocks, s, origin, grid_shape, boundary=None,
                     compute_dtype=None, *, tile):
    """``blockops.fused_iterations_on_block`` with every stage confined to
    its region of ``tiling.stage_regions``: each cell outside the region
    is NaN from the moment the stage writes, so a needed cell that reads
    one is NaN too.  Blocks of a streamed spec whose belt [lo, hi] misses
    the tile on an axis update that axis whole (the kernel's rule)."""
    nd = spec.ndim
    env = dict(blocks)
    if compute_dtype is not None:
        env = {n: a.to(compute_dtype) if a.is_floating_point() else a
               for n, a in env.items()}

    def fixup(a):
        return blockops.boundary_fixup(a, origin, grid_shape, spec.boundary)

    first = env[spec.iterate_input]
    window = tuple(first.shape[-nd:])
    lead = tuple(first.shape[:-nd])
    g = tiling.round_plan(spec, s, tile)
    full = torch.zeros(lead + (nd,), dtype=torch.bool)
    streamed = bool(spec.halo_index_inputs)
    if streamed:
        src = dict(env)
        axes = tuple(range(first.dim() - nd, first.dim()))
        for d, name in enumerate(spec.halo_index_inputs):
            org = blockops._origin_axis(origin, nd, d)
            tgt = (src[name].long() - org).clamp(0, window[d] - 1)
            lo = tgt.amin(dim=axes)
            hi = tgt.amax(dim=axes)
            full[..., d] = (lo > g.h + g.tile[d] - 1) | (hi < g.h)
        env = {n: blockops.streamed_halo_fixup(a, src, spec, origin)
               for n, a in env.items()}
    env = {n: fixup(a) for n, a in env.items()}
    regions = iter(tiling.stage_regions(spec, s, tile))
    cur = env[spec.iterate_input]
    for _ in range(s):
        env[spec.iterate_input] = cur
        stage_env = dict(env)
        for stage in spec.stages:
            mask = _region_mask(next(regions), full, window, lead)
            out = blockops._block_stage(stage, stage_env, nd, compute_dtype)
            out = torch.where(mask, out, float("nan"))
            if streamed:
                out = blockops.streamed_halo_fixup(out, stage_env, spec, origin)
            out = torch.where(mask, fixup(out), float("nan"))
            stage_env[stage.name] = out
        cur = stage_env[spec.output_name]
    return cur


def _trapezoid_round(spec, arrays, s, tile, monkeypatch):
    """``stencil.tiled_round`` walking the trapezoid instead of whole
    windows."""
    with monkeypatch.context() as m:
        m.setattr(stencil, "fused_iterations_on_block",
                  lambda *a, **k: _trapezoid_block(*a, tile=tile, **k))
        return stencil.tiled_round(spec, arrays, s, tile)


@pytest.mark.parametrize("kind", ["zero", "constant", "replicate", "periodic"])
@pytest.mark.parametrize("name", list(ref_stencils.BENCHMARKS))
def test_trapezoid_equals_full_window_bitwise(name, kind, monkeypatch):
    """Confining every stage to its region changes no output cell: the
    trapezoid's regions hold every cell later stages read, at s up to 8,
    on 32- and 64-row tiles with edge and interior blocks."""
    three = name in ref_stencils.BENCHMARKS_3D
    shape = (21, 13, 40) if three else (100, 77)
    spec = dataclasses.replace(
        lower(_port(ref_stencils.get(name, shape=shape))).spec,
        boundary=Boundary(kind, 1.5 if kind == "constant" else 0.0),
    )
    rng = np.random.default_rng(31)
    arrays = {n: torch.from_numpy(rng.standard_normal((1,) + shape)
                                  .astype(np.float32)) for n in spec.inputs}
    for rows in (32, 64):
        tile = (rows // 4, 8, 32) if three else (rows, rows)
        for s in (1, 2, 4, 8):
            want = stencil.tiled_round(spec, arrays, s, tile)
            got = _trapezoid_round(spec, arrays, s, tile, monkeypatch)
            assert torch.equal(got, want), (name, kind, tile, s)


@pytest.mark.parametrize("kind", ["replicate", "periodic"])
@pytest.mark.parametrize("name", ["jacobi2d", "sobel2d_replicate"])
def test_trapezoid_equals_full_window_on_bucket_specs(name, kind, monkeypatch):
    """The bucket specs of chip_smoke.py's ``small`` phase (grid + 24 per
    axis), with a full entry, a smaller one and the all-zero filler: every
    cell of the bucket grid, padding included, bitwise.  The 16-row tile
    lies wholly in the padding past the smaller entry's real region, where
    the belt copies cells outside the trapezoid."""
    shape = (100, 77)
    spec = dataclasses.replace(
        lower(_port(ref_stencils.get(name, shape=shape, iterations=4))).spec,
        boundary=Boundary(kind),
    )
    plan = bucket_plan(spec, tuple(n + 24 for n in shape), iterations=4,
                       wrap_rounds=2 if kind == "periodic" else None)
    rng = np.random.default_rng(32)
    entries = []
    for cut in (0, 30):
        sub = tuple(n - cut for n in shape)
        e = {n: plan.place_entry(rng.standard_normal(sub).astype(np.float32))
             for n in spec.inputs}
        e.update(plan.service_entry(sub))
        entries.append(e)
    e = {n: plan.filler_entry(n) for n in spec.inputs}
    e.update(plan.service_filler())
    entries.append(e)
    mspec = plan.mspec
    arrays = {n: torch.from_numpy(np.stack([x[n] for x in entries]))
              for n in mspec.inputs}
    for tile in ((32, 32), (16, 16)):
        for s in ((1, 2) if kind == "periodic" else (1, 2, 4)):
            want = stencil.tiled_round(mspec, arrays, s, tile)
            got = _trapezoid_round(mspec, arrays, s, tile, monkeypatch)
            assert torch.equal(got, want), (name, kind, tile, s)


def test_stage_regions_shrink_to_the_tile():
    """e(j, k) + r_k <= h: no tap leaves the window; the last region is
    the tile; each stage's readers reach only into its region."""
    for name in ref_stencils.BENCHMARKS:
        spec = lower(_port(ref_stencils.get(name))).spec
        radii = [st.radius for st in spec.stages]
        for s in (1, 3, 8):
            regs = tiling.stage_regions(spec, s, (32,) * spec.ndim)
            h = s * spec.radius
            assert len(regs) == s * len(radii)
            for reg in regs:
                assert reg.dilation + radii[reg.stage] <= h
                assert all(lo == h - reg.dilation for lo in reg.lo)
            assert regs[-1].dilation == 0
            assert regs[-1].extent == tuple(min(32, n) for n in spec.shape)
            for a, b in zip(regs, regs[1:]):
                assert a.dilation >= b.dilation + radii[b.stage]


# Per stage, the span along the first axis of each tap column (array,
# offset on the other axes), and the stage's distinct taps, written out
# by hand.
HAND_COLUMNS = {
    # x - 1, x over rows -1..1, x + 1; 5 taps
    "jacobi2d": [([0, 2, 0], 5)],
    # the blur: x, x + 1, x + 2, each over rows -1..1; then JACOBI2D on temp
    "blur_jacobi2d": [([2, 2, 2], 9), ([0, 2, 0], 5)],
    # (y, x) over planes -1..1, and its four neighbours in the plane
    "heat3d": [([2, 0, 0, 0, 0], 7)],
}


@pytest.mark.parametrize("name, shape, s, tile, ratio", [
    # the benchmark's picks: 2-D strips of 6 rows, 3-D strips of 8 planes;
    # regions 64 + 2e (e = 0..7), 72, 70, 66, 64, and 18 or 16 planes
    ("jacobi2d", (9720, 1024), 8, (64, 64), 3.3795930462),
    ("blur_jacobi2d", (9720, 1024), 2, (64, 64), 3.7246439361),
    ("heat3d", (9720, 32, 32), 2, (16, 8, 32), 5.3664839468),
    # a whole strip of 8 planes (5.25 loads a cell), a short one of 5 (7)
    ("heat3d", (40, 24, 30), 1, (13, 8, 30), (8 * 5.25 + 5 * 7) / 13),
])
def test_tap_loads_are_counted_strip_by_strip(name, shape, s, tile, ratio):
    """Tile by tile, stage by stage, strip by strip: a whole strip loads
    its cells plus the span of each of its stage's tap columns, a short
    one its stage's taps at each cell, so loads over updates lies below
    the stage's taps (5, 9 and 5, 7)."""
    spec = lower(_port(ref_stencils.get(name, shape=shape))).spec
    strip = tiling.STRIP_CELLS[spec.ndim]
    assert strip == {2: 6, 3: 8}[spec.ndim]
    radii = [st.radius for st in spec.stages]
    loads = issued = 0
    for _ in itertools.product(*(range(math.ceil(n / t))
                                 for n, t in zip(shape, tile))):
        for j in range(s):
            for k, (spans, taps) in enumerate(HAND_COLUMNS[name]):
                e = (s - 1 - j) * spec.radius + sum(radii[k + 1:])
                ext = [t + 2 * e for t in tile]
                issued += math.prod(ext)
                for first in range(0, ext[0], strip):
                    n = min(strip, ext[0] - first)
                    loads += math.prod(ext[1:]) * (
                        sum(n + sp for sp in spans) if n == strip
                        else n * taps)
    plan = tiling.round_plan(spec, s, tile)
    assert (plan.tap_loads, plan.issued) == (loads, issued)
    assert plan.tap_loads / plan.issued == pytest.approx(ratio, rel=1e-9)


@pytest.mark.parametrize("s, tile", [(1, (64,)), (3, (64,)), (2, (300,))])
def test_tap_loads_of_a_1d_spec_are_taps_times_cells(s, tile):
    spec = lower(pt_dsl.parse(ONE_D)).spec
    plan = tiling.round_plan(spec, s, tile)
    cells = sum(r.extent[0] for r in tiling.stage_regions(spec, s, tile))
    assert plan.tap_loads == math.ceil(300 / tile[0]) * 5 * cells
    assert plan.tap_loads == 5 * plan.issued


def test_predicted_updates_match_the_closed_form(monkeypatch):
    """predict_gpu counts the cells of every stage's region: JACOBI2D
    4096x4096, s=16, one round, a 32x32 tile is 16384 x sum_k (32+2k)^2;
    the default 32x64 tile is 8192 x sum_k (32+2k)(64+2k)."""
    from repro_torch.core.model import (
        ParallelismConfig, predict_gpu, resident_blocks,
    )
    from repro_torch.core.platform import DEFAULT_GPU

    spec = lower(_port(ref_stencils.jacobi2d(shape=(4096, 4096),
                                             iterations=16))).spec
    cfg = ParallelismConfig("temporal", s=16)
    p = predict_gpu(spec, cfg, DEFAULT_GPU)
    assert p.cell_updates == 8192 * sum((32 + 2 * k) * (64 + 2 * k)
                                        for k in range(16))
    # 49 KB of shared memory: 4 blocks per SM, the full rate
    assert resident_blocks(int(p.smem_bytes), DEFAULT_GPU) == 4
    assert p.compute_term == p.cell_updates * DEFAULT_GPU.cell_update_s
    assert p.latency == p.compute_term + p.memory_term + DEFAULT_GPU.launch_s
    monkeypatch.setitem(tiling.DEFAULT_TILES, 2, (32, 32))
    p = predict_gpu(spec, cfg, DEFAULT_GPU)
    assert p.cell_updates == 16384 * sum((32 + 2 * k) ** 2 for k in range(16))
    assert p.rounds == 1
    # a ragged last round has its own trapezoid: 20 iterations at s=16
    p20 = predict_gpu(spec, cfg, DEFAULT_GPU, iterations=20)
    assert p20.cell_updates == p.cell_updates + 16384 * sum(
        (32 + 2 * k) ** 2 for k in range(4))


@pytest.mark.parametrize("name, it", [
    *[(name, 64) for name in pt_stencils.BENCHMARKS],
    ("jacobi2d", 20),            # a ragged last round at s = 8 and 16
    ("periodic_bucket", 9),      # rounds capped at the wrap depth, 2
])
def test_the_rankers_updates_are_the_round_plans(name, it):
    """predict_gpu prices the updates the launch counts: the full rounds
    at the depth left after the wrap cap, then the ragged last round,
    each its round plan's ``issued`` (what ``redundant_update_ratio``
    reads off the launch's counters)."""
    from repro_torch.core.model import gpu_candidate_configs, predict_gpu
    from repro_torch.core.platform import DEFAULT_GPU

    if name == "periodic_bucket":
        jac = lower(_port(ref_stencils.get("jacobi2d", shape=(60, 60)))).spec
        spec = bucket_plan(
            dataclasses.replace(jac, boundary=Boundary("periodic")),
            (64, 64), wrap_rounds=2).mspec
    else:
        spec = lower(pt_stencils.get(name, iterations=it)).spec
    depths = set()
    for cfg in gpu_candidate_configs(spec, DEFAULT_GPU, it):
        s = max(min(cfg.s, it), 1)
        if spec.wrap_index_inputs:
            s = min(s, spec.wrap_round_depth)
        rounds = math.ceil(it / s)
        last = it - (rounds - 1) * s
        depths.add((cfg.s, s, last))
        tile = tiling.default_tile(spec.ndim, cfg.tile_rows)
        want = ((rounds - 1) * tiling.round_plan(spec, s, tile).issued
                + tiling.round_plan(spec, last, tile).issued)
        assert predict_gpu(spec, cfg, DEFAULT_GPU, it).cell_updates == want
    if name == "jacobi2d" and it == 20:
        assert {(8, 8, 4), (16, 16, 4)} <= depths
    if name == "periodic_bucket":
        assert (8, 2, 1) in depths


def test_resident_blocks_price_occupancy():
    """Blocks per SM from shared memory (1 KB each for the system) or from
    2048 threads; below full_rate_blocks an update costs more."""
    from repro_torch.core.model import (
        ParallelismConfig, predict_gpu, resident_blocks,
    )
    from repro_torch.core.platform import DEFAULT_GPU

    assert resident_blocks(23040, DEFAULT_GPU) == 8       # thread bound
    assert resident_blocks(73728, DEFAULT_GPU) == 3
    assert resident_blocks(122880, DEFAULT_GPU) == 1
    spec = lower(_port(ref_stencils.jacobi2d(shape=(4096, 4096),
                                             iterations=16))).spec
    tall = predict_gpu(spec, ParallelismConfig("temporal", s=16, tile_rows=128),
                       DEFAULT_GPU)
    assert resident_blocks(int(tall.smem_bytes), DEFAULT_GPU) == 1
    assert tall.compute_term == pytest.approx(
        tall.cell_updates * DEFAULT_GPU.cell_update_s * 3 ** 0.5)


# --------------------------------------------------------------------------
# Division by a constant (kernels/division.py)
# --------------------------------------------------------------------------


def _dyadic(f: float) -> tuple[int, int]:
    """``(n, e)`` with ``f = n * 2**e``, for a finite float."""
    num, den = f.as_integer_ratio()
    return num, 1 - den.bit_length()


def _round32(n: int, e: int) -> float:
    """RN(n * 2**e) in float32, ties to even, as a float; ``n != 0``."""
    neg, n = n < 0, abs(n)
    lsb = max(n.bit_length() - 1 + e, -126) - 23
    shift = lsb - e
    if shift <= 0:
        m = n << -shift
    else:
        m, rem = n >> shift, n & ((1 << shift) - 1)
        half = 1 << (shift - 1)
        m += rem > half or (rem == half and m & 1)
    v = math.inf if m * 2.0**lsb >= 2.0**128 else math.ldexp(m, lsb)
    return -v if neg else v


def _fma(a: float, b: float, c: float) -> float:
    """IEEE fmaf on float32 values: one rounding of the exact a * b + c."""
    if math.isnan(a) or math.isnan(b) or math.isnan(c):
        return math.nan
    if math.isinf(a) or math.isinf(b):
        if a == 0 or b == 0:
            return math.nan
        p = a * b
        return math.nan if math.isinf(c) and c != p else p
    if math.isinf(c):
        return c
    (na, ea), (nb, eb), (nc, ec) = _dyadic(a), _dyadic(b), _dyadic(c)
    e = min(ea + eb, ec)
    n = (na * nb << (ea + eb - e)) + (nc << (ec - e))
    if n:
        return _round32(n, e)
    negative_product = (a == 0 or b == 0) and math.copysign(1, a) != math.copysign(1, b)
    # an exact zero: -0 only where both addends are -0
    return -0.0 if negative_product and math.copysign(1, c) < 0 else 0.0


def _fmin(a: float, b: float) -> float:
    """fminf: a NaN operand gives the other."""
    return b if math.isnan(a) else a if math.isnan(b) else min(a, b)


def _emitted_division(how: division.Division):
    """The C the generator emits for ``x / d`` at one cell, lowered as
    ``how`` says, as a Python function of ``x`` over exact float32
    operations (``__fmul_rn`` an fma with -0)."""
    em = cuda_build._Emitter({})
    result = em.divide("x", "d", how)
    lines = [ln.strip().removeprefix("const float ").rstrip(";")
             for ln in em.lines]
    src = "\n".join(["def f(x):", *("    " + ln for ln in lines),
                     f"    return {result}"])
    src = re.sub(r"(-?0x[0-9a-f.]+p[-+][0-9]+)f", r"float.fromhex('\1')", src)
    ns = {"__fmul_rn": lambda a, b: _fma(a, b, -0.0), "__fmaf_rn": _fma,
          "fminf": _fmin}
    exec(src, ns)
    return ns["f"]


def _mismatches(how, d, bits) -> list[int]:
    """The bit patterns ``x`` where the emitted sequence differs from
    ``np.float32(x) / np.float32(d)`` (NaN equals NaN)."""
    f = _emitted_division(how)
    xs = np.asarray(bits, dtype=np.uint32).view(np.float32)
    with np.errstate(all="ignore"):
        want = xs / np.float32(d)
    bad = []
    for b, x, w in zip(bits, xs.tolist(), want.tolist()):
        got = f(x)
        if not (math.isnan(got) and math.isnan(w)) and \
                np.float32(got).view(np.uint32) != np.float32(w).view(np.uint32):
            bad.append(int(b))
    return bad


# ±0, the subnormal range's ends, the normal range's first binade, the
# binade edges about 1 and 2, multiples of the divisors, the largest
# finite float, ±inf and NaN, each also negative.
EDGE_BITS = [
    b | sign for sign in (0, 0x80000000) for b in (
        0x00000000, 0x00000001, 0x00000002, 0x00000003, 0x00000009,
        0x007FFFFF, 0x00800000, 0x00800001, 0x00FFFFFF, 0x01000000,
        0x0C800000, 0x0CFFFFFF, 0x3F7FFFFF, 0x3F800000, 0x3F800001,
        0x3FFFFFFF, 0x40000000, 0x40400000, 0x40A00000, 0x40E00000,
        0x41100000, 0x41200000, 0x7F000000, 0x7F7FFFFE, 0x7F7FFFFF,
        0x7F800000, 0x7FC00000, 0x7F800001)
]


def test_stock_divisors_lower_to_the_exact_reciprocal():
    """/ 5, / 7, / 9 of the stock stencils take the correction with
    RN(1/d) nearer 1/d than either float32 neighbour; / 4 is one exact
    multiply; a tap, a ``Let`` or an even or fractional constant keeps
    C ``/``; HEAT3D divides nowhere."""
    got = {}
    for name in pt_stencils.BENCHMARKS:
        spec = lower(pt_stencils.get(name, shape=(12, 10, 9) if name in
                     pt_stencils.BENCHMARKS_3D else (40, 36))).spec
        for st in spec.stages:
            for n in walk(st.expr):
                if isinstance(n, BinOp) and n.op == "/":
                    got.setdefault(name, []).append(division.lower_division(n.rhs))
    assert {n: [h.divisor for h in hs] for n, hs in got.items()} == {
        "jacobi2d": [5.0], "jacobi3d": [7.0], "blur": [9.0], "seidel2d": [9.0],
        "blur_jacobi2d": [9.0, 5.0], "blur_replicate": [9.0]}
    for hs in got.values():
        for h in hs:
            assert h.kind == "correction"
            y = Fraction(h.reciprocal)
            up = Fraction(float(np.nextafter(np.float32(h.reciprocal), np.float32(1))))
            down = Fraction(float(np.nextafter(np.float32(h.reciprocal), np.float32(0))))
            exact = 1 / Fraction(h.divisor)
            assert abs(y - exact) < min(abs(up - exact), abs(down - exact))
            assert np.float32(h.reciprocal) == h.reciprocal
    assert division.lower_division(Num(4.0)) == division.Division(
        "reciprocal", 4.0, 0.25)
    assert division.lower_division(Num(-0.5)).reciprocal == -2.0
    # a power of two whose reciprocal is a normal float32, and no other
    assert division.lower_division(Num(2.0**-127)).reciprocal == 2.0**127
    assert division.lower_division(Num(2.0**-128)) == division.IEEE
    assert division.lower_division(Num(2.0**-149)) == division.IEEE
    for d in (Ref("in_1", (0, 0)), Var("_t0"), Num(6.0), Num(10.0),
              Num(1.5), Num(0.3), Num(0.0), Num(2.0**127), Num(2.0**22 + 1)):
        assert division.lower_division(d) == division.IEEE, d
    assert division.lower_division(Num(2.0**22 - 1)).kind == "correction"
    assert division.lower_division(Num(-5)).reciprocal == \
        -division.lower_division(Num(5)).reciprocal
    body = cuda_build.generate(lower(pt_stencils.get("jacobi2d", shape=(40, 36))).spec)[1]
    assert "__fmul_rn(n3[r], (0x1.99999a0000000p-3f))" in body
    assert "__fmaf_rn((0x1.4000000000000p+2f), n4[r], (-n3[r]))" in body
    assert " / " not in body
    heat = cuda_build.generate(lower(pt_stencils.get("heat3d", shape=(12, 10, 9))).spec)[1]
    assert not any(s in heat for s in (" / ", "__fmul_rn", "__fmaf_rn", "fminf"))
    mixed = lower(pt_dsl.parse(MIXED)).spec
    body = cuda_build.generate(mixed)[1]
    assert "__fmul_rn(t1[r + 0], (0x1.0000000000000p-2f))" in body
    assert "(t2[r + 0] / (0x1.8000000000000p+2f))" in body
    assert "(t0[r + 2] / t0[r + 1])" in body and "(t0[r + 0] / n0[r])" in body


@pytest.mark.parametrize("d", [5.0, 7.0, 9.0, 3.0, 25.0, -5.0, 4.0, 0.5])
def test_emitted_division_is_ieee_division_bitwise(d):
    """The emitted sequence, run on exact rationals rounded once per
    operation, equals float32 division over the edge cases and random bit
    patterns: 10^5 over the whole range for the stock divisors (fewer for
    the others), and 2 x 10^4 below 2^-100, where the correction term
    would need bits under 2^-149 for a divisor that is no integer."""
    how = division.lower_division(Num(d))
    assert how.kind != "ieee"
    rng = np.random.default_rng(int(abs(d) * 1000))
    n = 100_000 if d in (5.0, 7.0, 9.0) else 20_000
    bits = rng.integers(0, 2**32, n, dtype=np.uint64)
    tiny = rng.integers(0, 0x0D000000, 20_000, dtype=np.uint64) | (
        rng.integers(0, 2, 20_000, dtype=np.uint64) << 31)
    assert _mismatches(how, d, EDGE_BITS + bits.tolist() + tiny.tolist()) == []


@pytest.mark.parametrize("d, x", [
    (6.0, 0x00000009),    # 9 * 2^-149 / 6 ties between 1 and 2 * 2^-149
    (10.0, 0x0000000F),   # 15 * 2^-149 / 10 ties the same way
])
def test_the_rule_refuses_divisors_whose_quotients_tie(d, x):
    """An even divisor's quotient can be a midpoint in the subnormal
    range, where the correction breaks the tie towards zero, not to even:
    the rule keeps C ``/`` for it."""
    forced = division.Division("correction", d, division.round_float32(1 / Fraction(d)))
    assert _mismatches(forced, d, [x]) == [x]
    assert division.lower_division(Num(d)) == division.IEEE


MIXED = """kernel: MIXED
iteration: 2
input float: in_1(40,36)
output float: out_1(0,0) = in_1(0,1) / 4 + in_1(0,-1) / 6 + in_1(1,0) / in_1(0,0)
    + in_1(-1,0) / (in_1(0,0) + 2) + in_1(1,1) / (in_1(0,0) + 2) + in_1(0,0) / -5
"""


@pytest.mark.parametrize("name, shape, s, tile, per_update", [
    ("jacobi2d", (9720, 1024), 8, (64, 64), [(1, 0)]),
    ("blur_jacobi2d", (9720, 1024), 2, (64, 64), [(1, 0), (1, 0)]),
    ("heat3d", (9720, 32, 32), 2, (16, 8, 32), [(0, 0)]),
    ("mixed", (40, 36), 3, (16, 16), [(2, 4)]),
])
def test_division_counts_are_the_generated_stages(name, shape, s, tile,
                                                  per_update):
    """Stage by stage over every tile: the divisions the generated
    ``sasa_stage<k>`` computes through a reciprocal (one ``__fmul_rn``
    each) and by C ``/``, times the cells of the stage's regions, are the
    round plan's counts."""
    spec = (lower(pt_dsl.parse(MIXED)).spec if name == "mixed" else
            lower(pt_stencils.get(name, shape=shape)).spec)
    body = cuda_build.generate(spec)[1]
    found = []
    for k in range(len(spec.stages)):
        stage = body[body.index(f"sasa_stage<{k}>("):]
        stage = stage[:stage.index("\n}")]
        found.append((stage.count("__fmul_rn("), stage.count(" / ")))
    assert found == per_update
    tiles = math.prod(math.ceil(n / t) for n, t in zip(shape, tile))
    recip = ieee = 0
    for reg in tiling.stage_regions(spec, s, tile):
        recip += tiles * math.prod(reg.extent) * found[reg.stage][0]
        ieee += tiles * math.prod(reg.extent) * found[reg.stage][1]
    plan = tiling.round_plan(spec, s, tile)
    assert (plan.divides_reciprocal, plan.divides_ieee) == (recip, ieee)
    if name != "mixed":
        assert plan.divides_reciprocal == plan.issued * per_update[0][0]
