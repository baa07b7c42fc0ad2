"""Quickest proof that the PyTorch/CUDA port starts and is right on one GPU.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py

It builds the CUDA tile kernels from ``src/repro_torch/kernels/csrc`` into
``build/repro_torch_kernels/`` (one ``nvcc`` per kernel, all at once), then
runs ten phases, each printing JSON lines:

  1. device    the card's name and power limit (``nvidia-smi``), versions;
  2. build     kernels built and seconds;
  3. small     every stock kernel at s in {1, 2, 4, 8} (all four boundary
               kinds) and a bfloat16 spec, on a small grid (edge blocks
               only) and a larger one (interior blocks at s = 8 too), on
               the default tile and a taller one: ``stencil_cuda`` against
               its plain version on the card, and ``stencil_cuda_batched``
               bitwise against ``stencil_cuda`` per entry.  Then the
               streamed bucket specs of JACOBI2D and SOBEL2D-REPLICATE
               under replicate (halo-index maps) and periodic (wrap maps),
               three entries with different maps, one of them the all-zero
               batch filler, on the default tile and a 16x16 one (tiles
               wholly in the padding): the same checks per round, and the
               round loop (wrap maps consumed between rounds) against its
               plain version;
  4. main      the port's main path at the paper's sizes:
               ``autotune(DSL, device="cuda")`` then ``design.runner``, with
               the launch counters read around the run, the error against
               the plain version, median times and achieved bandwidth,
               then the ranker's prediction against K1's time at every
               fusion depth and tile it ranks for JACOBI2D 4096x4096
               (``sweep``), with the measured time per cell update;
  5. batched   ``build_batched_runner`` with ``buffer_depth=2`` (K2) on a
               batch of 8, bitwise against K1 per entry, and one round at
               s=1 against one ``F.conv2d`` call over the batch (TF32 off),
               timed only as a yardstick;
  6. yardstick JACOBI2D at s=1 against one ``F.conv2d`` call (cuDNN with
               TF32 off), timed only as a yardstick;
  7. serve     bucketed serving at the paper's width: ``StencilServer``
               with a (10240,) x (1024, 1088) bucket ladder serves
               JACOBI2D under zero, constant 25.0, replicate and periodic
               boundaries, 16 iterations, 5 shapes per mode (9720x1024
               and 4 drawn from seed 2022 in [8000, 9720] x [768, 1024]),
               2 requests per shape.  Every result is held bitwise against
               the port's single-shot ``build_bucket_runner`` and within
               tolerance of the plain version of the unpadded spec; one
               line per mode gives launches, flush seconds, grids per
               second and the padded-cell share;
  8. distribute the five SASA parallelisms of ``core/distribute.py`` on a
               pool of 4 logical devices that are all this one card
               (``[cuda] * 4``; every line says ``logical_devices: 4,
               physical_devices: 1``): JACOBI2D, HOTSPOT and
               SOBEL2D-REPLICATE at 9720x1024 and HEAT3D-PERIODIC at
               9720x32x32, 16 iterations, each as spatial_s(k=4),
               spatial_r(k=4), hybrid_s(k=4,s=4), hybrid_r(k=4,s=4) and
               temporal(s=4), held against the plain oracle
               (``kernels/ref.py``) on the card within 2e-4 x max|out|, with
               ms from CUDA events (median of 3 runs; the temporal
               pipeline's one checked run), halo bytes moved and, for
               the row partitions, the model's prediction for 4 H100s
               (its host term and launches too); then a batch of 2
               bitwise against single-grid runs.  The shard path runs no CUDA kernel (as the
               reference's reaches no Pallas kernel): its launch counts
               must read 0;
  9. degraded  hybrid_s(k=4,s=8) on the real pool (this one card): warns,
               reports ``degraded`` on 1 device, runs K1 at s=8 bitwise
               equal to temporal(s=8) K1 on the same tile; under
               ``strict`` it raises;
 10. rank_pool ``autotune`` and ``soda_baseline`` ranked for a pool of 4
               cards (``build=False``), JACOBI2D 9720x1024: the top five
               configurations of each and the best shard design, with
               their predictions; then ``autotune`` built on the pool
               ``[cuda] * 4``, whose design must run the tile kernel;
 11. cold_start two fresh subprocesses (``chip_smoke.py --cold-start-child``)
               share one empty store directory under ``build/``, each
               with a private, empty kernel build root; each serves
               JACOBI2D 9720x1024, 16 iterations, through
               ``StencilServer(device="cuda", max_batch=1, store_dir=...)``.
               The cold side must rank and run ``nvcc``; the warm side
               must rank nothing, compile nothing and load the kernel's
               library from the store, with a bitwise equal result.  Each
               side's time to first result (after imports) and the ratio
               are printed, not gated;
 12. scheduler phase ``serve``'s 40 requests through ``StencilScheduler``
               over the same server: every result bitwise equal to
               ``serve()``'s, no drop; then the open-loop Poisson trace
               of ``benchmarks/serving_latency.py`` (240 requests at 300
               per second over 4 designs) against the flush baseline:
               grids per second and p50/p99 latency of both, not gated;
 13. router    ``StencilRouter`` with 2 workers (``--device cuda``, both on
               this card) over one fresh store: the second worker
               registers with no ranking, no compile and the library from
               the store; the 40 requests routed, bitwise equal to the
               in-process server's; then the 40 again with the owner of
               one design killed with requests in flight: each is handed
               off and resolves bitwise equal, and ``close()`` drains and
               reaps both workers.

Then one JSON line lists every kernel with its launches, error and times,
and the last line is ``{"ok": true, "device": {...}}``.  Any failure
raises, so the exit code is non-zero and no result line is printed.
Imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

TOL = {"float32": 2e-4, "bfloat16": 2e-2}   # tests/test_kernels.py::tol
SMALL_2D, SMALL_3D = (100, 77), (21, 13, 40)
# grids with interior blocks at s = 8 (windows wholly inside the grid)
LARGER_2D, LARGER_3D = (200, 150), (37, 40, 41)
SMALL_S = (1, 2, 4, 8)
TALL_ROWS = {2: 64, 3: 16}   # the non-default tile row extent checked
MAIN_CASES = [  # (stock kernel, shape); 16 iterations each
    ("jacobi2d", (9720, 1024)),
    ("jacobi2d", (4096, 4096)),
    ("hotspot", (9720, 1024)),
    ("blur_jacobi2d", (9720, 1024)),
    ("sobel2d_replicate", (9720, 1024)),
    ("heat3d_periodic", (9720, 32, 32)),
]
ITERATIONS = 16
# benchmarks/serving_throughput.py::BOUNDARY_DSL (copied: the port imports
# nothing of the JAX package's tree)
BOUNDARY_DSL = """
kernel: JACOBI2D_{tag}
iteration: {it}
boundary: {boundary}
input float: in_1({r}, {c})
output float: out_1(0,0) = (in_1(0,1) + in_1(1,0) + in_1(0,0)
    + in_1(0,-1) + in_1(-1,0)) / 5
"""
DIST_CASES = [  # (stock kernel, shape) of phase distribute; 16 iterations
    ("jacobi2d", (9720, 1024)),
    ("hotspot", (9720, 1024)),
    ("sobel2d_replicate", (9720, 1024)),
    ("heat3d_periodic", (9720, 32, 32)),   # 9720 = 4 x 2430: periodic fits
]
DIST_POOL = 4
# the cold-start replica's kernel: JACOBI2D at the paper's 9720x1024
COLD_DSL = BOUNDARY_DSL.format(tag="COLDSTART", it=ITERATIONS,
                               boundary="zero", r=9720, c=1024)
SERVE_MODES = ["zero", "constant 25.0", "replicate", "periodic"]
SERVE_LADDER = ((10240,), (1024, 1088))
SERVE_SHAPES, SERVE_REPEATS = 5, 2
STREAMED_BUCKET_PAD = 24   # small streamed specs: bucket = grid + this
BF16_DSL = """
kernel: J2D_BF16
iteration: 2
input bfloat16: x(16, 24)
output bfloat16: y(0,0) = (x(0,1) + x(1,0) + x(0,0) + x(0,-1) + x(-1,0)) / 5
"""


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def cold_start_child(store_dir: str, build_root: str, out_npy: str,
                     report_json: str) -> int:
    """One serving replica of phase ``cold_start``, in a fresh process:
    a store-backed server on the card, one request, one result.  Its
    kernel build root is ``build_root`` (private and empty), so only the
    store can spare it ``nvcc``."""
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    import numpy as np

    from repro_torch.core import dsl
    from repro_torch.kernels import cuda_build, pipeline, stencil
    from repro_torch.serve import StencilRequest, StencilServer

    cuda_build.BUILD_ROOT = Path(build_root)
    check(not cuda_build.BUILD_ROOT.exists(),
          f"cold_start: build root {build_root} is not empty")
    spec = dsl.parse(COLD_DSL)
    rng = np.random.default_rng(42)
    arrays = {n: rng.standard_normal(shape).astype(dt)
              for n, (dt, shape) in spec.inputs.items()}
    # where the warm side's time goes: the library's write and load
    install = cuda_build.install_library
    install_s = []

    def timed_install(key, blob):
        t = time.perf_counter()
        try:
            return install(key, blob)
        finally:
            install_s.append(time.perf_counter() - t)

    cuda_build.install_library = timed_install

    t0 = time.perf_counter()
    srv = StencilServer(device="cuda", max_batch=1, store_dir=store_dir)
    t1 = time.perf_counter()
    srv.register("jacobi2d", spec)
    t2 = time.perf_counter()
    out = srv.serve([StencilRequest("jacobi2d", arrays)])[0]
    t3 = time.perf_counter()

    np.save(out_npy, out)
    st = srv.stats()
    Path(report_json).write_text(json.dumps({
        "first_result_s": t3 - t0,
        "server_s": t1 - t0,          # CUDA context, store open
        "register_s": t2 - t1,        # ranking or store, kernel, warmup
        "warmup_s": st["jacobi2d"]["warmup_time_s"],   # first dispatch
        "install_s": sum(install_s),  # store blob -> build root -> dlopen
        "library_bytes": sum(p.stat().st_size for p in
                             Path(build_root).glob("*/libsasa.so")),
        "serve_s": t3 - t2,
        "autotune_calls": st["_cache"]["autotune_calls"],
        "jit_builds": st["_cache"]["jit_builds"],
        "store_hits": st["_cache"]["store_hits"],
        "store": st["_store"],
        "nvcc_compiles": cuda_build.build_many.compiles,
        "launches": {"stencil_cuda": stencil.stencil_cuda.launches,
                     "stencil_cuda_batched":
                         pipeline.stencil_cuda_batched.launches},
        "finite": bool(np.isfinite(out).all()),
    }))
    return 0


def main() -> int:
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        raise SystemExit("chip_smoke: src/repro_torch not found beside this script")
    sys.path.insert(0, str(root / "src"))

    import dataclasses
    import warnings

    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")

    from repro_torch.configs import stencils
    from repro_torch.core import dsl
    from repro_torch.core import distribute, model
    from repro_torch.core.autotune import autotune, soda_baseline
    from repro_torch.core.ir import lower
    from repro_torch.core.model import ParallelismConfig, resident_blocks
    from repro_torch.core.platform import gpu_platform_for
    from repro_torch.core.spec import Boundary
    from repro_torch.kernels import cuda_build, ops, pipeline, ref, stencil
    from repro_torch.runtime import (
        DesignCache,
        ShapeBucketer,
        bucket_plan,
        build_bucket_runner,
        padded_request_shape,
    )
    from repro_torch.runtime.batching import (
        DegradedDesignWarning,
        build_batched_runner,
    )
    from repro_torch.serve import StencilRequest, StencilServer

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(2022)

    # ---- 1. device ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = torch.cuda.get_device_name(0)
    gpu = gpu_platform_for(card)
    emit(phase="device", nvidia_smi=smi, kind=card, sku_row=gpu.name,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    def timed(fn, reps: int, warm: int = 2, inner: int = 1) -> float:
        """Median ms of one call of ``fn`` over ``reps`` samples, each
        ``inner`` calls back to back between CUDA events (so the host's
        launch overhead hides behind the device's work), divided by
        ``inner``."""
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(inner):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / inner)
        return float(np.median(times))

    def bound_ms(spec, batch: int, iterations: int) -> tuple[float, str]:
        """Least time for the work: every input read once, the output
        written once, against the card's HBM rate; the useful operations
        against its float32 rate."""
        nbytes = batch * (spec.num_inputs + 1) * spec.cells * spec.itemsize
        nops = batch * spec.cells * spec.ops_per_cell * iterations
        t_bytes = nbytes / gpu.hbm_bw * 1e3
        t_ops = nops / gpu.fp32_flops * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def inputs(spec, batch: int | None = None):
        shape = spec.shape if batch is None else (batch,) + tuple(spec.shape)
        return {
            n: rng.standard_normal(shape).astype(np.float32)
            for n in spec.inputs
        }

    def plain_run(spec, arrays, iterations, s, tile):
        """The main path's rounds through the kernels' plain version."""
        return ops.run_rounds(spec, arrays, iterations, s,
                              stencil.stencil_torch_tiled, tile)

    def max_err(a, b) -> float:
        return float((a.float() - b.float()).abs().max())

    # ---- 2. build -------------------------------------------------------
    small = []
    for key in stencils.BENCHMARKS:
        shape = SMALL_3D if key in stencils.BENCHMARKS_3D else SMALL_2D
        small.append(lower(stencils.get(key, shape=shape, iterations=4)).spec)
    small.append(dataclasses.replace(small[0], boundary=Boundary("constant", 1.5)))
    small.append(lower(dsl.parse(BF16_DSL)).spec)
    # streamed bucket specs: (request spec, its bucket plan)
    streamed = []
    for key in ("jacobi2d", "sobel2d_replicate"):
        for kind, wrap in (("replicate", None), ("periodic", 2)):
            spec = dataclasses.replace(
                lower(stencils.get(key, shape=SMALL_2D, iterations=4)).spec,
                boundary=Boundary(kind),
            )
            bucket = tuple(n + STREAMED_BUCKET_PAD for n in SMALL_2D)
            streamed.append((spec, bucket_plan(spec, bucket, iterations=4,
                                               wrap_rounds=wrap)))
    t0 = time.perf_counter()
    libs = cuda_build.build_many(small + [p.mspec for _, p in streamed],
                                 ptxas_info=True)
    ptxas = [ln.strip() for ln in libs[0].build_log.splitlines() if "registers" in ln]
    emit(phase="build", kernels=len({lib.key for lib in libs}),
         seconds=round(time.perf_counter() - t0, 3), ptxas_jacobi2d=ptxas)

    # ---- 3. small: kernel vs plain, K2 vs K1 ------------------------------
    def small_variants(spec):
        """The spec on its small grid and on the larger one (bf16 keeps
        its own), each with the default tile and the taller one."""
        shapes = [tuple(spec.shape)]
        if spec.dtype == "float32":
            shapes.append(LARGER_3D if spec.ndim == 3 else LARGER_2D)
        for shape in shapes:
            sp = dataclasses.replace(spec, inputs={
                n: (dt, shape) for n, (dt, _) in spec.inputs.items()})
            for rows in (0, TALL_ROWS[sp.ndim]):
                yield sp, stencil.default_tile(sp.ndim, rows)

    kinds = set()
    for spec0 in small:
        kinds.add(spec0.boundary.kind)
        errs, bitwise, runs = [], True, []
        for spec, tile in small_variants(spec0):
            arrays = inputs(spec, batch=3)
            t = ops.to_device(spec, arrays, dev)
            for s in SMALL_S:
                if stencil.smem_bytes_estimate(spec, s, tile) > gpu.smem_per_block:
                    continue
                runs.append([list(spec.shape), list(tile), s])
                per_entry = []
                for b in range(3):
                    one = {n: a[b] for n, a in t.items()}
                    got = stencil.stencil_cuda(spec, one, s, tile)
                    want = stencil.stencil_torch_tiled(spec, one, s, tile)
                    torch.cuda.synchronize()
                    err = max_err(got, want)
                    scale = max(1.0, float(want.float().abs().max()))
                    check(err <= TOL[spec.dtype] * scale,
                          f"{spec.name} {spec.shape} tile={tile} s={s}: kernel "
                          f"vs plain {err} > {TOL[spec.dtype]} x {scale}")
                    errs.append(err / scale)
                    per_entry.append(got)
                both = pipeline.stencil_cuda_batched(spec, t, s, tile)
                torch.cuda.synchronize()
                bitwise &= all(torch.equal(both[b], per_entry[b]) for b in range(3))
        check(bitwise, f"{spec0.name}: K2 differs from K1 per entry")
        emit(phase="small", spec=spec0.name, boundary=spec0.boundary.kind,
             dtype=spec0.dtype, runs=len(runs), shapes_tiles_s=runs,
             max_rel_err=max(errs), tol=TOL[spec0.dtype], k2_bitwise=bitwise)
    check(kinds == {"zero", "constant", "replicate", "periodic"},
          f"boundary kinds covered: {sorted(kinds)}")

    # streamed bucket specs: three entries with their own maps (a full
    # grid, a smaller one, the all-zero batch filler)
    streamed_err = 0.0
    for spec, plan in streamed:
        mspec = plan.mspec
        entries = []
        for cut in (0, 5):
            shape = tuple(n - cut for n in spec.shape)
            e = {n: plan.place_entry(rng.standard_normal(shape).astype(np.float32))
                 for n in spec.inputs}
            e.update(plan.service_entry(shape))
            entries.append(e)
        filler = {n: plan.filler_entry(n) for n in spec.inputs}
        filler.update(plan.service_filler())
        entries.append(filler)
        check(all(not np.any(filler[n]) for n in plan.service_names),
              "the filler entry carries all-zero service arrays")
        t = ops.to_device(mspec, {n: np.stack([e[n] for e in entries])
                                  for n in mspec.inputs}, dev)
        errs, bitwise = [], True
        for tile in (None, (16, 16)):    # (16, 16): tiles wholly in padding
            for s in SMALL_S:
                both = pipeline.stencil_cuda_batched(mspec, t, s, tile)
                for b in range(3):
                    one = {n: a[b] for n, a in t.items()}
                    got = stencil.stencil_cuda(mspec, one, s, tile)
                    want = stencil.stencil_torch_tiled(mspec, one, s, tile)
                    torch.cuda.synchronize()
                    scale = max(1.0, float(want.abs().max()))
                    errs.append(max_err(got, want) / scale)
                    bitwise &= torch.equal(both[b], got)
        rounds = pipeline.stencil_run_batched(mspec, t, 4, s=1)
        rounds_plain = ops.run_rounds(mspec, t, 4, 1,
                                      pipeline.stencil_torch_pipeline)
        scale = max(1.0, float(rounds_plain.abs().max()))
        errs.append(max_err(rounds, rounds_plain) / scale)
        check(max(errs) <= TOL[mspec.dtype],
              f"{mspec.name}: streamed kernel vs plain {max(errs)}")
        check(bitwise, f"{mspec.name}: K2 differs from K1 per entry")
        streamed_err = max(streamed_err, max(errs))
        emit(phase="small", spec=mspec.name, boundary=spec.boundary.kind,
             streamed=list(plan.service_names), bucket=list(plan.bucket),
             dtype=mspec.dtype, s=list(SMALL_S), tiles=["default", [16, 16]],
             rounds_iterations=4,
             max_rel_err=max(errs), tol=TOL[mspec.dtype], k2_bitwise=bitwise)

    # ---- 4. main path -----------------------------------------------------
    k1_main_launches = 0
    for key, shape in MAIN_CASES:
        text = dsl.format_spec(stencils.get(key, shape=shape, iterations=ITERATIONS))
        arrays = inputs(stencils.get(key, shape=shape))
        stencil.stencil_cuda.launches = 0
        pipeline.stencil_cuda_batched.launches = 0
        t0 = time.perf_counter()
        design = autotune(text, device="cuda")
        out = design.runner(arrays)
        wall = time.perf_counter() - t0
        launches = {"stencil_cuda": stencil.stencil_cuda.launches,
                    "stencil_cuda_batched": pipeline.stencil_cuda_batched.launches}
        spec, cfg, run = design.spec, design.config, design.runner
        want_kernel = "stencil_cuda" if run.path == "single_pe" else "stencil_cuda_batched"
        check(launches[want_kernel] > 0, f"{key}: {want_kernel} never launched")
        k1_main_launches += launches["stencil_cuda"]
        check(out.shape == tuple(shape) and bool(np.isfinite(out).all()),
              f"{key}: output shape {out.shape} or non-finite values")
        t = ops.to_device(spec, arrays, dev)
        plain = plain_run(spec, t, ITERATIONS, cfg.s, run.batched.tile)
        err = float(np.abs(out - plain.cpu().numpy()).max())
        scale = max(1.0, float(plain.abs().max()))
        check(err <= TOL[spec.dtype] * scale,
              f"{key} {shape}: main path vs plain {err} > tol x {scale}")
        staged = run.batched.stage({n: a[None] for n, a in arrays.items()})
        ms = timed(lambda: run.batched.dispatch(staged), reps=10, inner=5)
        plain_ms = timed(lambda: plain_run(spec, t, ITERATIONS, cfg.s,
                                           run.batched.tile), reps=3, warm=1)
        b_ms, b_by = bound_ms(spec, 1, ITERATIONS)
        nbytes = (spec.num_inputs + 1) * spec.cells * spec.itemsize
        emit(phase="main", spec=spec.name, shape=list(shape),
             iterations=ITERATIONS,
             config=dict(s=cfg.s, tile=list(run.batched.tile),
                         buffer_depth=cfg.buffer_depth),
             path=run.path, launches=launches, first_call_s=round(wall, 3),
             max_abs_err=err, scale=scale, ms=ms, plain_ms=plain_ms,
             bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms,
             gb_per_s=nbytes / ms / 1e6,
             predicted_ms=design.prediction.latency * 1e3,
             predicted_hbm_mb=design.prediction.hbm_bytes / 1e6,
             cell_updates=design.prediction.cell_updates)

    # the model against the kernel at every fusion depth and tile it ranks
    spec = lower(stencils.jacobi2d(shape=(4096, 4096), iterations=ITERATIONS)).spec
    t = ops.to_device(spec, inputs(spec), dev)
    tuned = autotune(spec, device="cuda", build=False)
    sweep, fit = [], []
    for pred in tuned.ranking:
        if pred.config.buffer_depth:
            continue
        s, tile = pred.config.s, stencil.default_tile(2, pred.config.tile_rows)
        ms = timed(lambda: ops.stencil_run(spec, t, ITERATIONS, s=s, tile=tile),
                   reps=10, inner=3)
        sweep.append((ms, s, tile))
        emit(phase="sweep", spec=spec.name, shape=[4096, 4096],
             iterations=ITERATIONS, s=s, tile=list(tile),
             smem_bytes=stencil.smem_bytes_estimate(spec, s, tile), ms=ms,
             predicted_ms=pred.latency * 1e3,
             predicted_compute_ms=pred.compute_term * 1e3,
             predicted_memory_ms=pred.memory_term * 1e3,
             cell_updates=pred.cell_updates,
             measured_s_per_update=ms * 1e-3 / pred.cell_updates,
             resident_blocks=resident_blocks(int(pred.smem_bytes), gpu),
             ranked_first=pred is tuned.prediction)
        if s >= 4 and resident_blocks(int(pred.smem_bytes), gpu) >= gpu.full_rate_blocks:
            fit.append((ms - pred.memory_term * 1e3) * 1e-3 / pred.cell_updates)
    best = min(sweep)
    picked = next(m for m, s, tile in sweep
                  if (s, tile) == (tuned.config.s, stencil.default_tile(
                      2, tuned.config.tile_rows)))
    emit(phase="sweep_summary", picked=dict(s=tuned.config.s,
         tile_rows=tuned.config.tile_rows), picked_ms=picked,
         fastest=dict(s=best[1], tile=list(best[2])), fastest_ms=best[0],
         picked_over_fastest=picked / best[0],
         # the ranker's cell_update_s as this run measures it (s >= 4,
         # full-rate occupancy): (measured - memory term) / updates
         fitted_s_per_update=float(np.median(fit)) if fit else None,
         platform_s_per_update=gpu.cell_update_s)

    # ---- 5. batched: K2 on a batch of 8 ------------------------------------
    spec = lower(stencils.jacobi2d(shape=(9720, 1024), iterations=ITERATIONS)).spec
    cfg_main = autotune(spec, device="cuda", build=False).config
    s_main = cfg_main.s
    run = build_batched_runner(
        spec, ParallelismConfig("temporal", s=s_main, buffer_depth=2,
                                tile_rows=cfg_main.tile_rows),
        device="cuda",
    )
    batch = inputs(spec, batch=8)
    stencil.stencil_cuda.launches = 0
    pipeline.stencil_cuda_batched.launches = 0
    out = run(batch)
    k2_main_launches = pipeline.stencil_cuda_batched.launches
    check(run.path == "tile_pipeline" and k2_main_launches > 0
          and stencil.stencil_cuda.launches == 0,
          f"batched runner went through {run.path}")
    t = ops.to_device(spec, batch, dev)
    per_entry = torch.stack([
        ops.stencil_run(spec, {n: a[b] for n, a in t.items()}, ITERATIONS,
                        s=s_main, tile=run.tile, backend="cuda")
        for b in range(8)
    ])
    k2_bitwise = bool(np.array_equal(out, per_entry.cpu().numpy()))
    check(k2_bitwise, "K2 batch differs from K1 per entry")
    one_round = lambda: pipeline.stencil_cuda_batched(spec, t, s_main, run.tile)
    k2_out = one_round()
    k2_plain = pipeline.stencil_torch_pipeline(spec, t, s_main, run.tile)
    k2_err = max_err(k2_out, k2_plain)
    check(k2_err <= TOL[spec.dtype] * max(1.0, float(k2_plain.abs().max())),
          f"K2 vs plain {k2_err}")
    round_ms = timed(one_round, reps=10, inner=5)
    # K2 at s=1 against one F.conv2d over the batch (its yardstick)
    xb = t["in_1"].view(8, 1, *spec.shape)
    w5 = torch.tensor([[0.0, 1.0, 0.0], [1.0, 1.0, 1.0], [0.0, 1.0, 0.0]],
                      device=dev).div_(5).view(1, 1, 3, 3)
    k2_s1 = lambda: pipeline.stencil_cuda_batched(spec, t, 1, run.tile)
    k2_conv = lambda: F.conv2d(xb, w5, padding=1)
    conv_err = max_err(k2_conv().view(8, *spec.shape), k2_s1())
    check(conv_err <= 1e-5 * max(1.0, float(xb.abs().max())),
          f"batched conv2d yardstick computes another function: {conv_err}")
    k2_ms = timed(k2_s1, reps=10, inner=10)
    k2_library_ms = timed(k2_conv, reps=10, inner=10)
    k2_plain_ms = timed(lambda: pipeline.stencil_torch_pipeline(
        spec, t, 1, run.tile), reps=3, warm=1)
    k2_bound, k2_by = bound_ms(spec, 8, 1)
    emit(phase="batched", spec=spec.name, batch=8, s=s_main,
         tile=list(run.tile), launches=k2_main_launches,
         k2_bitwise_vs_k1=k2_bitwise, round_ms=round_ms,
         max_abs_err=k2_err, s1_ms=k2_ms, s1_plain_ms=k2_plain_ms,
         s1_library_ms=k2_library_ms, s1_bound_ms=k2_bound, s1_bound_by=k2_by,
         conv_vs_kernel_err=conv_err, cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         run_ms=timed(lambda: run.dispatch(run.stage(batch)), reps=5, warm=1))

    # ---- 6. yardstick: one JACOBI2D iteration against F.conv2d -------------
    spec = lower(stencils.jacobi2d(shape=(4096, 4096), iterations=1)).spec
    t = ops.to_device(spec, inputs(spec), dev)
    x = t["in_1"]
    k1_out = stencil.stencil_cuda(spec, t, 1)
    k1_plain = stencil.stencil_torch_tiled(spec, t, 1)
    k1_err = max_err(k1_out, k1_plain)
    check(k1_err <= TOL["float32"] * max(1.0, float(k1_plain.abs().max())),
          f"K1 vs plain at 4096x4096: {k1_err}")
    w = torch.tensor([[0.0, 1.0, 0.0], [1.0, 1.0, 1.0], [0.0, 1.0, 0.0]],
                     device=dev).div_(5).view(1, 1, 3, 3)
    conv = lambda: F.conv2d(x.view(1, 1, 4096, 4096), w, padding=1)
    conv_err = max_err(conv().view(4096, 4096), k1_out)
    check(conv_err <= 1e-5 * max(1.0, float(k1_out.abs().max())),
          f"conv2d yardstick computes another function: {conv_err}")
    k1_ms = timed(lambda: stencil.stencil_cuda(spec, t, 1), reps=20, inner=10)
    k1_plain_ms = timed(lambda: stencil.stencil_torch_tiled(spec, t, 1), reps=5)
    library_ms = timed(conv, reps=20, inner=10)
    k1_bound, k1_by = bound_ms(spec, 1, 1)
    emit(phase="yardstick", spec=spec.name, shape=[4096, 4096], s=1,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32, ms=k1_ms,
         plain_ms=k1_plain_ms, library_ms=library_ms, bound_ms=k1_bound,
         bound_by=k1_by, conv_vs_kernel_err=conv_err)


    # ---- 7. serve: bucketed serving at the paper's width -------------------
    def serve_spec(mode, shape):
        return dsl.parse(BOUNDARY_DSL.format(
            tag=mode.split()[0].upper(), it=ITERATIONS, boundary=mode,
            r=shape[0], c=shape[1]))

    srv = StencilServer(device="cuda", max_batch=4, cache=DesignCache(),
                        bucketing=ShapeBucketer(ladder=SERVE_LADDER),
                        async_dispatch=True, warmup=False)
    srng = np.random.default_rng(2022)
    paper = (9720, 1024)
    traffic = {}
    for mode in SERVE_MODES:
        shapes = [paper] + [
            (int(srng.integers(8000, 9721)), int(srng.integers(768, 1025)))
            for _ in range(SERVE_SHAPES - 1)
        ]
        reg = srv.register(mode.split()[0], serve_spec(mode, paper))
        traffic[mode] = [
            (shape, {"in_1": srng.standard_normal(shape).astype(np.float32)})
            for shape in shapes for _ in range(SERVE_REPEATS)
        ]
        for shape in shapes:      # route every shape: bucket designs exist
            reg.cached.runner_for(shape, count=0)
    bucket_specs = [e.cached.design.spec for m in SERVE_MODES
                    for e in srv.design(m.split()[0]).cached.buckets.values()]
    t0 = time.perf_counter()
    cuda_build.build_many(bucket_specs)
    emit(phase="serve_build", kernels=len({cuda_build.kernel_key(sp)
                                          for sp in bucket_specs}),
         seconds=time.perf_counter() - t0)
    serve_launches = {"stencil_cuda": 0, "stencil_cuda_batched": 0}
    serve_err = 0.0
    served = {}     # mode -> serve()'s results, held by phases 12 and 13
    for mode in SERVE_MODES:
        name = mode.split()[0]
        reqs = [StencilRequest(name, arrays) for _, arrays in traffic[mode]]
        before = srv.stats()[name]["batches"]
        torch.cuda.synchronize()
        stencil.stencil_cuda.launches = 0
        pipeline.stencil_cuda_batched.launches = 0
        t0 = time.perf_counter()
        outs = srv.serve(reqs)
        flush_s = time.perf_counter() - t0
        served[mode] = outs
        launches = {"stencil_cuda": stencil.stencil_cuda.launches,
                    "stencil_cuda_batched": pipeline.stencil_cuda_batched.launches}
        check(sum(launches.values()) > 0, f"serve {mode}: no kernel launched")
        for k, v in launches.items():
            serve_launches[k] += v
        bd = srv.design(name).cached
        batches = srv.stats()[name]["batches"] - before
        per_bucket = {}
        for shape, _ in traffic[mode]:
            b = bd.bucket_for(shape)
            per_bucket[b] = per_bucket.get(b, 0) + 1
        dispatched = sum(-(-n // srv.max_batch) * srv.max_batch * math.prod(b)
                         for b, n in per_bucket.items())
        real = sum(math.prod(shape) for shape, _ in traffic[mode])
        err, bitwise = 0.0, True
        for (shape, arrays), out in zip(traffic[mode], outs):
            sp = serve_spec(mode, shape)
            check(out.shape == shape and bool(np.isfinite(out).all()),
                  f"serve {mode} {shape}: shape {out.shape} or non-finite")
            entry = bd.runner_for(shape, count=0)
            minimal = padded_request_shape(sp, shape, ITERATIONS, bd.wrap_rounds)
            single = build_bucket_runner(
                sp, minimal, entry.config, iterations=ITERATIONS,
                device="cuda", wrap_rounds=bd.wrap_rounds,
            )({n: a[None] for n, a in arrays.items()})[0]
            bitwise &= bool(np.array_equal(out, single))
            low = lower(sp).spec
            t = ops.to_device(low, arrays, dev)
            plain = plain_run(low, t, ITERATIONS, entry.config.s, entry.runner.tile)
            scale = max(1.0, float(plain.abs().max()))
            err = max(err, float(np.abs(out - plain.cpu().numpy()).max()) / scale)
        # device time of one full micro-batch of the most used bucket
        # (CUDA events around the dispatch of staged inputs)
        top = max(per_bucket, key=per_bucket.get)
        chunk = [(i, r, shape) for i, (r, (shape, _)) in
                 enumerate(zip(reqs, traffic[mode])) if bd.bucket_for(shape) == top]
        runner, stacked, _, _ = srv._prepare(srv.design(name), top,
                                             chunk[:srv.max_batch])
        staged = runner.stage(stacked)
        batch_ms = timed(lambda: runner.dispatch(staged), reps=3, warm=1)
        check(bitwise, f"serve {mode}: differs from single-shot bucket runner")
        check(err <= TOL["float32"], f"serve {mode}: vs plain {err}")
        serve_err = max(serve_err, err)
        emit(phase="serve", mode=mode, iterations=ITERATIONS,
             requests=len(reqs), shapes=sorted({s for s, _ in traffic[mode]}),
             micro_batches=batches, buckets_built=bd.num_buckets,
             buckets=["x".join(map(str, b)) for b in per_bucket],
             config=dict(s=entry.config.s, buffer_depth=entry.config.buffer_depth),
             wrap_rounds=bd.wrap_rounds, path=entry.runner.path,
             launches=launches, flush_s=flush_s, grids_per_s=len(reqs) / flush_s,
             micro_batch_device_ms=batch_ms,
             device_busy_share=batches * batch_ms / 1e3 / flush_s,
             padded_cell_share=1.0 - real / dispatched,
             bitwise_vs_single_shot=bitwise, max_rel_err=err, tol=TOL["float32"])

    # ---- 8. distribute: the five parallelisms on 4 logical devices -------
    pool = [dev] * DIST_POOL
    on_pool = dict(logical_devices=len(pool),
                   physical_devices=len(set(pool)))
    gpu_pool = gpu.with_gpus(DIST_POOL)
    dist_cfgs = [
        ParallelismConfig("spatial_s", k=4),
        ParallelismConfig("spatial_r", k=4),
        ParallelismConfig("hybrid_s", k=4, s=4),
        ParallelismConfig("hybrid_r", k=4, s=4),
        ParallelismConfig("temporal", s=4),
    ]

    def kernel_launches():
        return stencil.stencil_cuda.launches + pipeline.stencil_cuda_batched.launches

    for key, shape in DIST_CASES:
        spec = lower(stencils.get(key, shape=shape, iterations=ITERATIONS)).spec
        arrays = inputs(spec)
        want = ref.stencil_iterations_ref(
            spec, ops.to_device(spec, arrays, dev), ITERATIONS).cpu().numpy()
        scale = max(1.0, float(np.abs(want).max()))
        for cfg in dist_cfgs:
            run = distribute.build_runner(spec, cfg, iterations=ITERATIONS,
                                          devices=pool)
            staged = run.stage(arrays)
            torch.cuda.synchronize()
            stencil.stencil_cuda.launches = 0
            pipeline.stencil_cuda_batched.launches = 0
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            pending = run.dispatch(staged)
            b.record()
            out = run.finalize(pending)
            launched = kernel_launches()
            halo_bytes = run.halo_bytes
            err = float(np.abs(out - want).max()) / scale
            check(out.shape == tuple(shape) and bool(np.isfinite(out).all()),
                  f"distribute {key} {cfg.variant}: shape or non-finite")
            check(err <= TOL["float32"],
                  f"distribute {key} {cfg.variant}: vs oracle {err}")
            check(launched == 0, f"distribute {key}: the shard path launched "
                  f"{launched} tile kernels")
            # the temporal pipeline takes seconds (host-bound, see PERF.md):
            # its one checked run is its sample
            ms = a.elapsed_time(b) if cfg.variant == "temporal" else timed(
                lambda: run.dispatch(staged), reps=3, warm=1)
            # the ranker prices a temporal design as the tile kernel that
            # runs it, not this pipeline; a row partition as it runs here
            # (its host term is the same on one card as on four)
            pred = (None if cfg.variant == "temporal" else
                    model.predict_gpu(spec, cfg, gpu_pool, ITERATIONS))
            emit(phase="distribute", spec=spec.name, shape=list(shape),
                 iterations=ITERATIONS, variant=cfg.variant, k=cfg.k, s=cfg.s,
                 **on_pool, path=run.path, backend=run.backend,
                 kernel_launches=launched, ms=ms, halo_bytes=halo_bytes,
                 max_rel_err=err, tol=TOL["float32"],
                 predicted_4gpu_ms=pred and pred.latency * 1e3,
                 predicted_host_ms=pred and pred.host_term * 1e3,
                 predicted_launches=pred and pred.launches)
    spec = lower(stencils.jacobi2d(shape=(9720, 1024), iterations=ITERATIONS)).spec
    cfg = ParallelismConfig("hybrid_s", k=4, s=4)
    batch = inputs(spec, batch=2)
    both = distribute.build_runner(spec, cfg, iterations=ITERATIONS,
                                   devices=pool, batched=True)(batch)
    single = distribute.build_runner(spec, cfg, iterations=ITERATIONS,
                                     devices=pool)
    dist_bitwise = all(np.array_equal(both[b], single({"in_1": batch["in_1"][b]}))
                       for b in range(2))
    check(dist_bitwise, "distribute: batched entries differ from single grids")
    emit(phase="distribute_batched", spec=spec.name, batch=2,
         variant=cfg.variant, k=cfg.k, s=cfg.s, **on_pool,
         bitwise_vs_single_grid=dist_bitwise)

    # ---- 9. degraded: a k=4 design on the real pool of one card ----------
    x = inputs(spec)
    cfg = ParallelismConfig("hybrid_s", k=4, s=8)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run = build_batched_runner(spec, cfg, iterations=ITERATIONS)
    warned = any(issubclass(w.category, DegradedDesignWarning) for w in caught)
    stencil.stencil_cuda.launches = 0
    pipeline.stencil_cuda_batched.launches = 0
    out = run({"in_1": x["in_1"][None]})[0]
    degraded_launches = stencil.stencil_cuda.launches
    k1 = ops.stencil_run(spec, x, ITERATIONS, s=8, tile=run.tile,
                         backend="cuda").cpu().numpy()
    try:
        build_batched_runner(spec, cfg, iterations=ITERATIONS, strict=True)
        strict_raised = False
    except ValueError:
        strict_raised = True
    check(warned and run.degraded and run.n_devices == 1,
          f"degraded: warned={warned} degraded={run.degraded} "
          f"n_devices={run.n_devices}")
    check(degraded_launches > 0, "degraded: K1 never launched")
    check(bool(np.array_equal(out, k1)), "degraded: differs from temporal(s=8) K1")
    check(strict_raised, "degraded: strict=True did not raise")
    emit(phase="degraded", spec=spec.name, variant=cfg.variant, k=cfg.k,
         s=cfg.s, pool=[str(d) for d in run.devices],
         devices_requested=run.devices_requested, n_devices=run.n_devices,
         path=run.path, tile=list(run.tile), warned=warned,
         stencil_cuda_launches=degraded_launches,
         bitwise_vs_temporal_k1=True, strict_raised=strict_raised)

    # ---- 10. rank_pool: SASA's design space against SODA's ----------------
    text = dsl.format_spec(stencils.jacobi2d(shape=(9720, 1024),
                                             iterations=ITERATIONS))
    def described(i, p):
        return dict(rank=i, variant=p.config.variant, k=p.config.k,
                    s=p.config.s, tile_rows=p.config.tile_rows,
                    buffer_depth=p.config.buffer_depth,
                    predicted_ms=p.latency * 1e3,
                    host_ms=p.host_term * 1e3,
                    collective_ms=p.collective_term * 1e3)

    for name, tune in (("autotune", autotune), ("soda_baseline", soda_baseline)):
        td = tune(text, devices=pool, build=False)
        shard = next(((i, p) for i, p in enumerate(td.ranking)
                      if p.config.k > 1), None)
        emit(phase="rank_pool", ranker=name, spec=td.spec.name,
             shape=[9720, 1024], iterations=ITERATIONS, **on_pool,
             candidates=len(td.ranking),
             top=[described(i, p) for i, p in enumerate(td.ranking[:5])],
             best_shard=shard and described(*shard))
    # the chosen design, built on the pool, runs the tile kernel
    design = autotune(text, devices=pool)
    stencil.stencil_cuda.launches = 0
    pipeline.stencil_cuda_batched.launches = 0
    out = design.runner(inputs(design.spec))
    pool_launches = kernel_launches()
    run = design.runner.batched
    check(run.path in ("single_pe", "tile_pipeline") and pool_launches > 0,
          f"rank_pool: the design built on the pool ran {run.path} with "
          f"{pool_launches} tile-kernel launches")
    check(bool(np.isfinite(out).all()), "rank_pool: non-finite output")
    emit(phase="rank_pool_build", variant=design.config.variant,
         k=design.config.k, s=design.config.s, **on_pool, path=run.path,
         n_devices=run.n_devices, degraded=run.degraded,
         tile_kernel_launches=pool_launches)

    # ---- 11. cold_start: two fresh replicas over one store ---------------
    cold_dir = root / "build" / "cold_start"
    shutil.rmtree(cold_dir, ignore_errors=True)
    cold_dir.mkdir(parents=True)
    sides = {}
    for side in ("cold", "warm"):
        out_npy, report = cold_dir / f"{side}.npy", cold_dir / f"{side}.json"
        subprocess.run(
            [sys.executable, str(Path(__file__).resolve()),
             "--cold-start-child", str(cold_dir / "store"),
             str(cold_dir / f"kernels_{side}"), str(out_npy), str(report)],
            check=True, timeout=600,
        )
        sides[side] = (np.load(out_npy), json.loads(report.read_text()))
    (out_cold, cold), (out_warm, warm) = sides["cold"], sides["warm"]
    cold_bitwise = bool(np.array_equal(out_cold, out_warm))
    check(cold["autotune_calls"] >= 1 and cold["jit_builds"] >= 1,
          f"cold_start: the cold side ranked {cold['autotune_calls']}x and "
          f"compiled {cold['jit_builds']}x")
    check(warm["autotune_calls"] == 0 and warm["jit_builds"] == 0
          and warm["nvcc_compiles"] == 0,
          f"cold_start: the warm side ranked {warm['autotune_calls']}x and "
          f"compiled {warm['jit_builds']}x")
    check(warm["store_hits"] >= 1 and warm["store"]["executable_hits"] >= 1,
          f"cold_start: the warm side missed the store: {warm['store']}")
    check(cold_bitwise and cold["finite"], "cold_start: warm result differs")
    check(all(sum(x["launches"].values()) > 0 for x in (cold, warm)),
          "cold_start: a side never launched the tile kernel")
    emit(phase="cold_start", spec="JACOBI2D", shape=[9720, 1024],
         iterations=ITERATIONS, cold=cold, warm=warm,
         cold_over_warm=cold["first_result_s"] / warm["first_result_s"],
         bitwise=cold_bitwise)

    # ---- 12. scheduler: continuous batching over phase serve's server ----
    from repro_torch.serve import StencilScheduler

    trace = [(mode, StencilRequest(mode.split()[0], arrays), i)
             for mode in SERVE_MODES
             for i, (_, arrays) in enumerate(traffic[mode])]
    torch.cuda.synchronize()
    stencil.stencil_cuda.launches = 0
    pipeline.stencil_cuda_batched.launches = 0
    t0 = time.perf_counter()
    with StencilScheduler(srv) as sched:
        tickets = [sched.submit(req) for _, req, _ in trace]
        sched.drain()
    sched_s = time.perf_counter() - t0
    sched_launches = {"stencil_cuda": stencil.stencil_cuda.launches,
                      "stencil_cuda_batched": pipeline.stencil_cuda_batched.launches}
    st = sched.stats()
    check(all(t.done() and t.exception() is None for t in tickets)
          and st["completed"] == len(trace) and st["failed"] == 0,
          f"scheduler: dropped or failed requests: {st}")
    sched_bitwise = all(np.array_equal(t.result(), served[mode][i])
                        for t, (mode, _, i) in zip(tickets, trace))
    check(sched_bitwise, "scheduler: differs from synchronous serve()")
    check(sum(sched_launches.values()) > 0, "scheduler: no kernel launched")
    emit(phase="scheduler", requests=len(trace), seconds=sched_s,
         grids_per_s=len(trace) / sched_s,
         dispatched_batches=st["dispatched_batches"],
         deadline_misses=st["deadline_misses"], launches=sched_launches,
         bitwise_vs_serve=sched_bitwise)

    # the open-loop Poisson trace of benchmarks/serving_latency.py
    lrng = np.random.default_rng(42)
    lat_designs = {
        "jac_s": stencils.jacobi2d(shape=(64, 32), iterations=4),
        "jac_l": stencils.jacobi2d(shape=(96, 48), iterations=4),
        "hot_s": stencils.hotspot(shape=(64, 32), iterations=4),
        "hot_l": stencils.hotspot(shape=(96, 48), iterations=4),
    }
    names = sorted(lat_designs)
    arrivals = np.cumsum(lrng.exponential(1.0 / 300.0, size=240))
    lat_trace = []
    for t_arr in arrivals:
        name = names[int(lrng.integers(len(names)))]
        lat_trace.append((float(t_arr), StencilRequest(name, {
            k: lrng.standard_normal(shape).astype(dt)
            for k, (dt, shape) in lat_designs[name].inputs.items()})))
    lat_cache = DesignCache()

    def lat_server():
        server = StencilServer(device="cuda", max_batch=4, cache=lat_cache)
        for name, sp in lat_designs.items():
            server.register(name, sp)
        return server

    def pct(xs, q):
        return float(np.percentile(np.asarray(xs), q)) * 1e3

    fsrv, pending, flush_lat = lat_server(), {}, []
    t0 = last = time.monotonic()
    for arrive_s, req in lat_trace:
        delay = t0 + arrive_s - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        pending[fsrv.submit(req)] = t0 + arrive_s
        if time.monotonic() - last >= 0.1:
            done = fsrv.flush()
            now = last = time.monotonic()
            flush_lat += [now - pending.pop(k) for k in done if k in pending]
    done = fsrv.flush()
    now = time.monotonic()
    flush_lat += [now - pending.pop(k) for k in done if k in pending]
    flush_span = now - t0
    check(not pending and len(flush_lat) == len(lat_trace),
          f"latency: the flush baseline lost {len(pending)} requests")
    csrv, fired = lat_server(), []
    with StencilScheduler(csrv) as lsched:
        t0 = time.monotonic()
        for arrive_s, req in lat_trace:
            delay = t0 + arrive_s - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            fired.append((t0 + arrive_s, lsched.submit(req), req))
        lsched.drain()
        cont_span = time.monotonic() - t0
    check(all(t.done() and t.exception() is None for _, t, _ in fired),
          "latency: the scheduler dropped or failed requests")
    cont_lat = [t.completed_at - due for due, t, _ in fired]
    rsrv = lat_server()
    lat_bitwise = all(np.array_equal(t.result(), rsrv.serve([req])[0])
                      for _, t, req in fired[::5])
    check(lat_bitwise, "latency: a scheduled result differs from serve()")
    emit(phase="latency", requests=len(lat_trace), rate_hz=300.0,
         designs=names, flush_interval_s=0.1,
         flush_grids_per_s=len(lat_trace) / flush_span,
         flush_p50_ms=pct(flush_lat, 50), flush_p99_ms=pct(flush_lat, 99),
         continuous_grids_per_s=len(lat_trace) / cont_span,
         continuous_p50_ms=pct(cont_lat, 50),
         continuous_p99_ms=pct(cont_lat, 99),
         continuous_batches=lsched.stats()["dispatched_batches"],
         bitwise_vs_serve_sampled=len(fired[::5]))

    # ---- 13. router: two workers on this card over one store -------------
    from repro_torch.serve import StencilRouter

    router_dir = root / "build" / "router_store"
    shutil.rmtree(router_dir, ignore_errors=True)
    ladder = ShapeBucketer(ladder=SERVE_LADDER)
    t0 = time.perf_counter()
    router = StencilRouter(router_dir, replicas=2, max_batch=4, warmup=True,
                           device="cuda")
    try:
        spawn_s = time.perf_counter() - t0
        for mode in SERVE_MODES:
            router.register(mode.split()[0], serve_spec(mode, paper),
                            bucketing=ladder)
        register_s = time.perf_counter() - t0 - spawn_s
        after_register = router.ping()
        second = after_register["replica-1"]
        check(second["cache"]["jit_builds"] == 0
              and second["cache"]["autotune_calls"] == 0
              and second["store"]["executable_hits"] >= 1,
              f"router: the second worker did not start warm: {second}")
        reqs = [req for _, req, _ in trace]
        t0 = time.perf_counter()
        outs = router.serve(reqs)
        route_s = time.perf_counter() - t0
        router_bitwise = all(np.array_equal(o, served[mode][i])
                             for o, (mode, _, i) in zip(outs, trace))
        check(router_bitwise, "router: differs from the in-process server")
        before_kill = router.ping()
        # kill the owner of one design with the trace in flight
        futures = [router.submit(req) for req in reqs]
        owner = router._route("zero")
        with router._lock:
            in_flight = sum(1 for _, rep in router._pending.values()
                            if rep is owner)
        owner.proc.kill()
        handed = [f.result(timeout=600.0) for f in futures]
        handoff_bitwise = all(np.array_equal(o, served[mode][i])
                              for o, (mode, _, i) in zip(handed, trace))
        check(not owner.healthy, "router: the killed worker was not detected")
        check(in_flight >= 1, "router: nothing was in flight at the kill")
        check(handoff_bitwise, "router: a handed-off result differs")
        after_kill = router.ping()
    finally:
        router.close()
    check(all(r.proc.poll() is not None for r in router._replicas),
          "router: close() left a worker running")
    emit(phase="router", replicas=2, device="cuda", requests=len(reqs),
         spawn_s=spawn_s, register_s=register_s, route_s=route_s,
         grids_per_s=len(reqs) / route_s, bitwise_vs_serve=router_bitwise,
         per_replica={n: dict(completed=i["scheduler"]["completed"],
                              launches=i["launches"], cache=i["cache"],
                              store=i["store"])
                      for n, i in before_kill.items()},
         killed=owner.name, in_flight_at_kill=in_flight,
         handoff_bitwise=handoff_bitwise,
         survivor={n: dict(completed=i["scheduler"]["completed"],
                           launches=i["launches"])
                   for n, i in after_kill.items() if i["healthy"]})

    kernels = [
        dict(name="stencil_cuda", route="cuda",
             source="src/repro_torch/kernels/csrc/stencil_tile.cuh",
             replaces="src/repro/kernels/stencil.py:96",
             launches=k1_main_launches, max_abs_err=k1_err, ms=k1_ms,
             plain_ms=k1_plain_ms, bound_ms=k1_bound, bound_by=k1_by,
             bound_share=k1_bound / k1_ms, library_ms=library_ms,
             serve_launches=serve_launches["stencil_cuda"],
             streamed_max_rel_err=streamed_err),
        dict(name="stencil_cuda_batched", route="cuda",
             source="src/repro_torch/kernels/csrc/stencil_tile.cuh",
             replaces="src/repro/kernels/pipeline.py:85",
             launches=k2_main_launches, max_abs_err=k2_err, ms=k2_ms,
             plain_ms=k2_plain_ms, bound_ms=k2_bound, bound_by=k2_by,
             bound_share=k2_bound / k2_ms, library_ms=k2_library_ms,
             serve_launches=serve_launches["stencil_cuda_batched"],
             streamed_max_rel_err=streamed_err),
    ]
    check(all(k["launches"] > 0 for k in kernels), "a kernel never launched")
    emit(kernels=kernels)
    emit(ok=True, device={"platform": "gpu", "kind": card,
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cold-start-child"]:
        sys.exit(cold_start_child(*sys.argv[2:6]))
    sys.exit(main())
