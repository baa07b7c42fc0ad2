"""Quickest proof that the PyTorch/CUDA port starts and is right on one GPU.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py

It builds the CUDA tile kernels from ``src/repro_torch/kernels/csrc`` into
``build/repro_torch_kernels/`` (one ``nvcc`` per kernel, all at once), then
runs six phases, each printing JSON lines:

  1. device    the card's name and power limit (``nvidia-smi``), versions;
  2. build     kernels built and seconds;
  3. small     every stock kernel at s in {1, 2, 4} (all four boundary
               kinds) and a bfloat16 spec: ``stencil_cuda`` against its
               plain version on the card, and ``stencil_cuda_batched``
               bitwise against ``stencil_cuda`` per entry;
  4. main      the port's main path at the paper's sizes:
               ``autotune(DSL, device="cuda")`` then ``design.runner``, with
               the launch counters read around the run, the error against
               the plain version, median times and achieved bandwidth,
               then the ranker's prediction against K1's time at every
               fusion depth for JACOBI2D 4096x4096 (``sweep``);
  5. batched   ``build_batched_runner`` with ``buffer_depth=2`` (K2) on a
               batch of 8, bitwise against K1 per entry;
  6. yardstick JACOBI2D at s=1 against one ``F.conv2d`` call (cuDNN with
               TF32 off), timed only as a yardstick.

Then one JSON line lists every kernel with its launches, error and times,
and the last line is ``{"ok": true, "device": {...}}``.  Any failure
raises, so the exit code is non-zero and no result line is printed.
Imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

TOL = {"float32": 2e-4, "bfloat16": 2e-2}   # tests/test_kernels.py::tol
SMALL_2D, SMALL_3D = (100, 77), (21, 13, 40)
MAIN_CASES = [  # (stock kernel, shape); 16 iterations each
    ("jacobi2d", (9720, 1024)),
    ("jacobi2d", (4096, 4096)),
    ("hotspot", (9720, 1024)),
    ("blur_jacobi2d", (9720, 1024)),
    ("sobel2d_replicate", (9720, 1024)),
    ("heat3d_periodic", (9720, 32, 32)),
]
ITERATIONS = 16
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


def main() -> int:
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        raise SystemExit("chip_smoke: src/repro_torch not found beside this script")
    sys.path.insert(0, str(root / "src"))

    import dataclasses

    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")

    from repro_torch.configs import stencils
    from repro_torch.core import dsl
    from repro_torch.core.autotune import autotune
    from repro_torch.core.ir import lower
    from repro_torch.core.model import ParallelismConfig
    from repro_torch.core.platform import gpu_platform_for
    from repro_torch.core.spec import Boundary
    from repro_torch.kernels import cuda_build, ops, pipeline, stencil
    from repro_torch.runtime.batching import build_batched_runner

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
    name = torch.cuda.get_device_name(0)
    gpu = gpu_platform_for(name)
    emit(phase="device", nvidia_smi=smi, kind=name, sku_row=gpu.name,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    def timed(fn, reps: int, warm: int = 2) -> float:
        """Median ms of ``fn`` over ``reps`` runs, each between CUDA events."""
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
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
    t0 = time.perf_counter()
    libs = cuda_build.build_many(small, ptxas_info=True)
    ptxas = [ln.strip() for ln in libs[0].build_log.splitlines() if "registers" in ln]
    emit(phase="build", kernels=len({lib.key for lib in libs}),
         seconds=round(time.perf_counter() - t0, 3), ptxas_jacobi2d=ptxas)

    # ---- 3. small: kernel vs plain, K2 vs K1 ------------------------------
    kinds = set()
    for spec in small:
        kinds.add(spec.boundary.kind)
        arrays = inputs(spec, batch=3)
        t = ops.to_device(spec, arrays, dev)
        errs, bitwise = [], True
        for s in (1, 2, 4):
            per_entry = []
            for b in range(3):
                one = {n: a[b] for n, a in t.items()}
                got = stencil.stencil_cuda(spec, one, s)
                want = stencil.stencil_torch_tiled(spec, one, s)
                torch.cuda.synchronize()
                err = max_err(got, want)
                scale = max(1.0, float(want.float().abs().max()))
                check(err <= TOL[spec.dtype] * scale,
                      f"{spec.name} s={s}: kernel vs plain {err} > "
                      f"{TOL[spec.dtype]} x {scale}")
                errs.append(err / scale)
                per_entry.append(got)
            both = pipeline.stencil_cuda_batched(spec, t, s)
            torch.cuda.synchronize()
            bitwise &= all(torch.equal(both[b], per_entry[b]) for b in range(3))
        check(bitwise, f"{spec.name}: K2 differs from K1 per entry")
        emit(phase="small", spec=spec.name, boundary=spec.boundary.kind,
             dtype=spec.dtype, shape=list(spec.shape), s=[1, 2, 4],
             max_rel_err=max(errs), tol=TOL[spec.dtype], k2_bitwise=bitwise)
    check(kinds == {"zero", "constant", "replicate", "periodic"},
          f"boundary kinds covered: {sorted(kinds)}")

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
        ms = timed(lambda: run.batched.dispatch(staged), reps=10)
        plain_ms = timed(lambda: plain_run(spec, t, ITERATIONS, cfg.s,
                                           run.batched.tile), reps=3, warm=1)
        b_ms, b_by = bound_ms(spec, 1, ITERATIONS)
        nbytes = (spec.num_inputs + 1) * spec.cells * spec.itemsize
        emit(phase="main", spec=spec.name, shape=list(shape),
             iterations=ITERATIONS, config=dict(s=cfg.s, buffer_depth=cfg.buffer_depth),
             path=run.path, launches=launches, first_call_s=round(wall, 3),
             max_abs_err=err, scale=scale, ms=ms, plain_ms=plain_ms,
             bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms,
             gb_per_s=nbytes / ms / 1e6,
             predicted_ms=design.prediction.latency * 1e3,
             predicted_hbm_mb=design.prediction.hbm_bytes / 1e6)

    # the model against the kernel at every fusion depth it ranks
    spec = lower(stencils.jacobi2d(shape=(4096, 4096), iterations=ITERATIONS)).spec
    t = ops.to_device(spec, inputs(spec), dev)
    ranking = autotune(spec, device="cuda", build=False).ranking
    for pred in ranking:
        if pred.config.buffer_depth:
            continue
        s = pred.config.s
        emit(phase="sweep", spec=spec.name, shape=[4096, 4096],
             iterations=ITERATIONS, s=s,
             smem_bytes=stencil.smem_bytes_estimate(spec, s),
             ms=timed(lambda: ops.stencil_run(spec, t, ITERATIONS, s=s),
                      reps=10),
             predicted_ms=pred.latency * 1e3,
             predicted_compute_ms=pred.compute_term * 1e3,
             predicted_memory_ms=pred.memory_term * 1e3)

    # ---- 5. batched: K2 on a batch of 8 ------------------------------------
    spec = lower(stencils.jacobi2d(shape=(9720, 1024), iterations=ITERATIONS)).spec
    s_main = autotune(spec, device="cuda", build=False).config.s
    run = build_batched_runner(
        spec, ParallelismConfig("temporal", s=s_main, buffer_depth=2),
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
    k2_ms = timed(one_round, reps=10)
    k2_plain_ms = timed(lambda: pipeline.stencil_torch_pipeline(
        spec, t, s_main, run.tile), reps=3, warm=1)
    k2_bound, k2_by = bound_ms(spec, 8, s_main)
    emit(phase="batched", spec=spec.name, batch=8, s=s_main,
         launches=k2_main_launches, k2_bitwise_vs_k1=k2_bitwise,
         round_ms=k2_ms, plain_round_ms=k2_plain_ms, bound_ms=k2_bound,
         bound_by=k2_by, max_abs_err=k2_err,
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
    k1_ms = timed(lambda: stencil.stencil_cuda(spec, t, 1), reps=20)
    k1_plain_ms = timed(lambda: stencil.stencil_torch_tiled(spec, t, 1), reps=5)
    library_ms = timed(conv, reps=20)
    k1_bound, k1_by = bound_ms(spec, 1, 1)
    emit(phase="yardstick", spec=spec.name, shape=[4096, 4096], s=1,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32, ms=k1_ms,
         plain_ms=k1_plain_ms, library_ms=library_ms, bound_ms=k1_bound,
         bound_by=k1_by, conv_vs_kernel_err=conv_err)

    kernels = [
        dict(name="stencil_cuda", route="cuda",
             source="src/repro_torch/kernels/csrc/stencil_tile.cuh",
             replaces="src/repro/kernels/stencil.py:96",
             launches=k1_main_launches, max_abs_err=k1_err, ms=k1_ms,
             plain_ms=k1_plain_ms, bound_ms=k1_bound, bound_by=k1_by,
             library_ms=library_ms),
        dict(name="stencil_cuda_batched", route="cuda",
             source="src/repro_torch/kernels/csrc/stencil_tile.cuh",
             replaces="src/repro/kernels/pipeline.py:85",
             launches=k2_main_launches, max_abs_err=k2_err, ms=k2_ms,
             plain_ms=k2_plain_ms, bound_ms=k2_bound, bound_by=k2_by,
             library_ms=None),
    ]
    check(all(k["launches"] > 0 for k in kernels), "a kernel never launched")
    emit(kernels=kernels)
    emit(ok=True, device={"platform": "gpu", "kind": name,
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
