"""Where the shard path's time goes on one card: ``torch.profiler`` over one
run of each of three shard designs.

Run from the root of a checkout, on a machine with a CUDA card::

    python3 tools/shard_profile.py

The pool is ``[cuda] * 4`` (four logical devices, one card), the stencil
JACOBI2D 9720x1024 at 16 iterations, the designs spatial_s(k=4),
hybrid_r(k=4, s=4) and the temporal pipeline (s=4).  For each design one
warm run, three runs timed with CUDA events (median, no profiler), then
one profiled run (``dispatch`` and a synchronize).  Each line gives both
wall times, the device time of the profiled run's kernels and copies
(device-side events only), the device's busy share of the unprofiled
time, the number of kernel launches (``cudaLaunchKernel`` calls), the
unprofiled time per launch, and the five kernels with the most device
time.  For the row partitions it also gives the ranker's count of the
operators the run launches (``core/model.py``; the model's host term is
that count times ``GPUPlatform.eager_op_s``), the unprofiled time per
counted operator (what ``eager_op_s`` is set from), and the model's
prediction for one card holding the four shards (the host term against
four times the memory term).
Exits non-zero without CUDA.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path


def _on_device(evt) -> bool:
    return str(getattr(evt, "device_type", "")).endswith("CUDA")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile(dev, pool_size: int = 4) -> list[dict]:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from repro_torch.configs import stencils
    from repro_torch.core import distribute
    from repro_torch.core.ir import lower
    from repro_torch.core import model
    from repro_torch.core.model import ParallelismConfig
    from repro_torch.core.platform import H100_SXM

    spec = lower(stencils.jacobi2d(shape=(9720, 1024), iterations=16)).spec
    x = {"in_1": np.random.default_rng(2022).standard_normal(
        spec.shape).astype(np.float32)}
    pool = [dev] * pool_size
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out = []
    for cfg in (ParallelismConfig("spatial_s", k=4),
                ParallelismConfig("hybrid_r", k=4, s=4),
                ParallelismConfig("temporal", s=4)):
        run = distribute.build_runner(spec, cfg, devices=pool)
        staged = run.stage(x)
        run.finalize(run.dispatch(staged))           # warm
        times = []
        for _ in range(3 if dev.type == "cuda" else 0):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            run.dispatch(staged)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        ms = float(np.median(times)) if times else None
        with tprofile(activities=acts) as prof:
            t0 = time.perf_counter()
            pending = run.dispatch(staged)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        run.finalize(pending)
        avgs = prof.key_averages()
        launches = sum(e.count for e in avgs if e.key == "cudaLaunchKernel")
        kernels = [e for e in avgs if _on_device(e)]
        busy_ms = sum(_device_us(e) for e in kernels) / 1e3
        top = sorted(kernels, key=_device_us, reverse=True)[:5]
        pred = (None if cfg.variant == "temporal" else model.predict_gpu(
            spec, cfg, H100_SXM.with_gpus(pool_size), 16))
        counted = pred and pred.launches
        one_card = pred and max(pred.host_term,
                                pool_size * pred.memory_term) * 1e3
        out.append(dict(
            phase="shard_profile", spec=spec.name, shape=list(spec.shape),
            iterations=16, variant=cfg.variant, k=cfg.k, s=cfg.s,
            logical_devices=pool_size, physical_devices=1,
            ms=ms, profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
            device_busy_share=busy_ms / ms if ms else None,
            kernel_launches=launches,
            us_per_launch=ms * 1e3 / launches if launches and ms else None,
            model_launches=counted,
            us_per_model_launch=ms * 1e3 / counted if counted and ms else None,
            predicted_one_card_ms=one_card,
            halo_bytes=run.halo_bytes,
            top_kernels=[dict(name=e.key[:80], count=e.count,
                              device_ms=_device_us(e) / 1e3) for e in top],
        ))
    return out


def main() -> int:
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root / "src"))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("shard_profile: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for line in profile(torch.device("cuda")):
        line["nvidia_smi"] = smi
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
