"""HEAT3D on a pool of 8 devices: auto-tuned hybrid parallelism with
border streaming between shards, validated against the single-device
oracle — the PyTorch/CUDA port's counterpart of
``examples/stencil_multidevice.py``.

The pool repeats one device 8 times (``resolve_pool([dev] * 8)``): eight
logical devices on one card, or on the host with ``--device cpu``, so no
environment setting is needed.

    PYTHONPATH=src python examples_torch/stencil_multidevice.py               # a CUDA card
    PYTHONPATH=src python examples_torch/stencil_multidevice.py --device cpu  # plain versions
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import stencils
from repro_torch.core import model
from repro_torch.core.autotune import autotune
from repro_torch.core.distribute import build_runner
from repro_torch.kernels import ref
from repro_torch.kernels.ops import resolve_device, resolve_pool

POOL = 8


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default: raises without a card) or cpu")
    args = ap.parse_args(argv)
    pool = resolve_pool([resolve_device(args.device)] * POOL)
    print(f"devices: {len(pool)} (logical, all {pool[0]})")
    spec = stencils.heat3d(shape=(256, 16, 16), iterations=8)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(spec.shape).astype(np.float32)

    design = autotune(spec, devices=pool)
    print(f"auto-tuned: {design.config.variant} k={design.config.k} "
          f"s={design.config.s} (predicted "
          f"{design.prediction.latency * 1e6:.1f} us on {POOL} H100s)")
    out = design.runner({"in_1": x})
    want = ref.stencil_iterations_ref(
        spec, {"in_1": torch.from_numpy(x)}).numpy()
    print(f"max |err| vs oracle: {np.abs(out - want).max():.2e}")

    print(f"\nmeasured on this host ({POOL} logical devices):")
    results = []
    for cfg in [model.ParallelismConfig("spatial_s", k=8, s=1),
                model.ParallelismConfig("hybrid_s", k=4, s=2),
                model.ParallelismConfig("hybrid_r", k=2, s=4),
                model.ParallelismConfig("temporal", k=1, s=8)]:
        run = build_runner(spec, cfg, tile_rows=32, devices=pool)
        run({"in_1": x})  # warm
        if pool[0].type == "cuda":
            torch.cuda.synchronize(pool[0])
        t0 = time.perf_counter()
        out = run({"in_1": x})
        dt = time.perf_counter() - t0
        ok = bool(np.allclose(out, want, atol=2e-4))
        print(f"  {cfg.variant:10s} k={cfg.k} s={cfg.s}: {dt * 1e3:7.1f} ms "
              f"correct={ok}")
        results.append((cfg.variant, ok))
    return {"results": results}


if __name__ == "__main__":
    main()
