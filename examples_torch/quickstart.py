"""Quickstart: write a stencil in the SASA DSL, let the framework pick the
best parallelism, and run it — the PyTorch/CUDA port's counterpart of
``examples/quickstart.py``.

    PYTHONPATH=src python examples_torch/quickstart.py               # a CUDA card
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu  # plain versions

On a card the design runs the hand-written tile kernel
(``kernels/csrc/stencil_tile.cuh``); on the CPU it runs that kernel's plain
version.  ``main`` returns the output, its error against the oracle and
the tolerance the numerics analysis certifies for it.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import numerics
from repro_torch.core.autotune import autotune, soda_baseline
from repro_torch.core.platform import DEFAULT_GPU
from repro_torch.kernels import ref
from repro_torch.kernels.ops import resolve_device

DSL = """
kernel: JACOBI2D
iteration: 8
input float: in_1(1024, 512)
output float: out_1(0,0) = (in_1(0,1) + in_1(1,0) + in_1(0,0)
    + in_1(0,-1) + in_1(-1,0)) / 5
"""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default: raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    design = autotune(DSL, device=device)
    cfg = design.config
    print(f"kernel:        {design.spec.name} "
          f"({design.spec.points}-point, r={design.spec.radius})")
    print(f"chosen design: {cfg.variant} (spatial k={cfg.k}, "
          f"temporal s={cfg.s})")
    print(f"predicted:     {design.prediction.latency * 1e6:.1f} us/run, "
          f"bottleneck={design.prediction.bottleneck}")
    print("top-5 candidates:")
    for p in design.ranking[:5]:
        print(f"  {p.config.variant:10s} k={p.config.k:2d} s={p.config.s:2d} "
              f"-> {p.latency * 1e6:8.1f} us ({p.bottleneck}-bound)")

    rng = np.random.default_rng(0)
    x = rng.standard_normal((1024, 512)).astype(np.float32)
    t0 = time.perf_counter()
    out = design.runner({"in_1": x})
    dt = time.perf_counter() - t0
    want = ref.stencil_iterations_ref(
        design.spec, {"in_1": torch.from_numpy(x)}).numpy()
    err = float(np.abs(out - want).max())
    print(f"\nexecuted in {dt * 1e3:.1f} ms (first call includes compile); "
          f"max |err| vs oracle = {err:.2e}")

    base = soda_baseline(DSL, device=device)
    print(f"\nSODA baseline (temporal-only): s={base.config.s}, predicted "
          f"{base.prediction.latency * 1e6:.1f} us "
          f"-> SASA predicted speedup "
          f"{base.prediction.latency / design.prediction.latency:.2f}x")

    # what the tuner would pick on 8 H100s (plan only: the runner for a
    # pool of 8 is not built)
    pool8 = DEFAULT_GPU.with_gpus(8)
    plan8 = autotune(DSL, platform=pool8, build=False)
    sbase = soda_baseline(DSL, platform=pool8, build=False)
    c = plan8.config
    print(f"\non 8 H100s the tuner picks: {c.variant} "
          f"(k={c.k}, s={c.s}), predicted speedup over SODA "
          f"{sbase.prediction.latency / plan8.prediction.latency:.2f}x")
    return {"out": out, "max_abs_err": err,
            "tolerance": numerics.tolerance_for(design.spec,
                                                arrays={"in_1": x})}


if __name__ == "__main__":
    main()
