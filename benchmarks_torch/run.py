"""Benchmark harness of the port: one module per paper table or figure --
the counterpart of ``benchmarks/run.py``.

Prints ``name,us_per_call,derived`` CSV.  Modules:
  intensity          -- Fig. 1  (computation intensity)
  single_pe          -- Fig. 8  (single-PE resources / shared memory per tile)
  best_config        -- Table 3 (best parallelism per benchmark)
  speedup_vs_soda    -- Sec. 5.4 (SASA vs SODA headline speedups)
  serving_throughput -- runtime subsystem: cached+batched serving vs
                        per-request autotune
  model_accuracy     -- Fig. 9  (analytical model vs measured)
  parallelism_sweep  -- Figs. 10-17 (GCell/s per parallelism x iteration)
  lm_roofline        -- assigned-arch roofline table from the dry-run

Each module runs on its own, and an error is kept as its module's
``ERROR`` row while the harness goes on.

    PYTHONPATH=src:. python benchmarks_torch/run.py [--device cpu|cuda]
        [--skip serving_throughput,model_accuracy]
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback


def main(argv=None) -> int:
    from benchmarks_torch import (best_config, intensity, lm_roofline,
                                  model_accuracy, parallelism_sweep,
                                  serving_throughput, single_pe,
                                  speedup_vs_soda)
    from repro_torch.kernels.ops import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default: raises without a card) or cpu")
    ap.add_argument("--skip", default="",
                    help="comma-separated modules not to run (a caller "
                         "that has just run them)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    skip = set(filter(None, args.skip.split(",")))
    modules = [
        ("intensity", intensity),
        ("single_pe", single_pe),
        ("best_config", best_config),
        ("speedup_vs_soda", speedup_vs_soda),
        ("serving_throughput", serving_throughput),
        ("model_accuracy", model_accuracy),
        ("parallelism_sweep", parallelism_sweep),
        ("lm_roofline", lm_roofline),
    ]
    unknown = skip - {name for name, _ in modules}
    if unknown:
        ap.error(f"--skip: no module {sorted(unknown)}")
    print("name,us_per_call,derived")
    for name, mod in modules:
        if name in skip:
            continue
        t0 = time.time()
        try:
            for row in mod.run(device=device):
                print(row, flush=True)
        except Exception as e:  # keep the harness alive per module
            traceback.print_exc(file=sys.stderr)
            print(f"{name}/ERROR,0.00,{type(e).__name__}: {e}")
        print(f"{name}/elapsed,{(time.time() - t0) * 1e6:.0f},",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
