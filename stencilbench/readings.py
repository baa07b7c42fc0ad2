"""Readings that set the limit of each number compared: the program's,
the control's and the planted faults', over many seeds in one process.

    python3 stencilbench/readings.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--fault-seeds 7,8,9] [--out FILE]

For each seed it makes the cell's input pool, runs as many solves as a
run compares through the harness's own entry (``harness.tune`` and
``harness.solves``) at the cell's sizes, and prints the numbers a run
compares, one JSON line each: ``program`` is the configuration as stated
(float32); ``control`` is the program's own bfloat16 path, the nearest
precision below; each fault of :mod:`stencilbench.faults` is planted in
the program.  The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from stencilbench import run as _run  # noqa: E402  (paths and caches)


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    _run.set_paths()

    import torch

    from stencilbench import faults, harness

    device = torch.device("cuda")
    cell = harness.Bench(_run.ROOT).cell(args.workload)
    out = open(args.out, "a") if args.out else None

    def read(label, dtype, seed_list):
        design = harness.tune(cell, device, dtype)
        runner = design.runner.batched
        for seed in seed_list:
            t = time.perf_counter()
            pool = harness.make_pool(cell, seed, device)
            batches = [harness.batch(pool, b)
                       for b in range(cell.mix.pool_batches)]
            kept = harness.solves(runner, batches, harness.COMPARED)
            checks = harness.compare(cell, pool, kept)
            line = {"workload": cell.name, "reading": label, "seed": seed,
                    "dtype": dtype or cell.config.DTYPE,
                    "s": int(design.config.s),
                    "tile": list(runner.tile), "path": runner.path,
                    "numbers": {k: {"value": c["value"], "each": c["each"]}
                                for k, c in checks.items()},
                    "seconds": time.perf_counter() - t,
                    "device": torch.cuda.get_device_name(device)}
            text = json.dumps(line)
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()
            del pool, batches, kept

    read("program", None, args.seeds)
    read("control", "bfloat16", args.control_seeds)
    for fault in faults.FAULTS if args.fault_seeds else ():
        with faults.planted(fault):
            read(fault, None, args.fault_seeds)
    if out:
        out.close()
    found = _run.forbidden_modules()
    if found:
        print(f"readings: the process holds {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
