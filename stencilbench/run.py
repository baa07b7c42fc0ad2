"""Run one cell of the benchmark once and print its result line.

    python3 stencilbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  It needs as many CUDA devices as the cell
asks for, and exits non-zero without a result line otherwise.  The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``;
``checks`` last: each number compared beside its limit).  The last lines
of standard error repeat the checks.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()   # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Whole top-level module names the process must not hold once the window
# has closed: JAX and the JAX package this port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks", "benchmarks_torch")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def set_paths() -> None:
    """The port (``src``) and this folder's package on the path, and every
    build and kernel cache at a fixed directory inside the checkout."""
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import shutil
    import subprocess

    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_paths()

    import torch

    t_torch = time.perf_counter()
    from stencilbench import harness

    bench = harness.Bench(ROOT)
    cell = bench.cell(args.workload)
    t_cell = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"stencilbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s), found {n}", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T0)
    found = forbidden_modules()
    if found:
        print(f"stencilbench: the process holds {found}", file=sys.stderr)
        return 3
    result["setup_spans"].update(import_torch=t_torch - T0,
                                 find_cell=t_cell - t_torch)
    checks = result.pop("checks")
    result["device"]["power"] = power_limit()
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
