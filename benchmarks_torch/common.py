"""Shared utilities of the port's benchmarks: timing, CSV rows, gates and
the command line every script takes.

Each script runs the same sections, traces, seeds and bounds as its
counterpart in ``benchmarks/``, on ``--device cpu`` (the plain versions of
the CUDA kernels) or ``--device cuda`` (the default; raises without a
card, as the port's entry points do).  Every gate is recorded as a
:class:`Gate`: a correctness gate (bitwise equality, drops, counts) raises
as soon as it fails, on every device; a timing gate (a ratio of two
times, or a rank accuracy) is recorded and asserted only under
``--check``, so a caller on the card can report its reading instead.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device


def sync() -> None:
    """Wait for the card's queued work, where a card is in use."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_call(fn, *args, warmup=1, iters=3, **kw):
    """Median wall time of ``fn(*args, **kw)`` in seconds; the card's work
    is awaited inside every sample."""
    for _ in range(warmup):
        fn(*args, **kw)
        sync()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kw)
        sync()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def emit(rows, name, us, derived=""):
    rows.append(f"{name},{us:.2f},{derived}")
    return rows


_OPS = {">=": lambda a, b: a >= b, "<=": lambda a, b: a <= b,
        "<": lambda a, b: a < b, ">": lambda a, b: a > b,
        "==": lambda a, b: a == b}


@dataclasses.dataclass
class Gate:
    gate: str
    reading: float
    op: str
    bound: float
    held: bool
    kind: str      # "correctness" or "timing"


class GateFailed(AssertionError):
    pass


class Gates(list):
    """The gates of one run, in the order they were read."""

    def _add(self, kind, gate, reading, op, bound) -> bool:
        held = bool(_OPS[op](reading, bound))
        self.append(Gate(gate, reading, op, bound, held, kind))
        return held

    def correctness(self, gate, reading, op="==", bound=True) -> None:
        if not self._add("correctness", gate, reading, op, bound):
            raise GateFailed(f"{gate}: {reading} {op} {bound} does not hold")

    def timing(self, gate, reading, op, bound) -> bool:
        return self._add("timing", gate, reading, op, bound)

    def assert_held(self) -> None:
        bad = [g for g in self if not g.held]
        if bad:
            raise GateFailed("; ".join(
                f"{g.gate}: {g.reading} {g.op} {g.bound} does not hold"
                for g in bad))


def main(run, argv, doc: str, ok: str) -> int:
    """The command line of a gate script: ``--device``, ``--smoke`` and
    ``--check``.  Prints the CSV rows, then one JSON line per gate; with
    ``--check`` a missed gate makes the exit code non-zero."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default: raises without a card) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="the CI-sized traces of the reference's --smoke")
    ap.add_argument("--check", action="store_true",
                    help="assert every gate; exit non-zero on a miss")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    gates = Gates()
    rows = run(smoke=args.smoke, device=device, gates=gates)
    for row in rows:
        print(row)
    for g in gates:
        print(json.dumps(dataclasses.asdict(g)))
    if args.check:
        gates.assert_held()
        print(ok)
    return 0
