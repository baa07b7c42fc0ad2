"""Spans on the profiler's clock.

``with span("sasa.round"): ...`` marks one piece of the port's dispatch
path.  A span records exactly while a torch profiler records: it then
enters ``torch.profiler.record_function(name, args)``, so it lands in the
profiler's trace on the timeline of the CUDA runtime calls and the device
events, and adds its host duration (``time.perf_counter_ns``, its own
``record_function`` included) to an in-process table that :func:`totals`
returns.  With no profiler, :func:`span` returns one shared no-op context
manager after a single attribute read; nothing is recorded.

The spans, outermost first: ``sasa.stage`` and ``sasa.dispatch`` (the
runner's phases, ``runtime/batching.py``; the dispatch carries the
runner's solve sequence number as its ``args``), ``sasa.round`` (one round
of ``kernels/ops.py::run_rounds``, any wrap fix-up included), and inside a
round ``sasa.launch.alloc`` (the output's allocation) and
``sasa.launch.enqueue`` (the tile kernel's launch call) of
``kernels/stencil.py::launch_tile_kernel``.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch
import torch.autograd.profiler as _profiler

_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_totals: dict[str, list[int]] = {}   # name -> [count, nanoseconds]


class _Span:
    __slots__ = ("name", "args", "rf", "t0")

    def __init__(self, name: str, args: str | None):
        self.name = name
        self.args = args

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        self.rf = torch.profiler.record_function(self.name, self.args)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        ns = time.perf_counter_ns() - self.t0
        with _lock:
            t = _totals.setdefault(self.name, [0, 0])
            t[0] += 1
            t[1] += ns
        return False


def span(name: str, args: object = None):
    """A context manager marking ``name`` while a torch profiler records
    (``args``, if given, is passed on as a string), else the shared
    no-op."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, None if args is None else str(args))


def totals() -> dict[str, tuple[int, float]]:
    """``{name: (count, seconds)}`` of every span recorded since the
    process started or :func:`reset` was called."""
    with _lock:
        return {n: (c, ns * 1e-9) for n, (c, ns) in _totals.items()}


def reset() -> None:
    with _lock:
        _totals.clear()
