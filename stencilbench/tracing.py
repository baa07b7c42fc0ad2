"""Reduce a ``torch.profiler`` trace of the window to what the per-layer
metrics read: the device's kernels and busy time inside the window, and
the idle time by what the host was doing meanwhile.

The window is the benchmark's own ``record_function`` span
(:data:`WINDOW`); the device's work is every kernel, copy and fill the
profiler saw on the card inside it.  A trace with no kernel in the window
raises: a share of nothing is not 0.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from collections import defaultdict

WINDOW = "stencilbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: list[tuple[str, float, float]]   # name, start s, seconds
    device_ops: list[list]                     # [name, seconds], top 10
    idle_gaps: list[list]                      # [host activity, seconds], top 10


def reduce_profile(prof) -> Trace:
    """Export ``prof``'s trace to a temporary file, reduce it, delete it."""
    fd, path = tempfile.mkstemp(prefix="stencilbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce_events(events)


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, z in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], z)
        else:
            out.append([a, z])
    return [(a, z) for a, z in out]


def reduce_events(events: list[dict]) -> Trace:
    """``events``: the ``traceEvents`` of a Chrome trace (microseconds)."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    windows = [e for e in spans
               if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
    if len(windows) != 1:
        raise RuntimeError(f"expected one {WINDOW!r} span in the trace, "
                           f"found {len(windows)}")
    w = windows[0]
    w0, w1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])

    device = []
    for e in spans:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, z = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        a, z = max(a, w0), min(z, w1)
        if z > a:
            device.append((e["cat"], e["name"], a, z))
    kernels = [(n, a * 1e-6, (z - a) * 1e-6)
               for cat, n, a, z in device if cat == "kernel"]
    if not kernels:
        raise RuntimeError("the profiler saw no kernel on the device in the "
                           "window")
    busy = _merge([(a, z) for _, _, a, z in device])
    busy_us = sum(z - a for a, z in busy)

    by_op: dict[str, float] = defaultdict(float)
    for _, n, a, z in device:
        by_op[n] += (z - a) * 1e-6

    # What the host was doing in each idle gap: the innermost host event
    # (on the window's thread) that covers the gap's midpoint.
    host = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
        for e in spans
        if e.get("cat") in HOST_CATS and e.get("tid") == w.get("tid")
        and e["name"] != WINDOW
    )
    starts = [h[0] for h in host]
    idle: dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, z in zip(edges[::2], edges[1::2]):
        if z <= a:
            continue
        mid = (a + z) / 2
        name = "host: the benchmark's loop"
        for k in range(bisect.bisect_right(starts, mid) - 1,
                       max(-1, bisect.bisect_right(starts, mid) - 257), -1):
            if host[k][1] >= mid:
                name = host[k][2]
                break
        idle[name] += (z - a) * 1e-6

    def top(d):
        return [[n, v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return Trace((w1 - w0) * 1e-6, busy_us * 1e-6, kernels, top(by_op),
                 top(idle))
