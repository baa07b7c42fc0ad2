"""The reduction of a profiler trace: busy time is the union of device
intervals inside the window; idle time goes to the innermost host event
covering it; a window without a kernel raises."""
from __future__ import annotations

import pytest

from stencilbench import tracing


def ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def events():
    return [
        ev("user_annotation", tracing.WINDOW, 100, 1000),
        ev("user_annotation", "stencilbench.dispatch", 100, 60),
        ev("cpu_op", "aten::empty", 120, 10),
        ev("user_annotation", "stencilbench.wait", 160, 400),
        ev("kernel", "sasa_tile_kernel", 150, 300, tid=7),
        ev("kernel", "sasa_tile_kernel", 400, 200, tid=7),   # overlaps
        ev("gpu_memcpy", "Memcpy DtoD", 700, 100, tid=7),
        ev("kernel", "sasa_tile_kernel", 1050, 200, tid=7),  # past the end
        ev("kernel", "outside", 0, 50, tid=7),
    ]


def test_busy_time_is_the_union_inside_the_window():
    t = tracing.reduce_events(events())
    assert t.window_s == pytest.approx(1000e-6)
    # [150, 600) + [700, 800) + [1050, 1100)
    assert t.busy_s == pytest.approx(600e-6)
    assert [k[0] for k in t.kernels] == ["sasa_tile_kernel"] * 3
    assert dict(t.device_ops)["sasa_tile_kernel"] == pytest.approx(550e-6)


def test_idle_goes_to_the_innermost_host_event():
    t = tracing.reduce_events(events())
    idle = dict(t.idle_gaps)
    # [100, 150): dispatch (mid 125 is inside aten::empty [120, 130))
    assert idle["aten::empty"] == pytest.approx(50e-6)
    # [600, 700) and [800, 1050): no host event covers their midpoints
    assert idle["host: the benchmark's loop"] == pytest.approx(350e-6)
    assert sum(idle.values()) + t.busy_s == pytest.approx(t.window_s)


def test_no_kernel_in_the_window_raises():
    with pytest.raises(RuntimeError, match="no kernel"):
        tracing.reduce_events([e for e in events() if e["cat"] != "kernel"
                               or e["name"] == "outside"])
