"""The per-layer metrics read inside the program: the port's ``sasa.*``
spans (``repro_torch.trace``) and the tile kernel's update counters.

Each reader gives its value from a span table and counters set by hand,
and nothing where its span or counter recorded nothing or the port lacks
it.  A traced run of a tiny cell on the CPU (the plain versions, which
launch no kernel) reports the span metrics and leaves the launch metrics
out."""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch import trace
from repro_torch.kernels.stencil import launch_tile_kernel
from stencilbench import harness, tracing, yardstick

ROOT = Path(__file__).resolve().parents[1]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
READERS = ("round_host_us", "launch_enqueue_us", "dispatch_self_us",
           "redundant_update_ratio")


def read(name, rec):
    path = ROOT / "stencilbench" / "metrics" / f"{name}.py"
    return harness.load_module(path, f"program_metric_{name}").read(rec)


def records():
    work = yardstick.solve_work(5, 8, (9720, 1024), 8, 64).times(10)
    t = tracing.Trace(2.0, 1.9, [("sasa_tile_kernel", 0.0, 1.9)], [], [])
    return harness.Records({"dispatch": [1e-3] * 10}, 10, 2.0, work,
                           {"s": 8, "tile": [64, 64], "path": "tile_pipeline"},
                           t)


@pytest.fixture
def table(monkeypatch):
    """Sets the span table and the counters by hand."""
    def put(spans, issued=0, useful=0):
        monkeypatch.setattr(trace, "totals", lambda: dict(spans))
        monkeypatch.setattr(launch_tile_kernel, "updates_issued", issued)
        monkeypatch.setattr(launch_tile_kernel, "updates_useful", useful)
    return put


def test_each_reader_gives_its_value(table):
    table({"sasa.dispatch": (10, 1.0e-3), "sasa.round": (80, 0.6e-3),
           "sasa.launch.enqueue": (80, 0.2e-3), "sasa.stage": (10, 0.1e-3)},
          issued=1236, useful=1000)
    rec = records()
    assert read("round_host_us", rec) == pytest.approx(7.5)
    assert read("launch_enqueue_us", rec) == pytest.approx(2.5)
    assert read("dispatch_self_us", rec) == pytest.approx(40.0)
    assert read("redundant_update_ratio", rec) == pytest.approx(1.236)


def test_a_dispatch_without_rounds_is_all_self_time(table):
    table({"sasa.dispatch": (4, 2e-4)})
    assert read("dispatch_self_us", records()) == pytest.approx(50.0)
    assert read("round_host_us", records()) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_recorded_reads_nothing(table, name):
    table({})
    assert read(name, records()) is None


@pytest.mark.parametrize("name", READERS)
def test_a_port_without_spans_or_counters_reads_nothing(table, monkeypatch,
                                                        name):
    """As the parent commit's port: no ``repro_torch.trace`` to import, no
    counters on the launch."""
    table({n: (4, 1e-4) for n in ("sasa.dispatch", "sasa.round",
                                  "sasa.launch.enqueue")},
          issued=5, useful=4)
    assert read(name, records()) is not None
    monkeypatch.delattr(repro_torch, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    monkeypatch.delattr(launch_tile_kernel, "updates_issued")
    monkeypatch.delattr(launch_tile_kernel, "updates_useful")
    assert read(name, records()) is None


@pytest.mark.parametrize("cell", [CELLS[0], CELLS[1]])
def test_a_traced_cpu_run_reports_the_span_metrics(tiny_root, monkeypatch,
                                                    cell):
    # The CPU has no device kernel for the trace's reduction to find.
    monkeypatch.setattr(tracing, "reduce_profile", lambda prof: tracing.Trace(
        1.0, 0.5, [("sasa_tile_kernel", 0.0, 0.5)], [], []))
    trace.reset()
    r = harness.run_cell(harness.Bench(tiny_root).cell(cell), 2**31 + 29,
                         0.2, True, torch.device("cpu"), time.perf_counter())
    assert r["correct"], r["checks"]
    m = r["metrics"]
    assert m["round_host_us"]["value"] > 0
    assert m["round_host_us"]["unit"] == "us"
    assert m["dispatch_self_us"]["value"] > 0
    assert "launch_enqueue_us" not in m and "redundant_update_ratio" not in m
