"""Run one cell: set-up, the measured window, the comparison, the result.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<c>.py``)
and a traffic mix (``traffic/<m>.json``); its per-layer metrics are the
readers ``metrics/<metric>.py`` and its limits ``limits/<cell>.json``.
Nothing here names a cell, a configuration or a metric: a later cell
comes with files and entries of its own.

The entry the window drives is the port's public one: DSL text ->
``repro_torch.core.autotune.autotune(text, iterations=...)`` -> the
batched runner's ``stage`` -> ``dispatch`` -> a wait on the returned
event.  One client keeps one solve in flight (a closed loop); each solve
takes a batch of the input pool, which lives on the card, and its output
stays there.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import random
import time
from pathlib import Path
from types import ModuleType
from typing import Callable

import torch

from stencilbench import tracing, yardstick

FOLDER = "stencilbench"
END_TO_END = ("cell_updates_per_s", "solve_ms_p95", "setup_s")
# Solves of the window drawn from the seed and compared with the reference.
COMPARED = 3


def load_module(path: Path, name: str) -> ModuleType:
    """Import a file of the benchmark by its path (config and metric
    files are named after the entries of ``BENCHMARK.json``)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass(frozen=True)
class Mix:
    """One traffic mix: ``grids`` grids advanced ``iterations`` times per
    solve by one client with one solve in flight, over a pool of
    ``pool_batches`` distinct input batches."""

    name: str
    grids: int
    iterations: int
    pool_batches: int

    @classmethod
    def load(cls, path: Path) -> "Mix":
        d = json.loads(path.read_text())
        if (d.get("loop"), d.get("clients"), d.get("in_flight")) != ("closed", 1, 1):
            raise ValueError(f"{path}: the generator drives a closed loop "
                             "of one client with one solve in flight")
        mix = cls(path.name[:-len(".json")], int(d["grids_per_solve"]),
                  int(d["iterations"]), int(d["pool_batches"]))
        if min(mix.grids, mix.iterations, mix.pool_batches) < 1:
            raise ValueError(f"{path}: counts must be positive")
        return mix


@dataclasses.dataclass
class Cell:
    name: str
    config: ModuleType
    mix: Mix
    chips: int
    end_to_end: list[dict]
    per_layer: list[tuple[dict, Callable]]
    limits: dict

    def dsl(self, dtype: str | None = None) -> str:
        """The configuration's DSL text at the mix's iterations, in its
        stated dtype or in ``dtype`` (the control's)."""
        c = self.config
        return c.DSL.format(iterations=self.mix.iterations,
                            dtype=dtype or c.DTYPE,
                            shape=", ".join(str(n) for n in c.SHAPE))

    def solve_work(self) -> yardstick.Work:
        c = self.config
        return yardstick.solve_work(c.OPS_PER_UPDATE, c.BYTES_PER_CELL,
                                    c.SHAPE, self.mix.grids,
                                    self.mix.iterations)


class Bench:
    """``BENCHMARK.json`` at ``root`` and the files it names."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())
        self.folder = self.root / FOLDER

    def cell(self, name: str) -> Cell:
        cells = {w["name"]: w for w in self.doc["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        w = cells[name]
        if int(w["chips"]) != 1:
            raise ValueError(f"{name}: the harness drives one card; a cell "
                             f"on {w['chips']} chips needs a multi-card run")
        cfg = {c["name"]: c for c in self.doc["configs"]}[w["config"]]
        config = load_module(self.root / cfg["file"],
                             f"stencilbench_config_{len(cells)}_{name}")

        def applies(m: dict) -> bool:
            return "workloads" not in m or name in m["workloads"]

        e2e = [m for m in self.doc["end_to_end"] if applies(m)]
        unknown = [m["name"] for m in e2e if m["name"] not in END_TO_END]
        if unknown:
            raise ValueError(f"no end-to-end metric {unknown} in the harness")
        per_layer = [
            (m, load_module(self.folder / "metrics" / f"{m['name']}.py",
                            f"stencilbench_metric_{m['name']}").read)
            for m in self.doc["per_layer"] if applies(m)
        ]
        limits_file = self.folder / "limits" / f"{name}.json"
        limits = (json.loads(limits_file.read_text())
                  if limits_file.exists() else {})
        return Cell(name, config,
                    Mix.load(self.folder / "traffic" / f"{w['traffic']}.json"),
                    int(w["chips"]), e2e, per_layer, limits)


@dataclasses.dataclass
class Records:
    """What a per-layer metric reads: the benchmark's own host spans
    around calls into the port (seconds), the window's solves and work,
    and, in a traced run, the reduced profiler trace."""

    spans: dict[str, list[float]]
    solves: int
    window_s: float
    work: yardstick.Work          # of every solve completed in the window
    design: dict                  # fusion depth, tile, path: for the record
    trace: tracing.Trace | None = None


def make_pool(cell: Cell, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """The input pool, ``(pool_batches, grids) + shape`` per input in the
    configuration's dtype, made on ``device`` from ``seed`` in one call
    per input."""
    g = torch.Generator(device=device)
    g.manual_seed(seed & 0xFFFF_FFFF_FFFF_FFFF)
    shape = (cell.mix.pool_batches, cell.mix.grids) + tuple(cell.config.SHAPE)
    dtype = getattr(torch, cell.config.DTYPE)
    pool = {}
    for name, (lo, hi) in cell.config.INPUTS.items():
        a = torch.rand(shape, generator=g, device=device, dtype=dtype)
        pool[name] = a.mul_(hi - lo).add_(lo)
    return pool


def batch(pool: dict[str, torch.Tensor], b: int) -> dict[str, torch.Tensor]:
    return {n: a[b] for n, a in pool.items()}


def wait(pending) -> None:
    if pending.event is not None:
        pending.event.synchronize()


def tune(cell: Cell, device: torch.device, dtype: str | None = None):
    """The port's design for the cell's DSL text (``autotune``)."""
    from repro_torch.core.autotune import autotune

    return autotune(cell.dsl(dtype), iterations=cell.mix.iterations,
                    device=device)


def solves(runner, batches: list[dict[str, torch.Tensor]], count: int,
           first: int = 0) -> list[tuple[int, int, torch.Tensor]]:
    """``count`` solves through the entry the window drives, one in
    flight, taking the pool's batches in turn from solve ``first``; each
    solve's index, batch and output."""
    done = []
    for i in range(first, first + count):
        b = i % len(batches)
        p = runner.dispatch(runner.stage(batches[b]))
        wait(p)
        done.append((i, b, p.out))
    return done


class Reservoir:
    """A uniform sample of ``k`` of the window's solves, drawn from the
    seed (algorithm R), holding each one's output on the card."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.kept: list[tuple[int, int, torch.Tensor]] = []

    def offer(self, i: int, b: int, out: torch.Tensor) -> None:
        if i < self.k:
            self.kept.append((i, b, out))
            return
        j = self.rng.randrange(i + 1)
        if j < self.k:
            self.kept[j] = (i, b, out)


def compare(cell: Cell, pool: dict[str, torch.Tensor],
            kept: list[tuple[int, int, torch.Tensor]]) -> dict[str, dict]:
    """Each number that decides ``correct``, beside its limit."""
    errs = [
        yardstick.rel_err(out, batch(pool, b), cell.config.reference,
                          cell.mix.iterations)
        for _, b, out in kept
    ]
    return {"max_rel_err": {
        "value": max(errs) if errs else math.inf,
        "limit": cell.limits.get("max_rel_err", {}).get("limit"),
        "each": errs,
    }}


def is_correct(checks: dict[str, dict]) -> bool:
    """Every number within its limit (``nan`` is not); a cell without
    limits is never correct."""
    return all(c["limit"] is not None and c["value"] <= c["limit"]
               for c in checks.values())


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float,
             dtype: str | None = None) -> dict:
    """One run of ``cell``; set-up is timed from ``t0`` on the host clock.
    ``dtype`` replaces the configuration's (the control).  Returns the
    result line's object (``checks`` last)."""
    cuda = device.type == "cuda"
    spans: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def span(name: str):
        t = time.perf_counter()
        yield
        spans.setdefault(name, []).append(time.perf_counter() - t)

    spans["before_run"] = [time.perf_counter() - t0]
    with span("import_port"):
        import repro_torch.core.autotune  # noqa: F401
    if cuda:
        with span("cuda_context"):
            torch.cuda.init()
            torch.empty(1, device=device)
    with span("autotune"):
        design = tune(cell, device, dtype)
    runner = design.runner.batched
    P = cell.mix.pool_batches
    with span("pool"):
        pool = make_pool(cell, seed, device)
        batches = [batch(pool, b) for b in range(P)]
        if cuda:
            torch.cuda.synchronize(device)
    with span("first_solve"):
        solves(runner, batches, 1)
    # Warm-up: every solve of the window has this shape.  The window holds
    # up to ``COMPARED + 2`` outputs at once (the sample, the last solve's
    # and the new one); holding as many here sizes the allocator's cache,
    # so no allocation reaches the driver inside the window.
    with span("warmup"):
        solves(runner, batches, COMPARED + 2, first=1)
        if cuda:
            torch.cuda.synchronize(device)

    sample = Reservoir(COMPARED, seed)
    latency_ms: list[float] = []
    dispatch_s: list[float] = []
    annotate = (torch.profiler.record_function if trace
                else lambda _name: contextlib.nullcontext())
    prof = None
    if trace:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA,
        ])
        prof.__enter__()
    n = 0
    t_start = time.perf_counter()
    deadline = t_start + seconds
    with annotate(tracing.WINDOW):
        while True:
            b = n % P
            h0 = time.perf_counter()
            with annotate("stencilbench.stage"):
                staged = runner.stage(batches[b])
            with annotate("stencilbench.dispatch"):
                pending = runner.dispatch(staged)
            h1 = time.perf_counter()
            with annotate("stencilbench.wait"):
                wait(pending)
            h2 = time.perf_counter()
            dispatch_s.append(h1 - h0)
            # the solve's time as its caller sees it: from the ``stage``
            # call until the wait on its completion event returns
            latency_ms.append((h2 - h0) * 1e3)
            sample.offer(n, b, pending.out)
            n += 1
            if time.perf_counter() >= deadline:
                break
    t_end = time.perf_counter()
    del staged, pending
    trace_rec = None
    if prof is not None:
        prof.__exit__(None, None, None)
        trace_rec = tracing.reduce_profile(prof)
        del prof
    spans["dispatch"] = dispatch_s
    window_s = t_end - t_start
    work = cell.solve_work().times(n)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    design_info = {"s": int(design.config.s), "tile": list(runner.tile),
                   "path": runner.path}
    del design, runner, batches

    checks = compare(cell, pool, sample.kept)
    correct = is_correct(checks)
    limit = checks["max_rel_err"]["limit"]
    records = Records(spans, n, window_s, work, design_info, trace_rec)
    e2e = {
        "cell_updates_per_s": work.cell_updates / window_s / 1e9,
        "solve_ms_p95": yardstick.p95(latency_ms),
        "setup_s": t_start - t0,
    }
    if trace:
        metrics = {}
        for m, read in cell.per_layer:
            v = read(records)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else device.type,
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    result = {
        "correct": correct,
        "attempted": n,
        "failed": sum(limit is None or not e <= limit
                      for e in checks["max_rel_err"]["each"]),
        "metrics": metrics,
        "device": dev,
    }
    if trace_rec is not None:
        dev["busy_s"] = trace_rec.busy_s
        dev["window_s"] = trace_rec.window_s
        result["breakdown"] = {"device_ops": trace_rec.device_ops,
                               "idle_gaps": trace_rec.idle_gaps}
    result["design"] = design_info
    result["window_s"] = window_s
    result["setup_spans"] = {k: v[0] for k, v in spans.items()
                             if k != "dispatch"}
    result["compared_solves"] = [i for i, _, _ in sample.kept]
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in checks.items()}
    return result
