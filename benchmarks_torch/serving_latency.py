"""Open-loop serving latency: continuous batching against the flush
barrier -- the port's counterpart of ``benchmarks/serving_latency.py``,
with its Poisson trace (seed, rate, shapes) and gates.

One mixed-kernel, mixed-shape arrival trace is drawn once (exponential
inter-arrival gaps) and fired at its scheduled times, however fast the
server answers, against two serving paths over one shared design cache,
so both dispatch the same runners:

  * **flush baseline** -- arrivals ``submit()``-ed, a ``flush()`` every
    ``flush_interval_s``;
  * **continuous** -- arrivals straight into
    :class:`repro_torch.serve.StencilScheduler`.

Gates: zero drops on both paths (correctness); continuous throughput >=
0.9 x the flush baseline's and p99 <= the baseline's (timing); every
sampled continuous result bitwise equal to synchronous single-shot
``serve()`` (correctness, on the CPU and on a card: the scheduler stages
through the engine's own padded ``_prepare``).

    PYTHONPATH=src:. python benchmarks_torch/serving_latency.py --smoke --device cpu --check
"""
from __future__ import annotations

import sys
import time

import numpy as np

from benchmarks_torch.common import Gates, emit, main
from repro_torch.configs import stencils
from repro_torch.kernels.ops import resolve_device
from repro_torch.runtime import DesignCache
from repro_torch.serve import StencilRequest, StencilScheduler, StencilServer


def _percentile(lat_s: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(lat_s), q)) if lat_s else 0.0


def build_trace(smoke: bool, rng):
    """One Poisson arrival schedule over a mixed-kernel, mixed-shape mix:
    ``(designs, [(arrival_s, StencilRequest), ...])``, two kernels at two
    grid geometries."""
    iters = 2 if smoke else 4
    n = 48 if smoke else 240
    rate_hz = 150.0 if smoke else 300.0
    designs = {
        "jac_s": stencils.jacobi2d(
            shape=(20, 12) if smoke else (64, 32), iterations=iters),
        "jac_l": stencils.jacobi2d(
            shape=(28, 16) if smoke else (96, 48), iterations=iters),
        "hot_s": stencils.hotspot(
            shape=(20, 12) if smoke else (64, 32), iterations=iters),
        "hot_l": stencils.hotspot(
            shape=(28, 16) if smoke else (96, 48), iterations=iters),
    }
    names = sorted(designs)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_hz, size=n))
    trace = []
    for t in arrivals:
        name = names[int(rng.integers(len(names)))]
        spec = designs[name]
        trace.append((float(t), StencilRequest(name, {
            k: rng.standard_normal(shape).astype(dt)
            for k, (dt, shape) in spec.inputs.items()
        })))
    return designs, trace


def replay_flush(server, trace, flush_interval_s: float):
    """Fire the trace open-loop at a flush-barrier server; returns
    (latencies, makespan, unresolved count)."""
    lat = []
    pending: dict[int, float] = {}       # ticket -> scheduled arrival
    t0 = time.monotonic()
    last_flush = t0

    def collect(done, now):
        for ticket in done:
            if ticket in pending:
                lat.append(now - pending.pop(ticket))

    for arrive_s, request in trace:
        due = t0 + arrive_s
        delay = due - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        pending[server.submit(request)] = due
        now = time.monotonic()
        if now - last_flush >= flush_interval_s:
            collect(server.flush(), time.monotonic())
            last_flush = time.monotonic()
    collect(server.flush(), time.monotonic())
    makespan = time.monotonic() - t0
    return lat, makespan, len(pending)


def replay_continuous(scheduler, trace):
    """Fire the same trace open-loop at the continuous scheduler; returns
    (latencies, makespan, tickets with their requests)."""
    fired = []
    t0 = time.monotonic()
    for arrive_s, request in trace:
        due = t0 + arrive_s
        delay = due - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        fired.append((due, scheduler.submit(request), request))
    scheduler.drain()
    makespan = time.monotonic() - t0
    lat = [t.completed_at - due for due, t, _ in fired if t.completed_at]
    return lat, makespan, fired


def run(check: bool = False, smoke: bool = False, device=None,
        gates: Gates | None = None):
    dev = resolve_device(device)
    gates = Gates() if gates is None else gates
    rows = []
    rng = np.random.default_rng(42)
    designs, trace = build_trace(smoke, rng)
    n = len(trace)
    max_batch = 4
    flush_interval_s = 0.05 if smoke else 0.1
    cache = DesignCache()                # shared: the same runners

    def new_server():
        srv = StencilServer(max_batch=max_batch, cache=cache, warmup=True,
                            device=dev)
        for name, spec in designs.items():
            srv.register(name, spec)
        return srv

    # ---- flush-barrier baseline ----
    srv_flush = new_server()
    flush_lat, flush_span, flush_lost = replay_flush(
        srv_flush, trace, flush_interval_s
    )
    flush_gps = n / flush_span
    emit(rows, "latency/flush_p50_ms", _percentile(flush_lat, 50) * 1e3,
         f"{n} reqs, flush every {flush_interval_s * 1e3:.0f}ms, "
         f"device={dev.type}")
    emit(rows, "latency/flush_p99_ms", _percentile(flush_lat, 99) * 1e3,
         f"{flush_gps:.1f} grids/s; {flush_lost} unresolved")

    # ---- continuous batching ----
    srv_cont = new_server()
    scheduler = StencilScheduler(srv_cont)
    try:
        cont_lat, cont_span, fired = replay_continuous(scheduler, trace)
    finally:
        scheduler.close()
    cont_gps = n / cont_span
    unresolved = sum(1 for _, t, _ in fired if not t.done())
    faults = sum(1 for _, t, _ in fired if t.exception() is not None)
    emit(rows, "latency/continuous_p50_ms", _percentile(cont_lat, 50) * 1e3,
         f"{n} reqs, gather window "
         f"{scheduler.gather_window_s * 1e3:.1f}ms")
    emit(rows, "latency/continuous_p99_ms", _percentile(cont_lat, 99) * 1e3,
         f"{cont_gps:.1f} grids/s; {unresolved} unresolved; "
         f"{faults} faults; "
         f"{scheduler.stats()['dispatched_batches']} batches")
    emit(rows, "latency/p99_improvement", 0.0,
         f"{_percentile(flush_lat, 99) / max(_percentile(cont_lat, 99), 1e-9):.1f}x "
         f"lower p99; throughput {cont_gps / flush_gps:.2f}x of flush")

    # ---- bitwise identity vs synchronous single-shot execution ----
    srv_ref = new_server()
    checked = 0
    bitwise = True
    sample = fired if smoke else fired[:: max(1, len(fired) // 50)]
    for _, ticket, request in sample:
        ref_out = srv_ref.serve([request])[0]
        got = ticket.result(timeout=60.0)
        bitwise &= bool(np.array_equal(got, ref_out))
        checked += 1
    emit(rows, "latency/bitwise_vs_sync", 0.0,
         f"{checked} results bit-identical to single-shot serve()")

    gates.correctness("latency/bitwise_vs_sync", bitwise)
    gates.correctness("latency/flush_lost", flush_lost, "==", 0)
    gates.correctness("latency/continuous_unresolved", unresolved, "==", 0)
    gates.correctness("latency/continuous_faults", faults, "==", 0)
    gates.correctness("latency/continuous_samples", len(cont_lat), "==", n)
    gates.correctness("latency/flush_samples", len(flush_lat), "==", n)
    gates.timing("latency/continuous_over_flush_throughput",
                 cont_gps / flush_gps, ">=", 0.9)
    gates.timing("latency/continuous_p99_ms", _percentile(cont_lat, 99) * 1e3,
                 "<=", _percentile(flush_lat, 99) * 1e3)
    if check:
        gates.assert_held()
    return rows


if __name__ == "__main__":
    sys.exit(main(
        run, sys.argv[1:], __doc__,
        "OK: Poisson open-loop trace served with zero drops; continuous "
        "batching sustains >= 0.9x flush-barrier throughput with p99 at "
        "or below the barrier's; every result bitwise-identical to "
        "synchronous single-shot serve()"))
