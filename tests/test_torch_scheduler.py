"""The port's StencilScheduler against the reference's contracts:
continuous batching, SLO lanes, quotas, backpressure, drain, fault
isolation, and results bitwise equal to the port's synchronous
``serve()``.

Everything runs on the CPU (``device="cpu"``, the kernels' plain
versions).  ``start=False`` schedulers are stepped deterministically
(``step()`` / manual ``drain()``); a couple of tests run the real
background thread to cover the drain barrier under concurrency.  Results
are held against the reference's oracle and, for a mixed-boundary trace,
against the reference's scheduler within ``tolerance_for``.
"""
from __future__ import annotations

import pickle
import time

import numpy as np
import pytest

from repro.core import dsl as ref_dsl
from repro.core import numerics as ref_numerics
from repro.kernels import ref as ref_kernels
from repro.runtime import DesignCache as RefDesignCache
from repro.serve import StencilRequest as RefStencilRequest
from repro.serve import StencilScheduler as RefStencilScheduler
from repro.serve import StencilServer as RefStencilServer

from repro_torch.configs import stencils
from repro_torch.core import dsl
from repro_torch.runtime import DesignCache
from repro_torch.serve import (
    Backpressure,
    StencilRequest,
    StencilScheduler,
    StencilServer,
)

RNG = np.random.default_rng(23)


def grid_request(design, spec):
    return StencilRequest(design, {
        n: RNG.standard_normal(shape).astype(dt)
        for n, (dt, shape) in spec.inputs.items()
    })


def oracle(spec, req, iters):
    rspec = ref_dsl.parse(dsl.format_spec(spec))
    return np.asarray(ref_kernels.stencil_iterations_ref(
        rspec, {n: np.asarray(a) for n, a in req.arrays.items()}, iters))


def small_server(max_batch=2, **kw):
    spec = stencils.jacobi2d(shape=(16, 8), iterations=2)
    srv = StencilServer(max_batch=max_batch, cache=DesignCache(),
                        warmup=True, device="cpu", **kw)
    srv.register("jac", spec)
    return srv, spec


def test_scheduler_results_match_oracle():
    srv, spec = small_server(max_batch=3)
    with StencilScheduler(srv, start=False) as sched:
        reqs = [grid_request("jac", spec) for _ in range(5)]
        tickets = [sched.submit(r) for r in reqs]
        sched.drain()
        for req, t in zip(reqs, tickets):
            np.testing.assert_allclose(
                t.result(), oracle(spec, req, 2), rtol=2e-4, atol=2e-4
            )
    st = sched.stats()
    assert st["admitted"] == st["completed"] == 5
    assert st["pending"] == st["inflight"] == st["failed"] == 0


def test_priority_lanes_order_dispatch_under_contention():
    """Six tickets contend for one design at max_batch=2: dispatch goes
    interactive pair, then standard, then batch -- by SLO deadline, not
    submission order (batch was submitted first)."""
    srv, spec = small_server(max_batch=2)
    sched = StencilScheduler(srv, start=False)
    lanes = ["batch", "batch", "standard", "standard",
             "interactive", "interactive"]
    tickets = {lane: [] for lane in ("interactive", "standard", "batch")}
    for lane in lanes:
        tickets[lane].append(
            sched.submit(grid_request("jac", spec), lane=lane)
        )

    assert sched.step()                     # dispatches exactly one chunk
    by_lane = sched.stats()["pending_by_lane"]
    assert "interactive" not in by_lane     # urgent pair left the queue
    assert by_lane == {"standard": 2, "batch": 2}

    assert sched.step()
    assert sched.stats()["pending_by_lane"] == {"batch": 2}

    sched.drain()
    order = {
        lane: max(t.completed_at for t in ts)
        for lane, ts in tickets.items()
    }
    assert order["interactive"] <= order["standard"] <= order["batch"]
    assert all(t.done() for ts in tickets.values() for t in ts)


def test_explicit_deadline_overrides_lane():
    """A batch-lane ticket with a tight explicit deadline jumps the
    standard-lane queue."""
    srv, spec = small_server(max_batch=1)
    sched = StencilScheduler(srv, start=False)
    slow = sched.submit(grid_request("jac", spec), lane="standard")
    urgent = sched.submit(
        grid_request("jac", spec), lane="batch", deadline_s=0.001
    )
    assert sched.step()
    assert sched.stats()["pending"] == 1
    sched.drain()
    assert urgent.completed_at <= slow.completed_at


def test_tenant_quota_exhaustion_is_backpressure_not_loss():
    srv, spec = small_server(max_batch=4)
    sched = StencilScheduler(srv, start=False, quota=2)
    first = [
        sched.submit(grid_request("jac", spec), tenant="acme")
        for _ in range(2)
    ]
    with pytest.raises(Backpressure) as exc_info:
        sched.submit(grid_request("jac", spec), tenant="acme")
    assert exc_info.value.retry_after_s > 0
    assert "acme" in str(exc_info.value)

    # other tenants are unaffected by acme's exhaustion
    other = sched.submit(grid_request("jac", spec), tenant="zen")
    sched.drain()
    assert all(t.done() for t in first) and other.done()

    # resolution frees the quota: the retry is admitted
    retry = sched.submit(grid_request("jac", spec), tenant="acme")
    sched.drain()
    assert retry.done() and retry.exception() is None
    assert sched.stats()["rejected"] == 1


def test_full_queue_backpressure():
    srv, spec = small_server()
    sched = StencilScheduler(srv, start=False, max_queue=1)
    kept = sched.submit(grid_request("jac", spec))
    with pytest.raises(Backpressure):
        sched.submit(grid_request("jac", spec))
    sched.drain()
    assert kept.done()


def test_backpressure_pickles_with_retry_hint():
    """The router ships Backpressure across process boundaries; the
    default exception reduce would drop retry_after_s."""
    err = pickle.loads(pickle.dumps(Backpressure("queue full", 0.25)))
    assert isinstance(err, Backpressure)
    assert err.retry_after_s == 0.25
    assert "queue full" in str(err)


def test_drain_resolves_every_ticket_with_background_thread():
    """drain() must not return while a chunk is mid-dispatch or mid-reap:
    every admitted ticket is done the moment drain() returns."""
    srv, spec = small_server(max_batch=2)
    with StencilScheduler(srv) as sched:       # real dispatch thread
        for _ in range(5):
            tickets = [
                sched.submit(grid_request("jac", spec)) for _ in range(5)
            ]
            sched.drain()
            assert all(t.done() for t in tickets), (
                "drain() returned with unresolved tickets"
            )
    assert sched.stats()["completed"] == 25


def test_unknown_design_and_lane_fail_fast():
    srv, spec = small_server()
    sched = StencilScheduler(srv, start=False)
    with pytest.raises(KeyError):
        sched.submit(grid_request("nope", spec))
    with pytest.raises(ValueError):
        sched.submit(grid_request("jac", spec), lane="warp-speed")
    assert sched.stats()["pending"] == 0


def test_dispatch_fault_resolves_tickets_with_the_error():
    """A runner blow-up fails the chunk's tickets, never strands them."""
    srv, spec = small_server(max_batch=2)
    boom = RuntimeError("device on fire")

    def broken(prepared):
        raise boom

    srv._designs["jac"].cached.runner = broken
    sched = StencilScheduler(srv, start=False)
    tickets = [sched.submit(grid_request("jac", spec)) for _ in range(2)]
    sched.drain()
    for t in tickets:
        assert t.done()
        with pytest.raises(RuntimeError, match="device on fire"):
            t.result()
    st = sched.stats()
    assert st["failed"] == 2 and st["completed"] == 0
    assert st["outstanding_by_tenant"] == {}


SHAPES = [(24, 16), (20, 12), (17, 9), (30, 28), (10, 30), (31, 31),
          (24, 16), (18, 10), (8, 8)]


def test_async_bitwise_equal_to_sync_on_mixed_boundary_trace():
    """The scheduler stages through the engine's own padded _prepare, so a
    mixed-shape bucketed trace matches the synchronous serve() path bit
    for bit, however batches coalesced; and it agrees with the
    reference's scheduler within the certified tolerance."""
    iters = 3
    spec = stencils.jacobi2d(shape=(24, 16), iterations=iters)
    cache = DesignCache()

    def requests(rng, cls=StencilRequest):
        return [
            cls("jac", {"in_1": rng.standard_normal(s).astype(np.float32)})
            for s in SHAPES
        ]

    srv_sync = StencilServer(max_batch=3, cache=cache, bucketing=True,
                             device="cpu")
    srv_sync.register("jac", spec)
    outs_sync = srv_sync.serve(requests(np.random.default_rng(7)))

    srv_async = StencilServer(max_batch=3, cache=cache, bucketing=True,
                              device="cpu")
    srv_async.register("jac", spec)
    with StencilScheduler(srv_async) as sched:
        tickets = [sched.submit(r) for r in requests(np.random.default_rng(7))]
        sched.drain()
    outs_async = [t.result() for t in tickets]

    text = dsl.format_spec(spec)
    ref_srv = RefStencilServer(max_batch=3, cache=RefDesignCache(),
                               bucketing=True)
    ref_srv.register("jac", text)
    ref_reqs = requests(np.random.default_rng(7), RefStencilRequest)
    with RefStencilScheduler(ref_srv) as ref_sched:
        ref_tickets = [ref_sched.submit(r) for r in ref_reqs]
        ref_sched.drain()
    rspec = ref_dsl.parse(text)
    for a, s, rt, req, shape in zip(outs_async, outs_sync, ref_tickets,
                                    ref_reqs, SHAPES):
        assert a.shape == shape
        np.testing.assert_array_equal(a, s)
        bound = ref_numerics.tolerance_for(
            rspec, iters, {"in_1": req.arrays["in_1"]})
        assert float(np.abs(a - np.asarray(rt.result())).max()) <= bound


def test_gather_window_coalesces_trickled_arrivals():
    """Arrivals inside the gather window ride one batch; the window
    lapsing dispatches a partial batch rather than waiting forever."""
    srv, spec = small_server(max_batch=4)
    # batch lane (5 s deadline) keeps deadline slack out of the picture
    sched = StencilScheduler(srv, start=False, gather_window_s=2.0)
    t1 = sched.submit(grid_request("jac", spec), lane="batch")
    assert not sched.step()                 # 1 < max_batch, window open
    for _ in range(3):
        sched.submit(grid_request("jac", spec), lane="batch")
    assert sched.step()                     # full batch dispatches now
    sched.drain()
    assert sched.stats()["dispatched_batches"] == 1
    assert t1.done()

    lone = StencilScheduler(srv, start=False, gather_window_s=0.005)
    lone_t = lone.submit(grid_request("jac", spec), lane="batch")
    time.sleep(0.01)
    assert lone.step()                      # window lapsed: partial batch
    lone.drain()
    assert lone_t.done()


def test_scheduler_stats_are_finite_clean():
    srv, spec = small_server()
    with StencilScheduler(srv, start=False) as sched:
        sched.submit(grid_request("jac", spec))
        sched.drain()
        st = sched.stats()

    def assert_finite(node):
        if isinstance(node, dict):
            for v in node.values():
                assert_finite(v)
        elif isinstance(node, (int, float)):
            assert np.isfinite(node)

    assert_finite(st)


def test_drain_persists_telemetry_to_the_store(tmp_path):
    """drain() writes the server's counters through to its store, as the
    reference's does, so a restarted replica resumes them."""
    spec = stencils.jacobi2d(shape=(16, 8), iterations=2)
    srv = StencilServer(max_batch=2, device="cpu", bucketing=True,
                        store_dir=str(tmp_path / "store"))
    srv.register("jac", spec)
    with StencilScheduler(srv, start=False) as sched:
        for _ in range(3):
            sched.submit(grid_request("jac", spec))
        sched.drain()
    bd = srv.design("jac").cached
    bucket, = bd.buckets
    again = DesignCache(store=str(tmp_path / "store")).bucketed(
        spec, device="cpu")
    assert again.stats()[bucket]["requests"] == 3
