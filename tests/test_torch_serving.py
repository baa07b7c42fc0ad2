"""The port's bucketed ``StencilServer`` against the JAX reference's.

Served on the CPU through the CUDA kernels' plain versions
(``device="cpu"``):

  * a mixed-boundary trace at the size of the reference's smoke run
    (``benchmarks/serving_throughput.py --smoke``: 4 modes x 5 shapes in
    [18, 48) x [12, 28), 3 iterations, ``max_batch=4``), with bucket
    shapes wider than one 32x32 tile so column tiles straddle the real
    edge.  The port's server agrees with the reference's
    ``StencilServer(bucketing=True)`` within ``tolerance_for``, is bitwise
    equal to its own single-shot ``build_bucket_runner``, and async
    dispatch equals sync bitwise;
  * the plain round loop of a replicate and a periodic bucket spec with
    per-entry maps agrees with the reference's Pallas kernel
    (``stencil_run_batched(backend="pallas", interpret=True)``);
  * the reference's serving contracts: fault isolation per chunk, ticket
    order, eager validation, micro-batch sharing.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dsl as ref_dsl
from repro.core import numerics
from repro.kernels import pipeline as ref_pipeline
from repro.runtime import DesignCache as RefDesignCache
from repro.runtime import bucketing as ref_bucketing
from repro.serve import StencilRequest as RefStencilRequest
from repro.serve import StencilServer as RefStencilServer

from repro_torch.core import dsl
from repro_torch.core.ir import lower
from repro_torch.kernels import ops, pipeline
from repro_torch.runtime import (
    DesignCache,
    ShapeBucketer,
    bucket_plan,
    build_bucket_runner,
    padded_request_shape,
)
from repro_torch.serve import StencilRequest, StencilServer

ITERS = 3
MODES = ["zero", "constant 25.0", "replicate", "periodic"]
# benchmarks/serving_throughput.py::BOUNDARY_DSL
BOUNDARY_DSL = """
kernel: JACOBI2D_{tag}
iteration: {it}
boundary: {boundary}
input float: in_1({r}, {c})
output float: out_1(0,0) = (in_1(0,1) + in_1(1,0) + in_1(0,0)
    + in_1(0,-1) + in_1(-1,0)) / 5
"""
# buckets wider than one 32x32 tile on both axes
LADDER = ((48, 64), (40, 48))


def spec_text(mode, shape, iters=ITERS):
    return BOUNDARY_DSL.format(tag=mode.split()[0].upper(), it=iters,
                               boundary=mode, r=shape[0], c=shape[1])


@pytest.fixture(scope="module")
def trace():
    rng = np.random.default_rng(2)
    traffic = {}
    for mode in MODES:
        shapes = [(int(rng.integers(18, 48)), int(rng.integers(12, 28)))
                  for _ in range(5)]
        traffic[mode] = [
            (s, {"in_1": rng.standard_normal(s).astype(np.float32)})
            for s in shapes
        ]
    cache = DesignCache()
    servers = {}
    for async_dispatch in (True, False):
        srv = StencilServer(
            device="cpu", max_batch=4, cache=cache,
            bucketing=ShapeBucketer(ladder=LADDER),
            async_dispatch=async_dispatch,
        )
        for mode in MODES:
            srv.register(mode.split()[0], spec_text(mode, traffic[mode][0][0]))
        servers[async_dispatch] = srv
    reqs = [StencilRequest(m.split()[0], a) for m in MODES for _, a in traffic[m]]
    outs = {k: srv.serve(reqs) for k, srv in servers.items()}
    ref = RefStencilServer(max_batch=4, cache=RefDesignCache(), bucketing=True)
    for mode in MODES:
        ref.register(mode.split()[0],
                     ref_dsl.parse(spec_text(mode, traffic[mode][0][0])))
    ref_outs = ref.serve([RefStencilRequest(m.split()[0], a)
                          for m in MODES for _, a in traffic[m]])
    return traffic, servers, outs, ref_outs


def _items(traffic):
    return [(m, s, a) for m in MODES for s, a in traffic[m]]


def test_trace_agrees_with_reference_server(trace):
    traffic, servers, outs, ref_outs = trace
    items = _items(traffic)
    assert len(items) == 20 and len({s for _, s, _ in items}) >= 15
    for (mode, shape, arrays), got, want in zip(items, outs[True], ref_outs):
        assert got.shape == shape == want.shape
        bound = numerics.tolerance_for(
            ref_dsl.parse(spec_text(mode, shape)), ITERS, arrays)
        err = float(np.abs(got - want).max())
        assert err <= bound, (mode, shape, err, bound)
    st = servers[True].stats()
    assert sum(st[m.split()[0]]["requests"] for m in MODES) == 20
    # every bucket is wider than one tile: tiles straddle the real edge
    for m in MODES:
        for b in servers[True].design(m.split()[0]).cached.buckets:
            assert min(b) > 32


def test_trace_bitwise_equals_single_shot_bucket_runner(trace):
    traffic, servers, outs, _ = trace
    srv = servers[True]
    for (mode, shape, arrays), got in zip(_items(traffic), outs[True]):
        bd = srv.design(mode.split()[0]).cached
        entry = bd.runner_for(shape, count=0)
        sp = dsl.parse(spec_text(mode, shape))
        minimal = padded_request_shape(sp, shape, ITERS, bd.wrap_rounds)
        single = build_bucket_runner(
            sp, minimal, entry.config, iterations=ITERS, device="cpu",
            wrap_rounds=bd.wrap_rounds,
        )({n: a[None] for n, a in arrays.items()})[0]
        np.testing.assert_array_equal(got, single, err_msg=f"{mode} {shape}")


def test_trace_async_equals_sync_bitwise(trace):
    _, _, outs, _ = trace
    for a, b in zip(outs[True], outs[False]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["replicate", "periodic"])
def test_plain_streamed_rounds_match_pallas(mode):
    """Per-entry maps (two real grids and the all-zero filler) through the
    port's plain K2 round loop and the reference's Pallas kernel."""
    rng = np.random.default_rng(8)
    shape, bucket = (26, 19), (40, 36)
    wrap = 2 if mode == "periodic" else None
    ref_spec = ref_dsl.parse(spec_text(mode, shape, iters=4))
    spec = lower(dsl.parse(spec_text(mode, shape, iters=4))).spec
    ref_plan = ref_bucketing.bucket_plan(ref_spec, bucket, 4, wrap)
    plan = bucket_plan(spec, bucket, 4, wrap)
    grids = [shape, (21, 14)]
    data = [rng.standard_normal(g).astype(np.float32) for g in grids]
    entries = []
    for g, a in zip(grids, data):
        e = {"in_1": plan.place_entry(a)}
        e.update(plan.service_entry(g))
        entries.append(e)
    e = {"in_1": plan.filler_entry("in_1")}
    e.update(plan.service_filler())
    entries.append(e)
    batch = {n: np.stack([x[n] for x in entries]) for n in plan.mspec.inputs}
    got = pipeline.stencil_run_batched(
        plan.mspec, ops.to_device(plan.mspec, batch, "cpu"), 4, s=2,
        tile=(16, 16),
    ).numpy()
    want = np.asarray(ref_pipeline.stencil_run_batched(
        ref_plan.mspec,
        {n: jnp.asarray(a) for n, a in batch.items()}, 4, s=2, tile_rows=8,
        backend="pallas", interpret=True,
    ))
    for b, (g, a) in enumerate(zip(grids, data)):
        sp = ref_dsl.parse(spec_text(mode, g, iters=4))
        bound = numerics.tolerance_for(sp, 4, {"in_1": a})
        idx = plan.out_index(g)
        err = float(np.abs(got[b][idx] - want[b][idx]).max())
        assert err <= bound, (mode, b, err, bound)
    np.testing.assert_array_equal(got[2], want[2])       # filler: all fill


# ---------------------------------------------------------------------------
# Serving contracts (mirroring tests/test_serving.py)
# ---------------------------------------------------------------------------


def _server(**kw):
    kw.setdefault("max_batch", 2)
    return StencilServer(device="cpu", cache=DesignCache(), **kw)


def _oracle(text, arrays, iters):
    spec = dsl.parse(text)
    spec = dataclasses.replace(spec, inputs={
        n: (dt, np.shape(arrays[n])) for n, (dt, _) in spec.inputs.items()})
    return ops.stencil_run(spec, arrays, iters, backend="ref",
                           device="cpu").numpy()


def _req(name, shape, rng):
    return StencilRequest(name, {"in_1": rng.standard_normal(shape).astype(np.float32)})


def test_dispatch_fault_isolates_to_its_chunk():
    rng = np.random.default_rng(1)
    text = spec_text("zero", (12, 6), iters=2)
    srv = _server()
    srv.register("jac", text)
    reqs = [_req("jac", (12, 6), rng) for _ in range(4)]     # 2 chunks
    tickets = [srv.submit(r) for r in reqs]
    runner = srv.design("jac").cached.runner
    calls = {"n": 0}

    def flaky(arrays):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected dispatch fault")
        return runner(arrays)

    srv.design("jac").cached.runner = flaky
    done = srv.flush()
    assert sorted(done) == tickets[2:]
    np.testing.assert_allclose(done[tickets[2]],
                               _oracle(text, reqs[2].arrays, 2),
                               rtol=2e-4, atol=2e-4)
    assert set(srv.failures) == set(tickets[:2])
    assert srv.stats()["jac"]["failed_requests"] == 2
    with pytest.raises(RuntimeError, match="failed to dispatch"):
        srv.design("jac").cached.runner = lambda a: 1 / 0
        srv.serve([reqs[0]])


def test_bucketed_fault_isolates_to_its_chunk():
    rng = np.random.default_rng(2)
    srv = _server(bucketing=True)
    srv.register("jac", spec_text("replicate", (16, 12), iters=2))
    reqs = [_req("jac", s, rng) for s in [(16, 12), (13, 9), (9, 16), (12, 12)]]
    tickets = [srv.submit(r) for r in reqs]
    entry = srv.design("jac").cached.runner_for((16, 12), count=0)
    dispatch = entry.runner.dispatch
    calls = {"n": 0}

    def flaky(staged):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected dispatch fault")
        return dispatch(staged)

    entry.runner.dispatch = flaky
    done = srv.flush()
    entry.runner.dispatch = dispatch
    assert sorted(done) == tickets[:2] and set(srv.failures) == set(tickets[2:])
    for t, r in zip(tickets[:2], reqs):
        np.testing.assert_allclose(
            done[t], _oracle(spec_text("replicate", (16, 12), iters=2),
                             r.arrays, 2), rtol=2e-4, atol=2e-4)


def test_tickets_resolve_in_submission_order():
    rng = np.random.default_rng(3)
    text = spec_text("zero", (12, 6), iters=2)
    srv = _server(bucketing=True)
    srv.register("jac", text)
    reqs = [_req("jac", s, rng) for s in [(12, 6), (20, 30), (9, 9)]]
    tickets = [srv.submit(r) for r in reqs]
    assert tickets == sorted(tickets)
    done = srv.flush()
    assert sorted(done) == tickets
    outs = srv.serve(reqs)
    for t, r, out in zip(tickets, reqs, outs):
        np.testing.assert_array_equal(done[t], out)
        assert out.shape == r.arrays["in_1"].shape
    assert srv.flush() == {}


def test_submit_validates_eagerly():
    srv = _server(bucketing=ShapeBucketer(max_shape=(32, 32)))
    srv.register("jac", spec_text("replicate", (16, 12), iters=2))
    exact = _server()
    exact.register("jac", spec_text("zero", (12, 6), iters=2))
    with pytest.raises(KeyError, match="not registered"):
        srv.submit(StencilRequest("nope", {}))
    with pytest.raises(ValueError, match="missing input"):
        exact.submit(StencilRequest("jac", {}))
    with pytest.raises(ValueError, match="must be shaped"):
        exact.submit(StencilRequest("jac", {"in_1": np.zeros((6, 12), np.float32)}))
    with pytest.raises(ValueError, match="unknown input"):
        srv.submit(StencilRequest("jac", {"in_1": np.zeros((8, 8), np.float32),
                                          "in_2": np.zeros((8, 8), np.float32)}))
    with pytest.raises(ValueError, match="2-D grid"):
        srv.submit(StencilRequest("jac", {"in_1": np.zeros((8, 8, 3), np.float32)}))
    with pytest.raises(ValueError, match="not bucketable"):
        srv.submit(StencilRequest("jac", {"in_1": np.zeros((64, 8), np.float32)}))
    assert srv.flush() == {} and exact.flush() == {}


def test_bucketed_grids_share_a_micro_batch():
    rng = np.random.default_rng(4)
    text = spec_text("periodic", (16, 12), iters=2)
    srv = _server(max_batch=4, bucketing=ShapeBucketer(ladder=((40,), (40,))))
    srv.register("jac", text)
    reqs = [_req("jac", s, rng) for s in [(16, 12), (13, 9), (9, 16)]]
    outs = srv.serve(reqs)
    st = srv.stats()["jac"]
    assert st["batches"] == 1 and st["compiled_buckets"] == 1
    assert st["padded_grids"] == 1
    for r, out in zip(reqs, outs):
        np.testing.assert_allclose(out, _oracle(text, r.arrays, 2),
                                   rtol=2e-4, atol=2e-4)


def test_register_idempotent_and_collisions():
    srv = _server(bucketing=True)
    a = spec_text("zero", (16, 12), iters=2)
    r1 = srv.register("jac", a)
    assert srv.register("jac", spec_text("zero", (24, 10), iters=2)) is r1
    with pytest.raises(ValueError, match="already registered"):
        srv.register("jac", spec_text("replicate", (16, 12), iters=2))
    with pytest.raises(ValueError, match="already registered"):
        srv.register("jac", a, bucketing=False)
    assert r1.diagnostics[-1].code == "SASA500"


def test_stats_finite_and_cache_hits():
    cache = DesignCache()
    text = spec_text("zero", (12, 6), iters=2)
    s1 = StencilServer(device="cpu", max_batch=2, cache=cache, warmup=False)
    s1.register("idle", text)
    st = s1.stats()
    assert st["idle"]["exec_count"] == 0 and st["idle"]["exec_mean_s"] == 0.0
    assert st["_cache"]["misses"] > 0
    s2 = StencilServer(device="cpu", max_batch=2, cache=cache)
    assert s2.register("idle", text).counters.cache_hit


def test_server_needs_cuda_unless_asked_for_the_cpu():
    with pytest.raises(NotImplementedError, match="store"):
        StencilServer(device="cpu", store_dir="somewhere")
    with pytest.raises(NotImplementedError, match="store"):
        DesignCache(store="somewhere")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StencilServer()
