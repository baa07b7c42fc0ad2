"""The device pool through the port's runtime, held against the reference.

  * Degraded designs (``tests/test_runtime.py``'s contract): a config
    needing more devices than the pool holds warns
    ``DegradedDesignWarning`` with the reference's message, or raises
    under ``strict``; strict and lax callers share cache entries; a
    temporal design on one device is not degraded; a runner cached while
    degraded is rebuilt when the pool grows.
  * Preflight parity (``tests/test_analysis.py``'s): every refusal
    ``candidate_verdict`` predicts raises in the port's ``build_runner``,
    and every predicted-feasible candidate builds.
  * The ranker on a pool: one card ranks exactly as before; on four, the
    ``(variant, k)`` pairs and their guards are the reference's
    ``tpu_candidate_configs``; the shard prediction prices the reference's
    collective bytes and messages.
  * ``autotune``, ``soda_baseline``, ``DesignCache`` and ``StencilServer``
    take a pool, here ``[torch.device("cpu")] * k``.
"""
from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np
import pytest
import torch

from _torch_distribute_cases import (
    POOL,
    assert_close,
    inputs,
    oracle,
    port,
    ref_spec,
)
from repro.configs import stencils as ref_stencils
from repro.core import model as ref_model
from repro.core.platform import DEFAULT_TPU
from repro.core.spec import Boundary as RefBoundary
from repro.runtime.batching import degraded_message as ref_degraded_message
from repro.core.model import ParallelismConfig as RefConfig

from repro_torch.core import distribute, model
from repro_torch.core.analysis import candidate_verdict
from repro_torch.core.autotune import autotune, soda_baseline
from repro_torch.core.model import ParallelismConfig
from repro_torch.core.platform import H100_SXM
from repro_torch.runtime import DesignCache
from repro_torch.runtime.batching import (
    DegradedDesignWarning,
    build_batched_runner,
    degraded_message,
)
from repro_torch.runtime.bucketing import masked_spec
from repro_torch.serve import StencilRequest, StencilServer

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# degraded designs (device pool smaller than the config claims)
# ---------------------------------------------------------------------------


def test_degraded_design_warns_and_is_flagged():
    """hybrid_r(k=8) on a one-device pool must not *silently* degrade."""
    spec_ref = ref_spec("jacobi2d", (64, 8), 2)
    spec = port(spec_ref)
    cfg = ParallelismConfig("hybrid_r", k=8, s=2)
    with pytest.warns(DegradedDesignWarning, match="needs 8 device"):
        run = build_batched_runner(spec, cfg, device="cpu")
    assert run.degraded
    assert run.cfg.k == 8                 # the config still claims k=8 ...
    assert run.n_devices == 1             # ... but execution is single-PE
    assert run.devices_requested == 8
    assert run.path == "single_pe"
    arrays = inputs(spec, batch=2)
    out = run(arrays)                     # degraded, but still correct
    assert_close(out[0], oracle(spec_ref, arrays, 2, 0), "degraded")


def test_degraded_design_raises_under_strict():
    spec = port(ref_spec("jacobi2d", (64, 8), 2))
    cfg = ParallelismConfig("spatial_s", k=4, s=1)
    with pytest.raises(ValueError, match="needs 4 device") as info:
        build_batched_runner(spec, cfg, device="cpu", strict=True)
    assert str(info.value) == ref_degraded_message(
        RefConfig("spatial_s", k=4, s=1), 1
    ) == degraded_message(cfg, 1)


def test_degraded_on_a_pool_runs_on_what_it_has():
    """hybrid_s(k=8) on a pool of 4: warned, and sharded over the 4."""
    spec_ref = ref_spec("jacobi2d", (64, 8), 2)
    spec = port(spec_ref)
    with pytest.warns(DegradedDesignWarning, match="only 4 are available"):
        run = build_batched_runner(
            spec, ParallelismConfig("hybrid_s", k=8, s=2), devices=POOL[:4]
        )
    assert (run.path, run.n_devices, run.devices_requested) == (
        "shard_map", 4, 8
    )
    arrays = inputs(spec, batch=2)
    assert_close(run(arrays)[1], oracle(spec_ref, arrays, 2, 1), "pool of 4")


def test_strict_and_lax_callers_share_cache_entries():
    """strict only matters for degraded configs: on a feasible config a
    strict lookup must hit the entry a non-strict caller built."""
    cache = DesignCache()
    spec = port(ref_spec("jacobi2d", (16, 8), 2))
    cfg = ParallelismConfig("temporal", k=1, s=2)
    first = cache.runner(spec, cfg, device="cpu")
    misses = cache.misses
    again = cache.runner(spec, cfg, device="cpu", strict=True)
    assert again is first and cache.misses == misses
    # ... while a degraded config still refuses under strict, pre-cache
    bad = ParallelismConfig("hybrid_s", k=2, s=2)
    with pytest.raises(ValueError, match="needs 2 device"):
        cache.runner(spec, bad, device="cpu", strict=True)
    assert cache.misses == misses


def test_temporal_on_one_device_is_not_degraded():
    """The sanctioned degenerate case: a temporal cascade on one device
    runs as fused rounds, with no warning and no degraded flag."""
    spec = port(ref_spec("jacobi2d", (16, 8), 4))
    with warnings.catch_warnings():
        warnings.simplefilter("error", DegradedDesignWarning)
        run = build_batched_runner(
            spec, ParallelismConfig("temporal", k=1, s=4), device="cpu"
        )
    assert not run.degraded and run.n_devices == 1


def test_pool_change_rebuilds_degraded_runner():
    """A runner cached while degraded (pool < config) is not reused when
    the pool grows: the pool and the device count used are in the key."""
    cache = DesignCache()
    spec = port(ref_spec("jacobi2d", (64, 8), 2))
    cfg = ParallelismConfig("hybrid_s", k=2, s=2)
    with pytest.warns(DegradedDesignWarning):
        first = cache.runner(spec, cfg, devices=[CPU])   # degraded: 1 device
    assert first.degraded
    assert cache.runner(spec, cfg, devices=[CPU]) is first   # same pool: hit
    misses = cache.misses
    rebuilt = cache.runner(spec, cfg, devices=[CPU] * 2)
    assert cache.misses == misses + 1
    assert rebuilt is not first and not rebuilt.degraded
    assert (rebuilt.n_devices, rebuilt.path) == (2, "shard_map")
    x = inputs(spec, batch=1)
    np.testing.assert_allclose(rebuilt(x), first(x), rtol=2e-4, atol=2e-4)


def test_no_pool_needs_cuda(monkeypatch):
    """With neither device nor devices, the pool is every visible CUDA
    device: without CUDA the entry points raise, never fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = port(ref_spec("jacobi2d", (16, 8), 2))
    cfg = ParallelismConfig("spatial_s", k=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_batched_runner(spec, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distribute.build_runner(spec, cfg)
    with pytest.raises(ValueError, match="not both"):
        build_batched_runner(spec, cfg, device="cpu", devices=[CPU])


def test_unindexed_cuda_is_the_current_card(monkeypatch):
    """``cuda`` and ``cuda:0`` name one card in a pool, so cache keys built
    from either agree."""
    from repro_torch.kernels.ops import resolve_pool

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    want = [torch.device("cuda", 0)]
    assert resolve_pool(device="cuda") == want
    assert resolve_pool(devices=["cuda", "cuda:0"]) == want * 2
    assert resolve_pool(device="cpu") == [CPU]


# ---------------------------------------------------------------------------
# preflight parity with the port's build_runner
# ---------------------------------------------------------------------------


PARITY_SPECS = [
    ref_spec("jacobi2d", (4, 8), 8),
    ref_spec("jacobi2d", (16, 8), 2),
    ref_spec("jacobi2d", (30, 8), 2, RefBoundary("periodic")),
    ref_spec("jacobi2d", (12, 8), 3, RefBoundary("replicate")),
    ref_spec("heat3d", (12, 6, 6), 3, RefBoundary("periodic")),
    ref_spec("blur_jacobi2d", (40, 16), 4, RefBoundary("constant", 1.5)),
]
PARITY_CFGS = [
    ParallelismConfig(v, k=k, s=s)
    for v, s in [("spatial_s", 1), ("spatial_r", 1), ("hybrid_s", 2),
                 ("hybrid_r", 2)]
    for k in (1, 2, 4, 8)
] + [ParallelismConfig("temporal", s=s) for s in (1, 2, 4)]


def _parity(spec, cfg, n):
    """candidate_verdict over a pool of n against build_runner on the
    devices it would slice; returns the verdict."""
    v = candidate_verdict(spec, cfg, n)
    pool = POOL[:min(cfg.devices_needed, n)]
    if v.feasible:
        assert callable(distribute.build_runner(spec, cfg, devices=pool))
    else:
        with pytest.raises(ValueError):
            distribute.build_runner(spec, cfg, devices=pool)
    # an explicit pool is used whole: k_override is its length
    kv = candidate_verdict(spec, cfg, 8, k_override=len(POOL))
    if kv.feasible:
        assert callable(distribute.build_runner(spec, cfg, devices=POOL))
    else:
        with pytest.raises(ValueError):
            distribute.build_runner(spec, cfg, devices=POOL)
    return v


@pytest.mark.parametrize("idx", range(len(PARITY_SPECS)))
def test_preflight_matches_build_runner(idx):
    spec = port(PARITY_SPECS[idx])
    verdicts = [_parity(spec, cfg, 8) for cfg in PARITY_CFGS]
    if spec.boundary.kind == "periodic" and spec.rows == 30:
        assert any(v.code == "SASA302" for v in verdicts)


def test_preflight_reference_cases():
    """The reference's own parity cases (``test_analysis.py``), the wrap
    spec included, on the pool of 8."""
    cases = [
        (port(ref_spec("jacobi2d", (4, 8), 8)),
         ParallelismConfig("spatial_r", k=1)),
        (port(ref_spec("jacobi2d", (16, 8), 2)),
         ParallelismConfig("spatial_s", k=4)),
        (port(ref_spec("jacobi2d", (16, 8), 2)),
         ParallelismConfig("temporal", s=2)),
        (masked_spec(port(ref_spec("jacobi2d", (16, 8), 2,
                                   RefBoundary("periodic"))), wrap_rounds=1),
         ParallelismConfig("spatial_s", k=2)),
    ]
    codes = [_parity(spec, cfg, 8).code for spec, cfg in cases]
    assert codes == ["SASA305", None, None, "SASA304"]


# ---------------------------------------------------------------------------
# the ranker on a pool
# ---------------------------------------------------------------------------


def _ranked(preds):
    return [(p.config, p.latency, p.hbm_bytes, p.cell_updates) for p in preds]


@pytest.mark.parametrize("name", list(ref_stencils.BENCHMARKS))
def test_one_gpu_ranking_unchanged(name):
    """On a pool of one the ranking is the single-card one: temporal
    only, identical whether the platform says one GPU or not; a larger
    pool adds shard candidates without repricing the temporal ones."""
    base = ref_stencils.get(name, iterations=16)
    size = (9720, 32, 32) if base.ndim == 3 else (9720, 1024)
    for boundary in [None] + [RefBoundary("constant", 1.5),
                              RefBoundary("replicate"),
                              RefBoundary("periodic")]:
        spec = port(ref_spec(name, size, 16, boundary))
        one = model.choose_best(spec, H100_SXM)
        assert _ranked(one) == _ranked(model.choose_best(
            spec, H100_SXM.with_gpus(1)))
        assert {p.config.variant for p in one} == {"temporal"}
        four = {p.config: p.latency for p in model.choose_best(
            spec, H100_SXM.with_gpus(4))}
        assert all(four[p.config] == p.latency for p in one)
        assert any(c.k == 4 for c in four)


POOL_SPECS = [
    ("jacobi2d", (96, 20), 4),
    ("jacobi2d", (16, 8), 8),      # it*r > rows/device at k=4: no *_r there
    ("jacobi2d", (6, 8), 2),       # rows/device < 2r at k=4: no k=4
    ("heat3d", (64, 6, 6), 4),
    ("blur_jacobi2d", (24, 16), 3),
]


@pytest.mark.parametrize("bench,shape,iters", POOL_SPECS,
                         ids=[f"{b}-{s[0]}" for b, s, _ in POOL_SPECS])
def test_pool_candidates_match_reference(bench, shape, iters):
    spec_ref = ref_spec(bench, shape, iters)
    spec = port(spec_ref)
    want = {(c.variant, c.k) for c in ref_model.tpu_candidate_configs(
        spec_ref, DEFAULT_TPU.with_chips(4))}
    cfgs = model.gpu_candidate_configs(spec, H100_SXM.with_gpus(4))
    assert {(c.variant, c.k) for c in cfgs} == want
    r, rows = spec.radius, {2: shape[0] // 2, 4: shape[0] // 4}
    for c in cfgs:
        if c.k == 1:
            assert c.variant == "temporal"
            continue
        assert rows[c.k] >= 2 * r and c.buffer_depth == 0
        if c.variant.endswith("_r"):
            assert iters * r <= rows[c.k]
        if c.variant == "hybrid_s":
            assert c.s > 1 and c.s * r <= rows[c.k]
        if c.variant.startswith("spatial"):
            assert c.s == 1


def test_shard_prediction_prices_the_collectives():
    """A shard design is priced as it runs: the operators it launches at
    the measured host cost of one, against its whole-band passes, plus
    the reference's collective bytes over the link and a latency per
    message."""
    spec = port(ref_spec("jacobi2d", (9720, 1024), 16))
    gpu = H100_SXM.with_gpus(4)
    C, item, it = 1024, 4, 16

    p = model.predict_gpu(spec, ParallelismConfig("spatial_s", k=4), gpu)
    assert p.collective_bytes == 2 * 1 * C * item * it
    assert p.collective_term == pytest.approx(
        p.collective_bytes / gpu.link_bw + 2 * it * gpu.link_latency_s)
    ops, passes = distribute.block_call_work(spec, 1)
    # 16 block calls on each of 4 shards; 16 exchanges of the iterate,
    # each 4 concatenations, 2 zero edges and 6 peer copies
    assert p.launches == 4 * it * ops + it * (4 + 2 + 6)
    assert p.host_term == pytest.approx(p.launches * gpu.eager_op_s)
    assert p.hbm_bytes == 3 * (2430 + 2) * C * item * it * passes
    assert p.latency == pytest.approx(
        max(p.host_term, p.memory_term) + p.collective_term)
    assert p.bottleneck == "host" and p.compute_term == 0.0

    p = model.predict_gpu(spec, ParallelismConfig("hybrid_r", k=4, s=8), gpu)
    assert p.collective_bytes == 2 * min(it, 2430) * C * item
    assert p.launches == 4 * 2 * distribute.block_call_work(spec, 8)[0] + 12
    p = model.predict_gpu(spec, ParallelismConfig("hybrid_s", k=4, s=8), gpu)
    assert p.collective_bytes == 2 * 8 * C * item * math.ceil(it / 8)
    assert p.bottleneck in ("compute", "memory", "collective", "host")
    # the temporal designs keep the one-card tile-kernel model
    t = model.predict_gpu(spec, ParallelismConfig("temporal", s=8), gpu)
    assert t == model.predict_gpu(spec, ParallelismConfig("temporal", s=8),
                                  H100_SXM)
    assert t.latency < p.latency


SHARD_COPIES = [   # peer copies of the run on 4 cards: exchanges x copies
    ("jacobi2d", None, ParallelismConfig("spatial_s", k=4), 6 * 6),
    ("jacobi2d", None, ParallelismConfig("spatial_r", k=4), 1 * 6),
    ("jacobi2d", None, ParallelismConfig("hybrid_s", k=4, s=4), 2 * 6),
    ("hotspot", None, ParallelismConfig("hybrid_r", k=4, s=4), 2 * 6),
    ("hotspot", RefBoundary("periodic"),
     ParallelismConfig("spatial_s", k=4), 7 * 8),
    ("sobel2d_replicate", None, ParallelismConfig("hybrid_s", k=4, s=4),
     2 * 6),
]


@pytest.mark.parametrize("bench,boundary,cfg,copies", SHARD_COPIES)
def test_shard_launches_are_what_runs(bench, boundary, cfg, copies):
    """The launches the ranker prices are the operators the shard runner
    dispatches (counted on a CPU pool, where the copies between shards
    of one device are no-ops), plus the peer copies of four cards."""
    from torch.utils._python_dispatch import TorchDispatchMode

    spec = port(ref_spec(bench, (64, 10), 6, boundary))
    run = distribute.build_runner(spec, cfg, devices=POOL[:4])
    staged = run.stage(inputs(spec))
    count = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            count[0] += not func.is_view
            return func(*args, **(kwargs or {}))

    with Count():
        run.dispatch(staged)
    p = model.predict_gpu(spec, cfg, H100_SXM.with_gpus(4))
    assert p.launches == count[0] + copies


# ---------------------------------------------------------------------------
# autotune, soda_baseline, DesignCache and StencilServer on a pool
# ---------------------------------------------------------------------------


def test_autotune_on_a_pool_weighs_shards_and_soda_does_not():
    """autotune ranks the row partitions for the pool and soda_baseline
    does not; priced as they run (eager torch), every shard design loses
    to the tile kernel, so both pick the same temporal design."""
    spec = port(ref_spec("jacobi2d", (2048, 256), 16))
    pool = POOL[:4]
    td = autotune(spec, devices=pool, build=False)
    soda = soda_baseline(spec, devices=pool, build=False)
    shards = [p for p in td.ranking if p.config.k == 4]
    assert shards and all(p.config.tile_rows == 0 for p in shards)
    assert {p.config.variant for p in soda.ranking} == {"temporal"}
    assert td.config == soda.config and td.config.variant == "temporal"
    assert min(p.latency for p in shards) > td.prediction.latency
    # one device: both rank the same temporal-only space
    one = autotune(spec, device="cpu", build=False)
    assert one.config == soda_baseline(spec, device="cpu", build=False).config


def test_autotune_builds_on_a_pool():
    """On a pool the chosen temporal design runs the tile kernel on the
    pool's first device, as does any temporal config: its stages fuse on
    one card, not degraded, with no warning."""
    spec_ref = ref_spec("jacobi2d", (2048, 256), 16)
    design = autotune(port(spec_ref), devices=POOL[:4])
    assert design.config.variant == "temporal"
    assert design.runner.batched.path == "single_pe"
    assert design.runner.batched.n_devices == 1
    x = inputs(port(spec_ref))
    assert_close(design.runner(x), oracle(spec_ref, x, 16), "autotune pool")
    with warnings.catch_warnings():
        warnings.simplefilter("error", DegradedDesignWarning)
        run = build_batched_runner(
            port(spec_ref), ParallelismConfig("temporal", s=8),
            devices=POOL[:4],
        )
    assert (run.path, run.n_devices, run.degraded) == ("single_pe", 1, False)
    assert run.devices_requested == 8


def test_autotune_reports_pool_refusals():
    """Periodic rows not divisible by the spatial degree: the k=4
    candidates are infeasible on a pool of 4 and reported as SASA302
    diagnostics; the ranking itself is unchanged."""
    spec = port(ref_spec("jacobi2d", (30, 8), 2, RefBoundary("periodic")))
    plat = H100_SXM.with_gpus(4)
    td = autotune(spec, platform=plat, devices=POOL[:4], build=False)
    assert any(d.code == "SASA302" for d in td.diagnostics)
    assert all(d.severity == "info" for d in td.diagnostics)
    want = model.choose_best(spec, plat, iterations=2)
    assert [p.config for p in td.ranking] == [p.config for p in want]


def test_cache_and_server_on_a_pool():
    """The server passes its pool to the cache: the design is ranked for
    four devices.  On the H100 row the tile kernel wins and serves on the
    pool's first device; on a platform where the ranker puts a shard
    design first (eager operators free, tile-kernel updates slow) it
    serves through the shard runner, each result bitwise the standalone
    runner's and within tolerance of the oracle."""
    spec_ref = ref_spec("jacobi2d", (2048, 256), 16)
    spec = port(spec_ref)
    pool = POOL[:4]
    srv = StencilServer(devices=pool, max_batch=2, cache=DesignCache(),
                        warmup=False)
    reg = srv.register("j", spec)
    assert any(p.config.k == 4 for p in reg.cached.design.ranking)
    assert (reg.cached.runner.path, reg.cached.runner.n_devices) == (
        "single_pe", 1)
    shards_first = dataclasses.replace(
        H100_SXM, eager_op_s=0.0, cell_update_s=1e-9).with_gpus(4)
    srv = StencilServer(devices=pool, max_batch=2, cache=DesignCache(),
                        warmup=False, platform=shards_first)
    reg = srv.register("j", spec)
    run = reg.cached.runner
    assert (run.path, run.n_devices) == ("shard_map", 4)
    xs = [inputs(spec, seed=s) for s in (1, 2, 3)]
    outs = srv.serve([StencilRequest("j", x) for x in xs])
    single = build_batched_runner(
        reg.cached.design.spec, reg.cached.config, devices=pool
    )
    for x, out in zip(xs, outs):
        np.testing.assert_array_equal(
            out, single({n: a[None] for n, a in x.items()})[0])
        assert_close(out, oracle(spec_ref, x, 16), "server pool")


def test_bucketed_periodic_on_a_pool_keeps_the_wide_margin():
    spec_ref = ref_spec("jacobi2d", (240, 60), 4, RefBoundary("periodic"))
    spec = port(spec_ref)
    srv = StencilServer(devices=POOL[:4], max_batch=2, cache=DesignCache(),
                        warmup=False, bucketing=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DegradedDesignWarning)
        reg = srv.register("p", spec)
        x = inputs(spec)
        y = inputs(port(ref_spec("jacobi2d", (200, 50), 4,
                                 RefBoundary("periodic"))))
        outs = srv.serve([StencilRequest("p", x), StencilRequest("p", y)])
    assert reg.cached.wrap_rounds is None
    assert_close(outs[0], oracle(spec_ref, x, 4), "bucketed pool")
    small_ref = ref_spec("jacobi2d", (200, 50), 4, RefBoundary("periodic"))
    assert_close(outs[1], oracle(small_ref, y, 4), "bucketed pool, smaller")
