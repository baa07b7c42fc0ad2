"""The port's persistent design store against the reference's contracts.

Every case of ``tests/test_store.py`` runs on the CPU (``device="cpu"``,
pools ``[cpu]`` and ``[cpu] * 4``): cross-cache warm start with zero
ranking, quarantine, stale-environment and schema invalidation, pool
revalidation, LRU rebuild, telemetry restore and the lossless two-writer
merge, readonly stores, the CLI, key echo, and a cross-process round trip.
On the CPU the kernels' plain versions compile nothing, so the store
holds rankings only: ``jit_builds == 0`` and no executable entry.

The executable tier (the CUDA kernel's ``nvcc``-built library, tier
``cuda_so``) is held here through a stand-in for ``cuda_build``'s
build / export / install trio: cold writes one entry, warm loads it with
zero builds, a foreign compute capability or pool size is a miss and a
rebuild, a corrupt blob is quarantined and rebuilt.  Where ``cc`` is on
the path, a tiny C library exporting ``sasa_launch`` round-trips through
``install_library`` itself.  Parity with the reference: the counter
merge functions give the reference's output, and a warm-served result
agrees with the reference's server within ``tolerance_for``.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import shutil
import subprocess
import sys
import textwrap
import warnings

import numpy as np
import pytest
import torch

from repro.core import dsl as ref_dsl
from repro.core import numerics as ref_numerics
from repro.kernels import ref as ref_kernels
from repro.runtime import store as ref_store
from repro.serve import StencilRequest as RefStencilRequest
from repro.serve import StencilServer as RefStencilServer

import repro_torch.runtime.cache as cache_mod
import repro_torch.runtime.store as store_mod
from repro_torch.configs import stencils
from repro_torch.core import dsl, model
from repro_torch.core.autotune import autotune
from repro_torch.core.ir import lower
from repro_torch.core.platform import DEFAULT_GPU
from repro_torch.kernels import cuda_build
from repro_torch.runtime import (
    DegradedDesignWarning,
    DesignCache,
    DesignStore,
    environment_tag,
    merge_counters,
    subtract_counters,
)
from repro_torch.runtime.batching import is_degraded
from repro_torch.runtime.cache import structural_fingerprint
from repro_torch.runtime.store import _MAGIC, design_key
from repro_torch.serve import StencilRequest, StencilServer
from repro_torch.store import main as store_cli

CPU = torch.device("cpu")
POOLS = {"pool1": [CPU], "pool4": [CPU] * 4}
RNG = np.random.default_rng(23)


def small_spec(iterations=2, shape=(16, 8)):
    return stencils.jacobi2d(shape=shape, iterations=iterations)


def batch_for(spec, b=2):
    return {
        n: RNG.standard_normal((b,) + tuple(shape)).astype(dt)
        for n, (dt, shape) in spec.inputs.items()
    }


def oracle(spec, arrays, iters):
    """The reference's oracle on the first grid of a batch."""
    rspec = ref_dsl.parse(dsl.format_spec(spec))
    one = {n: np.asarray(a[0]) for n, a in arrays.items()}
    return np.asarray(ref_kernels.stencil_iterations_ref(rspec, one, iters))


def serve_once(cache, spec, arrays, pool=(CPU,), **kw):
    cached = cache.get_or_build(spec, devices=list(pool), **kw)
    return np.asarray(cached.runner(arrays)), cached


def env_dir(root):
    return root / environment_tag()


def executable_files(root):
    return sorted((env_dir(root) / "executables").glob("*.pkl"))


def cpu_key(spec, iterations=None):
    """The design-store key a one-CPU pool ranks under."""
    return design_key(structural_fingerprint(spec), spec.shape,
                      DEFAULT_GPU.with_gpus(1), iterations)


def reframe(path, edit):
    """Decode a framed entry, apply ``edit`` to it, write it back framed."""
    raw = path.read_bytes()
    body = pickle.loads(raw[len(_MAGIC) + 32:])
    edit(body)
    data = pickle.dumps(body, protocol=pickle.HIGHEST_PROTOCOL)
    path.write_bytes(_MAGIC + hashlib.sha256(data).digest() + data)


# --------------------------------------------------------------------------
# warm start within one machine (two caches sharing a directory)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("pool", list(POOLS))
def test_warm_cache_skips_autotune_and_jit(tmp_path, pool):
    spec = small_spec()
    arrays = batch_for(spec)
    devs = POOLS[pool]

    cold = DesignCache(store=str(tmp_path / "store"))
    out_cold, _ = serve_once(cold, spec, arrays, devs)
    assert cold.autotune_calls == 1
    assert cold.jit_builds == 0            # plain versions compile nothing
    assert cold.store.stats.writes >= 1    # the ranking
    assert executable_files(tmp_path / "store") == []

    warm = DesignCache(store=str(tmp_path / "store"))
    out_warm, _ = serve_once(warm, spec, arrays, devs)
    assert warm.autotune_calls == 0, "warm start re-ranked the design space"
    assert warm.jit_builds == 0
    assert warm.store_hits >= 1
    assert warm.store.stats.design_hits >= 1
    assert warm.store.stats.executable_hits == 0
    np.testing.assert_array_equal(out_cold, out_warm)
    np.testing.assert_allclose(
        out_warm[0], oracle(spec, arrays, spec.iterations),
        rtol=2e-4, atol=2e-4,
    )


def test_autotune_store_entry_point(tmp_path):
    spec = small_spec()
    x = {"in_1": RNG.standard_normal(spec.shape).astype(np.float32)}
    d1 = autotune(spec, device="cpu", store=str(tmp_path / "s"))
    want = d1.runner(x)

    cache = DesignCache(store=str(tmp_path / "s"))
    d2 = autotune(spec, device="cpu", cache=cache)
    assert cache.autotune_calls == 0           # ranking came from disk
    np.testing.assert_allclose(d2.runner(x), want, rtol=2e-4, atol=2e-4)

    other = DesignCache(store=str(tmp_path / "other"))
    with pytest.raises(ValueError, match="conflicts"):
        autotune(spec, device="cpu", cache=other, store=str(tmp_path / "s"))


def test_recalibrated_platform_misses_old_rankings(tmp_path):
    """The design key holds the whole GPUPlatform: a ranker recalibration
    (here ``cell_update_s``) misses old rankings instead of serving them."""
    import dataclasses

    spec = small_spec()
    root = str(tmp_path / "store")
    DesignCache(store=root).design(spec, device="cpu")
    warm = DesignCache(store=root)
    warm.design(spec, device="cpu")
    assert warm.autotune_calls == 0
    plat = dataclasses.replace(DEFAULT_GPU.with_gpus(1), cell_update_s=2e-12)
    recal = DesignCache(store=root)
    recal.design(spec, platform=plat, device="cpu")
    assert recal.autotune_calls == 1
    assert recal.store.stats.design_hits == 0


# --------------------------------------------------------------------------
# corruption -> quarantine, never a crash
# --------------------------------------------------------------------------


def test_corrupt_entries_quarantined_not_fatal(tmp_path):
    spec = small_spec()
    arrays = batch_for(spec)
    root = tmp_path / "store"
    cold = DesignCache(store=str(root))
    out_cold, _ = serve_once(cold, spec, arrays)

    env = env_dir(root)
    victims = sorted((env / "designs").glob("*.pkl")) + sorted(
        (env / "telemetry").glob("*.pkl")
    )
    assert len(victims) >= 2, "cold pass wrote no entries"
    victims[0].write_bytes(b"garbage that is not a framed entry")
    victims[-1].write_bytes(victims[-1].read_bytes()[:20])   # truncated

    warm = DesignCache(store=str(root))
    out_warm, _ = serve_once(warm, spec, arrays)   # rebuilds what it must
    np.testing.assert_array_equal(out_cold, out_warm)
    assert warm.store.stats.quarantined >= 2
    q = env / "quarantine"
    assert q.is_dir() and any(q.iterdir()), "bad entries not moved aside"
    # the rebuild wrote fresh replacements: a third cache is fully warm
    third = DesignCache(store=str(root))
    serve_once(third, spec, arrays)
    assert third.autotune_calls == 0 and third.jit_builds == 0


# --------------------------------------------------------------------------
# version/environment invalidation
# --------------------------------------------------------------------------


def test_environment_tag_is_the_installation():
    tag = environment_tag()
    assert tag == (f"schema{store_mod.SCHEMA_VERSION}-torch{torch.__version__}"
                   f"-cuda{torch.version.cuda or 'none'}")


def test_stale_environment_is_invisible_and_prunable(tmp_path):
    spec = small_spec()
    root = tmp_path / "store"
    stale_tag = "schema0-torch0.0.1-cudanone"
    stale = DesignStore(root, env_tag=stale_tag)
    key = cpu_key(spec)
    stale.put_design(key, spec, [])

    cur = DesignStore(root)
    assert cur.get_design(key) is None         # different env dir: a miss
    assert cur.stats.design_misses == 1
    assert set(cur.environments()) == {stale_tag, cur.env_tag}

    removed = cur.prune()
    assert stale_tag in removed
    assert cur.environments() == [cur.env_tag]
    manifest = json.loads((root / "manifest.json").read_text())
    assert manifest["environments"] == [cur.env_tag]


def test_schema_bump_invalidates(tmp_path, monkeypatch):
    spec = small_spec()
    root = tmp_path / "store"
    cache = DesignCache(store=str(root))
    cache.design(spec, device="cpu")
    assert cache.store.stats.writes >= 1

    monkeypatch.setattr(store_mod, "SCHEMA_VERSION", 2)
    bumped = DesignCache(store=str(root))
    assert bumped.store.env_tag.startswith("schema2-")
    bumped.design(spec, device="cpu")           # miss: re-ranks cleanly
    assert bumped.autotune_calls == 1
    assert bumped.store.stats.design_hits == 0


# --------------------------------------------------------------------------
# warm ranking whose top pick does not fit the current pool
# --------------------------------------------------------------------------


def test_warm_ranking_revalidates_against_current_pool(tmp_path):
    """A persisted ranking may lead with a config ranked for a bigger
    pool.  The warm replica re-validates against ITS pool: by default it
    serves the top pick degraded, loudly (``DegradedDesignWarning``), and
    under ``strict=True`` it falls back to the ranking's next truly
    fitting candidate with a diagnostic.  Either way: no crash, no
    silent mismatch, no re-rank."""
    spec = small_spec()
    arrays = batch_for(spec)
    root = tmp_path / "store"
    lowered = lower(spec).spec

    big = model.choose_best(lowered, DEFAULT_GPU.with_gpus(4))
    multi = next(p for p in big if is_degraded(p.config, 1))
    fit = [
        p for p in model.choose_best(lowered, DEFAULT_GPU.with_gpus(1))
        if p.config.devices_needed <= 1
    ]
    assert fit, "no single-device candidate to fall back to"
    DesignStore(root).put_design(cpu_key(spec), lowered, [multi] + fit)

    warm = DesignCache(store=str(root))
    with pytest.warns(DegradedDesignWarning):
        out, cached = serve_once(warm, spec, arrays)
    assert warm.autotune_calls == 0             # ranking still came warm
    assert cached.design.config == multi.config  # degraded, not hidden
    np.testing.assert_allclose(
        out[0], oracle(spec, arrays, spec.iterations), rtol=2e-4, atol=2e-4,
    )

    strict = DesignCache(store=str(root))
    cached2 = strict.get_or_build(spec, device="cpu", strict=True)
    assert strict.autotune_calls == 0
    assert cached2.design.config.devices_needed <= 1
    assert any(d.code == "SASA308" for d in cached2.design.diagnostics), (
        "strict fallback left no diagnostic"
    )
    out2 = np.asarray(cached2.runner(arrays))
    np.testing.assert_allclose(
        out2[0], oracle(spec, arrays, spec.iterations), rtol=2e-4, atol=2e-4,
    )


# --------------------------------------------------------------------------
# LRU eviction rebuilds from the store, not from scratch
# --------------------------------------------------------------------------


def test_lru_evicted_runner_rebuilds_from_store(tmp_path):
    a = small_spec(iterations=2, shape=(16, 8))
    b = stencils.blur(shape=(16, 8), iterations=2)
    xa, xb = batch_for(a), batch_for(b)

    cache = DesignCache(max_designs=1, store=str(tmp_path / "store"))
    out_a, _ = serve_once(cache, a, xa)
    serve_once(cache, b, xb)                    # evicts a's runner
    assert cache.runner_evictions >= 1
    calls = cache.autotune_calls
    out_a2, _ = serve_once(cache, a, xa)        # rebuild, no re-rank
    assert cache.autotune_calls == calls
    assert cache.jit_builds == 0
    np.testing.assert_array_equal(out_a, out_a2)


# --------------------------------------------------------------------------
# telemetry persistence
# --------------------------------------------------------------------------


def test_telemetry_restored_across_restarts(tmp_path):
    spec = small_spec()
    root = str(tmp_path / "store")
    c1 = DesignCache(store=root)
    c1.design(spec, device="cpu")
    c1.design(spec, device="cpu")               # 1 miss + 1 memory hit
    c1.flush_telemetry()

    c2 = DesignCache(store=root)
    restored = c2.stats()
    assert restored, "restart lost the per-key telemetry"
    (key, st), = [(k, s) for k, s in restored.items() if k[0] == "design"]
    assert st.misses == 1 and st.hits == 1
    assert st.build_time_s > 0
    # the restored counters keep accumulating, not restart from zero
    c2.design(spec, device="cpu")
    assert c2.stats()[key].store_hits == 1


def test_two_writer_telemetry_merge_is_lossless(tmp_path):
    """Two caches sharing a store must not drop each other's counters."""
    spec = small_spec()
    root = str(tmp_path / "store")
    a = DesignCache(store=root)
    a.design(spec, device="cpu")                # A: ranking miss, persisted
    b = DesignCache(store=root)
    b.design(spec, device="cpu")                # B: warm store hit, persisted
    assert b.store_hits == 1

    c = DesignCache(store=root)                 # fresh reader merges both
    (key, st), = [(k, s) for k, s in c.stats().items() if k[0] == "design"]
    assert st.misses == 1, "writer B's flush dropped writer A's miss count"
    assert st.store_hits == 1, "writer A's history clobbered writer B's hit"
    assert st.build_time_s > 0


def test_store_level_counter_merge_policy(tmp_path):
    """get_telemetry merges writers field-wise: sums, max-of-maxes, OR'd
    booleans, and means recomputed from the merged sums (zero-guarded)."""
    root = tmp_path / "store"
    w1, w2 = DesignStore(root), DesignStore(root)
    w1.put_telemetry(
        {"k": {"hits": 2, "exec_total_s": 1.0, "exec_count": 2,
               "exec_max_s": 0.8, "exec_mean_s": 0.5}},
        {("s", (8, 8)): {"requests": 3, "cache_hit": False}},
    )
    w2.put_telemetry(
        {"k": {"hits": 5, "exec_total_s": 3.0, "exec_count": 6,
               "exec_max_s": 0.6, "exec_mean_s": 0.5}},
        {("s", (8, 8)): {"requests": 4, "cache_hit": True}},
    )
    tel = DesignStore(root).get_telemetry()
    k = tel["keys"]["k"]
    assert k["hits"] == 7 and k["exec_count"] == 8
    assert k["exec_total_s"] == pytest.approx(4.0)
    assert k["exec_max_s"] == pytest.approx(0.8)        # max, not sum
    assert k["exec_mean_s"] == pytest.approx(0.5)       # 4.0 / 8, recomputed
    bk = tel["buckets"][("s", (8, 8))]
    assert bk["requests"] == 7 and bk["cache_hit"] is True

    # zero-execution merge stays finite (the counter-edge guard)
    w1.put_telemetry(
        {"z": {"exec_total_s": 0.0, "exec_count": 0, "exec_mean_s": 0.0}}, {})
    w2.put_telemetry(
        {"z": {"exec_total_s": 0.0, "exec_count": 0, "exec_mean_s": 0.0}}, {})
    z = DesignStore(root).get_telemetry()["keys"]["z"]
    assert z["exec_mean_s"] == 0.0


COUNTER_CASES = [
    ({"hits": 2, "exec_total_s": 1.0, "exec_count": 2, "exec_max_s": 0.8,
      "exec_mean_s": 0.5, "name": "a"},
     {"hits": 5, "exec_total_s": 3.0, "exec_count": 6, "exec_max_s": 0.6,
      "exec_mean_s": 0.5, "name": "b", "extra": 4}),
    ({"requests": 3, "cache_hit": False, "build_time_s": 0.25},
     {"requests": 4, "cache_hit": True, "build_time_s": 0.5}),
    ({"exec_total_s": 0.0, "exec_count": 0, "exec_mean_s": 0.0},
     {"exec_total_s": 0.0, "exec_count": 0, "exec_mean_s": 0.0}),
    ({"hits": 1, "misses": 7, "store_hits": 0},
     {"hits": 3, "misses": 2, "store_hits": 5}),
]


@pytest.mark.parametrize("a, b", COUNTER_CASES)
def test_counter_functions_match_the_reference(a, b):
    assert merge_counters(a, b) == ref_store.merge_counters(a, b)
    assert merge_counters(b, a) == ref_store.merge_counters(b, a)
    assert subtract_counters(a, b) == ref_store.subtract_counters(a, b)
    assert subtract_counters(b, a) == ref_store.subtract_counters(b, a)


def test_bucket_stats_restored_across_restarts(tmp_path):
    spec = small_spec(iterations=2, shape=(20, 12))
    root = str(tmp_path / "store")
    c1 = DesignCache(store=root)
    bd1 = c1.bucketed(spec, device="cpu")
    bd1.runner_for((20, 12), count=3)
    bucket, = bd1.buckets

    c2 = DesignCache(store=root)
    bd2 = c2.bucketed(spec, device="cpu")
    st = bd2.stats()
    assert bucket in st, "restart lost the per-bucket telemetry"
    assert st[bucket]["requests"] == 3
    bd2.runner_for((20, 12), count=2)           # resumes archived counters
    assert bd2.stats()[bucket]["requests"] == 5


# --------------------------------------------------------------------------
# readonly stores
# --------------------------------------------------------------------------


def test_readonly_store_never_writes(tmp_path):
    spec = small_spec()
    root = tmp_path / "store"
    DesignCache(store=str(root)).design(spec, device="cpu")   # populate

    ro = DesignStore(root, readonly=True)
    assert ro.get_design(cpu_key(spec)) is not None
    before = sorted(p.name for p in root.rglob("*"))
    ro.put_design("other-key", spec, [])
    ro.put_telemetry({"k": {"hits": 1}}, {})
    ro.put_executable("other-key", "sig", store_mod.AOT_KIND, b"blob")
    assert sorted(p.name for p in root.rglob("*")) == before
    assert ro.stats.writes == 0


# --------------------------------------------------------------------------
# the executable tier, through a stand-in for the build/export/install trio
# --------------------------------------------------------------------------


class FakeKernels:
    """Stands in for ``cuda_build``'s build / export / install trio on the
    CPU: a "library" is the bytes ``LIB:<kernel key>``, loading is an
    entry in ``cuda_build._LOADED``, and kernel runners on the CPU count
    as tile-kernel runners.  ``restart()`` forgets what this process
    loaded, as a fresh process would."""

    def __init__(self, monkeypatch):
        self.loaded: dict = {}
        self.installs = 0

        def build_many(specs):
            for spec in specs:
                key = cuda_build.kernel_key(spec)
                if key not in self.loaded:
                    self.loaded[key] = key
                    build_many.compiles += 1

        build_many.compiles = 0
        monkeypatch.setattr(cuda_build, "_LOADED", self.loaded)
        monkeypatch.setattr(cuda_build, "build_many", build_many)
        monkeypatch.setattr(cuda_build, "export_library", self.export)
        monkeypatch.setattr(cuda_build, "install_library", self.install)
        monkeypatch.setattr(
            cache_mod, "_runs_tile_kernel",
            lambda run: run.path in ("single_pe", "tile_pipeline"),
        )

    def export(self, spec):
        key = cuda_build.kernel_key(spec)
        assert key in self.loaded, "exported a library that was never built"
        return key, b"LIB:" + key.encode()

    def install(self, key, blob):
        if blob != b"LIB:" + key.encode():
            raise OSError("the dynamic loader refused the blob")
        self.installs += 1
        self.loaded[key] = key
        return key

    def restart(self):
        self.loaded.clear()


@pytest.fixture
def fake_kernels(monkeypatch):
    return FakeKernels(monkeypatch)


def test_executable_tier_cold_then_warm(tmp_path, fake_kernels):
    spec = small_spec()
    arrays = batch_for(spec)
    root = tmp_path / "store"

    cold = DesignCache(store=str(root))
    out_cold, _ = serve_once(cold, spec, arrays)
    assert cold.autotune_calls == 1 and cold.jit_builds == 1
    assert len(executable_files(root)) == 1     # one runner, one entry

    fake_kernels.restart()                      # a fresh process
    warm = DesignCache(store=str(root))
    out_warm, _ = serve_once(warm, spec, arrays)
    assert warm.autotune_calls == 0 and warm.jit_builds == 0
    assert warm.store.stats.executable_hits == 1
    assert fake_kernels.installs == 1
    np.testing.assert_array_equal(out_cold, out_warm)

    # a library this process already holds: no store read, no build, and
    # a runner whose entry is missing gets it written through
    again = DesignCache(store=str(root))
    serve_once(again, spec, arrays)
    assert again.jit_builds == 0 and again.store.stats.executable_hits == 0


def test_executable_tier_lru_rebuild_loads_nothing_twice(tmp_path,
                                                         fake_kernels):
    a = small_spec(iterations=2, shape=(16, 8))
    b = stencils.blur(shape=(16, 8), iterations=2)
    cache = DesignCache(max_designs=1, store=str(tmp_path / "store"))
    serve_once(cache, a, batch_for(a))
    serve_once(cache, b, batch_for(b))           # evicts a's runner
    builds = cache.jit_builds
    assert builds == 2
    xa = batch_for(a)
    out_a2, _ = serve_once(cache, a, xa)
    assert cache.jit_builds == builds, "evicted runner re-compiled"
    fake_kernels.restart()
    fresh = DesignCache(store=str(tmp_path / "store"))
    np.testing.assert_array_equal(serve_once(fresh, a, xa)[0], out_a2)
    assert fresh.jit_builds == 0 and fresh.store.stats.executable_hits == 1


@pytest.mark.parametrize("field, value", [
    ("capability", (8, 0)),                     # another card generation
    ("cuda", "11.0"),                           # another CUDA build
    ("pool_size", 4096),                        # some other machine's pool
])
def test_executable_entry_rejects_foreign_meta(tmp_path, fake_kernels,
                                               field, value):
    """An executable recorded for another compute capability, CUDA version
    or pool size is a miss and a rebuild, never a crash."""
    spec = small_spec()
    arrays = batch_for(spec)
    root = tmp_path / "store"
    out_cold, _ = serve_once(DesignCache(store=str(root)), spec, arrays)

    path, = executable_files(root)
    reframe(path, lambda body: body["meta"].__setitem__(field, value))

    fake_kernels.restart()
    warm = DesignCache(store=str(root))
    out_warm, _ = serve_once(warm, spec, arrays)
    assert warm.store.stats.executable_misses >= 1
    assert warm.jit_builds == 1                 # rebuilt, did not load
    assert fake_kernels.installs == 0
    np.testing.assert_array_equal(out_cold, out_warm)
    # the rebuild wrote a matching entry over the foreign one
    fake_kernels.restart()
    third = DesignCache(store=str(root))
    serve_once(third, spec, arrays)
    assert third.jit_builds == 0 and third.store.stats.executable_hits == 1


@pytest.mark.parametrize("damage", ["blob", "frame"])
def test_corrupt_executable_quarantined_and_rebuilt(tmp_path, fake_kernels,
                                                    damage):
    """A blob the loader refuses (its frame intact) and a torn frame are
    both quarantined; the replica rebuilds and writes a fresh entry."""
    spec = small_spec()
    arrays = batch_for(spec)
    root = tmp_path / "store"
    out_cold, _ = serve_once(DesignCache(store=str(root)), spec, arrays)

    path, = executable_files(root)
    if damage == "blob":
        reframe(path, lambda body: body.__setitem__("blob", b"\x7fELF torn"))
    else:
        path.write_bytes(path.read_bytes()[:40])

    fake_kernels.restart()
    warm = DesignCache(store=str(root))
    out_warm, _ = serve_once(warm, spec, arrays)
    assert warm.store.stats.quarantined == 1
    assert warm.store.stats.executable_misses == 1
    assert warm.jit_builds == 1
    np.testing.assert_array_equal(out_cold, out_warm)
    assert any((env_dir(root) / "quarantine").iterdir())
    fake_kernels.restart()
    third = DesignCache(store=str(root))
    serve_once(third, spec, arrays)
    assert third.jit_builds == 0 and third.store.stats.executable_hits == 1


def test_bucket_runner_persists_the_bucket_spec_library(tmp_path,
                                                        fake_kernels):
    """A bucket design launches the streamed bucket spec (with its halo
    maps): the entry carries that spec's kernel key."""
    spec = dsl.parse(dsl.format_spec(small_spec(shape=(20, 12))).replace(
        "iteration:", "boundary: replicate\niteration:"))
    root = tmp_path / "store"
    cache = DesignCache(store=str(root))
    bd = cache.bucketed(spec, device="cpu")
    entry = bd.runner_for((20, 12))
    entry.runner({"in_1": RNG.standard_normal((1, 20, 12)).astype(np.float32)})
    launched = entry.cached.design.spec
    assert launched.halo_index_inputs, "the bucket spec streams halo maps"
    path, = executable_files(root)
    body = pickle.loads(path.read_bytes()[len(_MAGIC) + 32:])
    assert body["signature"] == cuda_build.kernel_key(launched)
    assert body["kind"] == "cuda_so" and body["meta"]["pool_size"] == 1


def test_install_library_round_trips_a_real_library(tmp_path, monkeypatch):
    """A shared library exporting ``sasa_launch``, built with ``cc``, is
    installed into the build root and loaded; a blob the loader refuses
    raises OSError and leaves no file behind."""
    if shutil.which("cc") is None:
        pytest.skip("needs a C compiler to build a stand-in library")
    src = tmp_path / "lib.c"
    src.write_text(textwrap.dedent("""
        #include <stdint.h>
        int sasa_launch(uint64_t* ins, uint64_t* maps, void* out,
                        int* geom, void* stream) {
            return geom[0] + 2 * geom[1];
        }
    """))
    so = tmp_path / "lib.so"
    subprocess.run(["cc", "-shared", "-fPIC", "-o", str(so), str(src)],
                   check=True)
    monkeypatch.setattr(cuda_build, "BUILD_ROOT", tmp_path / "kernels")
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    lib = cuda_build.install_library("k" * 24, so.read_bytes())
    assert cuda_build.is_loaded("k" * 24)
    assert lib.path == tmp_path / "kernels" / ("k" * 24) / "libsasa.so"
    assert lib.launch([1], [], 0, [5, 7], 0) == 19
    assert cuda_build.install_library("k" * 24, b"ignored") is lib

    with pytest.raises(OSError):
        cuda_build.install_library("b" * 24, b"\x7fELF not a library")
    assert not (tmp_path / "kernels" / ("b" * 24) / "libsasa.so").exists()
    assert not cuda_build.is_loaded("b" * 24)


# --------------------------------------------------------------------------
# the `python -m repro_torch.store` CLI
# --------------------------------------------------------------------------


def test_store_cli_list_verify_prune(tmp_path, capsys, fake_kernels):
    spec = small_spec()
    root = tmp_path / "store"
    cache = DesignCache(store=str(root))
    serve_once(cache, spec, batch_for(spec))

    assert store_cli(["list", str(root)]) == 0
    out = capsys.readouterr().out
    assert "design" in out and "executable" in out and "ok" in out
    assert "kind=cuda_so" in out and f"torch={torch.__version__}" in out

    assert store_cli(["verify", str(root)]) == 0

    victim = next((env_dir(root) / "designs").glob("*.pkl"))
    victim.write_bytes(b"\x00corrupt")
    assert store_cli(["verify", str(root)]) == 1   # quarantines + reports
    out = capsys.readouterr().out
    assert "1 newly quarantined" in out
    assert store_cli(["verify", str(root)]) == 0   # now clean again
    out = capsys.readouterr().out
    assert "1 in quarantine backlog" in out
    assert store_cli(["verify", str(root), "--strict"]) == 1
    out = capsys.readouterr().out
    assert "backlog" in out

    stale = "schema0-torch0.0.1-cudanone"
    (root / stale / "designs").mkdir(parents=True)
    assert store_cli(["prune", str(root)]) == 0
    out = capsys.readouterr().out
    assert stale in out
    assert not (root / stale).exists()
    assert store_cli(["verify", str(root), "--strict"]) == 0


# --------------------------------------------------------------------------
# framed-entry integrity details
# --------------------------------------------------------------------------


def test_key_echo_rejects_wrong_entry(tmp_path):
    """A hand-copied or digest-colliding file serving the wrong design
    reads as a miss (key echo check), not as the wrong ranking."""
    spec = small_spec()
    st = DesignStore(tmp_path / "store")
    st.put_design("a-key", spec, [])
    path = st._design_path("a-key")
    st._design_path("another-key").write_bytes(path.read_bytes())
    assert st.get_design("another-key") is None
    assert st.get_design("a-key") is not None

    st.put_executable("r-key", "sig", store_mod.AOT_KIND, b"x")
    st._executable_path("r-key", "other-sig").write_bytes(
        st._executable_path("r-key", "sig").read_bytes())
    assert st.get_executable("r-key", "other-sig") is None


# --------------------------------------------------------------------------
# the server over a store, and parity with the reference's server
# --------------------------------------------------------------------------


def test_server_store_dir_and_telemetry(tmp_path):
    spec = small_spec()
    root = str(tmp_path / "store")
    with pytest.raises(ValueError, match="not both"):
        StencilServer(device="cpu", cache=DesignCache(), store_dir=root)
    srv = StencilServer(device="cpu", max_batch=2, store_dir=root)
    srv.register("jac", spec)
    req = StencilRequest("jac", {"in_1": batch_for(spec, 1)["in_1"][0]})
    out = srv.serve([req])[0]
    st = srv.stats()
    assert st["_cache"]["autotune_calls"] == 1
    assert st["_cache"]["jit_builds"] == 0
    assert st["_cache"]["store_hits"] == 0
    assert st["_store"]["writes"] >= 2          # ranking + telemetry

    warm = StencilServer(device="cpu", max_batch=2, store_dir=root)
    warm.register("jac", spec)
    np.testing.assert_array_equal(warm.serve([req])[0], out)
    wst = warm.stats()
    assert wst["_cache"]["autotune_calls"] == 0
    assert wst["_cache"]["store_hits"] >= 1
    assert wst["_store"]["design_hits"] >= 1
    # flush persisted the first server's counters: a reader sees them
    tel = DesignStore(root).get_telemetry()
    runner_keys = [k for k in tel["keys"] if k[0] == "runner"]
    assert runner_keys and sum(tel["keys"][k]["misses"]
                               for k in runner_keys) == 2


def test_warm_served_result_matches_the_reference_server(tmp_path):
    """A result served warm from the store agrees with the reference's
    server on the same inputs within the certified tolerance."""
    text = dsl.format_spec(small_spec(iterations=3, shape=(24, 16)))
    rng = np.random.default_rng(5)
    grids = [rng.standard_normal((24, 16)).astype(np.float32)
             for _ in range(3)]
    root = str(tmp_path / "store")
    StencilServer(device="cpu", max_batch=2, store_dir=root).register(
        "jac", text)
    warm = StencilServer(device="cpu", max_batch=2, store_dir=root)
    warm.register("jac", text)
    assert warm.stats()["_cache"]["autotune_calls"] == 0
    outs = warm.serve([StencilRequest("jac", {"in_1": g}) for g in grids])

    ref = RefStencilServer(max_batch=2)
    ref.register("jac", text)
    want = ref.serve([RefStencilRequest("jac", {"in_1": g}) for g in grids])
    for g, got, w in zip(grids, outs, want):
        bound = ref_numerics.tolerance_for(ref_dsl.parse(text), 3,
                                           {"in_1": g})
        assert float(np.abs(got - np.asarray(w)).max()) <= bound


# --------------------------------------------------------------------------
# the real thing: two fresh processes sharing one store directory
# --------------------------------------------------------------------------

CHILD_SRC = textwrap.dedent("""
    import json, sys
    import numpy as np
    from repro_torch.configs import stencils
    from repro_torch.runtime import DesignCache

    store_root, out_npy, report = sys.argv[1:4]
    spec = stencils.jacobi2d(shape=(16, 8), iterations=2)
    rng = np.random.default_rng(23)
    arrays = {
        n: rng.standard_normal((2,) + tuple(shape)).astype(dt)
        for n, (dt, shape) in spec.inputs.items()
    }
    cache = DesignCache(store=store_root)
    out = np.asarray(cache.get_or_build(spec, device="cpu").runner(arrays))
    cache.flush_telemetry()
    np.save(out_npy, out)
    json.dump({
        "autotune_calls": cache.autotune_calls,
        "jit_builds": cache.jit_builds,
        "store_hits": cache.store_hits,
    }, open(report, "w"))
""")


@pytest.mark.slow
def test_cross_process_round_trip(tmp_path):
    child = tmp_path / "store_child_main.py"
    child.write_text(CHILD_SRC)
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.path.join(repo, "src")

    def spawn(tag):
        out_npy = tmp_path / f"{tag}.npy"
        report = tmp_path / f"{tag}.json"
        subprocess.run(
            [sys.executable, str(child), str(tmp_path / "store"),
             str(out_npy), str(report)],
            check=True, env=env, timeout=300,
        )
        return np.load(out_npy), json.loads(report.read_text())

    out_cold, rep_cold = spawn("cold")
    out_warm, rep_warm = spawn("warm")
    assert rep_cold["autotune_calls"] == 1 and rep_cold["jit_builds"] == 0
    assert rep_warm["autotune_calls"] == 0, "warm process re-ranked"
    assert rep_warm["jit_builds"] == 0
    assert rep_warm["store_hits"] >= 1
    np.testing.assert_array_equal(out_cold, out_warm)


def test_no_warnings_leak_from_a_warm_cpu_start(tmp_path):
    """A warm start on one CPU raises no degraded-design warning: the
    ranking it restores was made for its own pool."""
    spec = small_spec()
    root = str(tmp_path / "store")
    serve_once(DesignCache(store=root), spec, batch_for(spec))
    with warnings.catch_warnings():
        warnings.simplefilter("error", DegradedDesignWarning)
        serve_once(DesignCache(store=root), spec, batch_for(spec))
