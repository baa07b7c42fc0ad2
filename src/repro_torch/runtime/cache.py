"""Built-design cache: skip re-ranking and rebuilding runners across calls.

PyTorch port of ``repro.runtime.cache`` without the persistent store.
SASA amortizes one expensive artefact (the FPGA bitstream) across many
invocations.  On the card the artefact is the (ranking, runner) pair,
whose runner holds the built CUDA tile kernel.  ``DesignCache`` memoizes
both levels:

  * the *design* level -- ``(structural fingerprint, shape, platform,
    iterations)`` -> ranked predictions and the chosen
    :class:`ParallelismConfig`;
  * the *runner* level -- ``(structural fingerprint, shape, config,
    device pool, devices used, iterations)`` -> a batched runner
    (:func:`repro_torch.runtime.batching.build_batched_runner`).

Keys split the spec's **structural fingerprint** (everything but the grid
shape) from the shape, so shape-bucketed serving -- one logical kernel
owning a ladder of bucket designs (:class:`BucketedDesign`) -- shares
entries across registrations that differ only in declared grid size.  The
device pool is the caller's (``devices=``, a device may repeat; or
``device=`` alone; or every visible CUDA device), as in the reference:
runner keys hold the pool and the device count a runner actually uses, so
a runner built degraded on a small pool is rebuilt when the pool grows.

The store-backed parts of the reference (``store=``, telemetry read and
written through disk) wait for the persistence slice and raise
:class:`NotImplementedError`.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
from typing import Mapping, Sequence

from repro_torch.core import analysis, dsl
from repro_torch.core.analysis import Diagnostic, require_bucketable
from repro_torch.core.autotune import (
    TunedDesign,
    _platform_for,
    autotune,
    ranking_pool,
)
from repro_torch.core.model import ParallelismConfig
from repro_torch.core.spec import StencilSpec
from repro_torch.kernels.ops import resolve_pool
from repro_torch.runtime.batching import (
    build_batched_runner,
    build_bucket_runner,
    degraded_message,
    devices_used,
    is_degraded,
)
from repro_torch.runtime.bucketing import (
    ShapeBucketer,
    bucket_spec,
    padded_request_shape,
)

def structural_fingerprint(spec: StencilSpec) -> str:
    """Content hash of everything about a spec *except* its grid shape.

    Two specs with equal structural fingerprints describe the same stencil
    on (possibly) different grid sizes and can share bucket designs.  The
    boundary rule is structural: a periodic and a zero-boundary variant of
    the same expression tree are different kernels.
    """
    payload = repr((
        spec.name,
        spec.iterations,
        spec.ndim,
        tuple((k, v[0]) for k, v in spec.inputs.items()),
        spec.stages,
        spec.iterate_input,
        spec.boundary,
        spec.halo_index_inputs,
        spec.wrap_index_inputs,
        spec.wrap_round_depth,
    ))
    return hashlib.sha1(payload.encode()).hexdigest()[:16]


def spec_fingerprint(spec: StencilSpec) -> str:
    """Stable (process-independent) content hash of a full stencil spec."""
    payload = repr((structural_fingerprint(spec), tuple(spec.shape)))
    return hashlib.sha1(payload.encode()).hexdigest()[:16]


def _as_spec(source_or_spec) -> StencilSpec:
    if isinstance(source_or_spec, StencilSpec):
        return source_or_spec
    return dsl.parse(source_or_spec)


def _pool_key(pool) -> tuple[str, ...]:
    return tuple(str(d) for d in pool)


@dataclasses.dataclass
class KeyStats:
    hits: int = 0
    misses: int = 0
    build_time_s: float = 0.0


@dataclasses.dataclass
class CachedDesign:
    """A cache entry: tuned design + batched runner + provenance."""

    design: TunedDesign
    runner: object                 # build_batched_runner result
    fingerprint: str
    key: tuple
    build_time_s: float
    hit: bool                      # whether THIS lookup was served from cache

    @property
    def config(self) -> ParallelismConfig:
        return self.design.config


class DesignCache:
    """In-process memoization of rankings and built runners.

    ``max_designs`` caps the number of *runners* the cache memoizes
    (rankings are cheap and uncapped): every runner hit marks its entry
    most-recently-used, and an insert past the cap evicts the
    least-recently-hit runner (``runner_evictions`` counts them; per-key
    hit/miss stats survive, so an evict-then-rehit shows up as a rebuild
    miss on the same key).  ``autotune_calls`` counts design-space
    enumerations actually run.  ``store=`` (the persistent design store)
    is not ported yet and raises.
    """

    def __init__(self, max_designs: int | None = None, store=None):
        if store is not None:
            raise NotImplementedError(
                "the persistent design store is not ported yet; use an "
                "in-process DesignCache"
            )
        if max_designs is not None and max_designs < 1:
            raise ValueError(
                f"max_designs must be >= 1, got {max_designs}"
            )
        self.max_designs = max_designs
        self.runner_evictions = 0
        self.autotune_calls = 0
        self._designs: dict[tuple, TunedDesign] = {}
        self._runners: "collections.OrderedDict[tuple, tuple[object, float]]" = (
            collections.OrderedDict()
        )
        self._failed: dict[tuple, str] = {}    # infeasible-config memo
        self._stats: dict[tuple, KeyStats] = {}

    # ------------------------------------------------------------------
    # design level (ranking only, no runner build)
    # ------------------------------------------------------------------

    def design(
        self,
        source_or_spec,
        platform=None,
        iterations: int | None = None,
        device=None,
        devices=None,
        clip_to_devices: bool = False,
    ) -> TunedDesign:
        """Cached ``autotune(..., build=False)``: ranked configs for a spec.

        ``platform`` defaults to the data-sheet row of the pool's card (the
        H100 row without a CUDA device) in a pool of its size, as
        :func:`autotune` picks it; an explicit platform is clipped to the
        pool only with ``clip_to_devices`` (a runner will be built).
        """
        spec = _as_spec(source_or_spec)
        pool = ranking_pool(device, devices)
        plat = _platform_for(pool, platform, clip=clip_to_devices)
        key = (
            "design", structural_fingerprint(spec), tuple(spec.shape),
            plat, iterations,
        )
        st = self._stats.setdefault(key, KeyStats())
        if key in self._designs:
            st.hits += 1
            return self._designs[key]
        st.misses += 1
        self.autotune_calls += 1
        t0 = time.perf_counter()
        tuned = autotune(
            spec, platform=plat, iterations=iterations, devices=pool,
            build=False,
        )
        st.build_time_s += time.perf_counter() - t0
        self._designs[key] = tuned
        return tuned

    # ------------------------------------------------------------------
    # runner level (a batched runner for a specific config)
    # ------------------------------------------------------------------

    def runner(
        self,
        spec: StencilSpec,
        cfg: ParallelismConfig,
        iterations: int | None = None,
        device=None,
        devices=None,
        strict: bool = False,
    ):
        """Cached batched runner for ``(spec, cfg, pool, iterations)``.

        The pool is ``devices``, or ``device`` alone, or every visible CUDA
        device (and a :class:`RuntimeError` without CUDA).  The key holds
        the pool and the device count the runner will occupy, so a runner
        built degraded (pool smaller than the config) is rebuilt, not
        reused, when the pool changes.  ``strict`` refuses a degraded
        config before the lookup, so strict and non-strict callers share
        entries.
        """
        pool = resolve_pool(devices, device)
        n_used = devices_used(cfg, len(pool))
        if strict and is_degraded(cfg, len(pool)):
            raise ValueError(degraded_message(cfg, len(pool)))
        key = (
            "runner", structural_fingerprint(spec), tuple(spec.shape), cfg,
            _pool_key(pool), n_used, iterations,
        )
        st = self._stats.setdefault(key, KeyStats())
        if key in self._runners:
            st.hits += 1
            self._runners.move_to_end(key)      # most recently hit
            return self._runners[key][0]
        if key in self._failed:
            # known-infeasible: re-raising from the memo is a cache hit
            st.hits += 1
            raise ValueError(self._failed[key])
        st.misses += 1
        t0 = time.perf_counter()
        try:
            run = build_batched_runner(
                spec, cfg, iterations=iterations, devices=pool
            )
        except ValueError as e:
            self._failed[key] = str(e)
            raise
        dt = time.perf_counter() - t0
        st.build_time_s += dt
        self._runners[key] = (run, dt)
        if self.max_designs is not None:
            while len(self._runners) > self.max_designs:
                self._runners.popitem(last=False)   # least recently hit
                self.runner_evictions += 1
        return run

    # ------------------------------------------------------------------
    # combined entry point (what serving calls)
    # ------------------------------------------------------------------

    def get_or_build(
        self,
        source_or_spec,
        platform=None,
        iterations: int | None = None,
        device=None,
        strict: bool = False,
        devices=None,
    ) -> CachedDesign:
        """Rank (cached) then build (cached) the best feasible design.

        ``CachedDesign.hit`` is True iff both levels were served from the
        cache -- the call did no ranking and built no runner.
        """
        spec = _as_spec(source_or_spec)
        pool = resolve_pool(devices, device)
        fp = spec_fingerprint(spec)
        before_miss = self.misses
        before_build_s = self._total_build_s()
        tuned = self.design(
            spec, platform=platform, iterations=iterations, devices=pool,
            clip_to_devices=True,   # a runner is built: rank what fits
        )
        # feasibility retry loop (the paper's "build next best design"):
        # known-infeasible candidates are skipped without touching the
        # runner level and kept as diagnostics; the runner level memoizes
        # per config, so a config that built once keeps winning.  The
        # runner runs ``tuned.spec``, the IR-lowered trees the model ranked.
        verdicts = analysis.preflight(
            tuned.spec, [p.config for p in tuned.ranking], len(pool),
            iterations=iterations, batched=True,
        )
        diags: list[Diagnostic] = []
        last_err = None
        run = None
        chosen = None
        for pred, verdict in zip(tuned.ranking, verdicts):
            if not verdict.feasible:
                diags.append(verdict.diagnostic("info"))
                last_err = verdict.reason
                continue
            try:
                run = self.runner(
                    tuned.spec, pred.config, iterations=iterations,
                    devices=pool, strict=strict,
                )
                chosen = pred
                break
            except ValueError as e:
                diags.append(Diagnostic(
                    "SASA308", "info",
                    f"candidate {pred.config} refused at build time: {e}",
                ))
                last_err = e
        if run is None:
            raise RuntimeError(f"no feasible configuration: {last_err}")
        # carry the certified bound (SASA500) through from the cached design
        carried = tuple(
            d for d in tuned.diagnostics if d.code == "SASA500"
        )
        design = TunedDesign(
            tuned.spec, chosen, tuned.ranking, run, tuned.lowering,
            carried + tuple(diags),
        )
        return CachedDesign(
            design=design, runner=run, fingerprint=fp,
            key=("combined", fp),
            build_time_s=self._total_build_s() - before_build_s,
            hit=(self.misses == before_miss),
        )

    # ------------------------------------------------------------------
    # bucketed registration (multi-geometry serving)
    # ------------------------------------------------------------------

    def bucketed(
        self,
        source_or_spec,
        bucketer: ShapeBucketer | None = None,
        platform=None,
        iterations: int | None = None,
        device=None,
        strict: bool = False,
        max_buckets: int | None = None,
        devices=None,
    ) -> "BucketedDesign":
        """Register one logical kernel served across many grid shapes.

        The returned :class:`BucketedDesign` lazily owns a ladder of
        bucket designs (one ranked, built, streamed design per bucket
        shape actually requested), all memoized through this cache.
        ``max_buckets`` caps the ladder with an LRU policy.  Every
        boundary mode is accepted; kernels no streamed bucket transform
        can serve exactly (a divisor interval containing zero) are
        refused here (:func:`repro_torch.core.analysis.require_bucketable`).
        With ``strict`` the full static verification suite runs too.
        """
        spec = _as_spec(source_or_spec)
        require_bucketable(spec)  # refuse un-bucketable kernels loudly, now
        if strict:
            analysis.verify_or_raise(spec, iterations=iterations)
        return BucketedDesign(
            cache=self,
            spec=spec,
            bucketer=bucketer if bucketer is not None else ShapeBucketer(),
            platform=platform,
            iterations=iterations,
            devices=resolve_pool(devices, device),
            strict=strict,
            max_buckets=max_buckets,
        )

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    def _total_build_s(self) -> float:
        return sum(s.build_time_s for s in self._stats.values())

    @property
    def hits(self) -> int:
        return sum(s.hits for s in self._stats.values())

    @property
    def misses(self) -> int:
        return sum(s.misses for s in self._stats.values())

    def stats(self) -> Mapping[tuple, KeyStats]:
        return dict(self._stats)

    def __len__(self) -> int:
        return len(self._designs) + len(self._runners)

    def clear(self) -> None:
        """Drop the in-memory memoization."""
        self._designs.clear()
        self._runners.clear()
        self._failed.clear()
        self._stats.clear()
        self.runner_evictions = 0
        self.autotune_calls = 0


# --------------------------------------------------------------------------
# Bucketed registration: one logical kernel, a ladder of bucket designs
# --------------------------------------------------------------------------


@dataclasses.dataclass
class BucketStats:
    """Per-bucket serving counters of one logical registration."""

    hits: int = 0              # runner_for calls served by an existing bucket
    misses: int = 0            # runner_for calls that had to build the bucket
    requests: int = 0          # grids routed to this bucket
    build_time_s: float = 0.0  # rank + build time paid by this registration
    cache_hit: bool = False    # the bucket's design came fully from the cache

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class BucketEntry:
    """One rung of a registration's bucket ladder."""

    bucket: tuple[int, ...]
    runner: object             # build_bucket_runner result (pad+mask wrapper)
    cached: CachedDesign       # the underlying streamed bucket design
    stats: BucketStats

    @property
    def config(self) -> ParallelismConfig:
        return self.cached.design.config


class BucketedDesign:
    """One logical kernel registration owning a ladder of bucket designs.

    ``runner_for(shape)`` maps a grid shape (plus its streamed-halo
    margins) to its bucket via the :class:`ShapeBucketer` policy, ranks
    and builds that bucket's streamed-boundary design on first use (both
    levels memoized in the shared :class:`DesignCache`), and returns the
    :class:`BucketEntry` whose staging runner serves the shape.

    ``max_buckets`` bounds the ladder: every ``runner_for`` marks its
    bucket most-recently-used, and building a bucket past the cap evicts
    the least-recently-hit entry.  An evicted bucket's counters are
    archived and resume when the bucket is rebuilt.
    """

    def __init__(
        self, cache: DesignCache, spec: StencilSpec,
        bucketer: ShapeBucketer, platform=None, iterations=None,
        devices=None, strict: bool = False, max_buckets: int | None = None,
    ):
        if max_buckets is not None and max_buckets < 1:
            raise ValueError(f"max_buckets must be >= 1, got {max_buckets}")
        self.cache = cache
        self.spec = spec
        self.bucketer = bucketer
        self.platform = platform
        self.iterations = iterations
        self.devices = resolve_pool(devices)
        self.strict = strict
        self.max_buckets = max_buckets
        self.structural = structural_fingerprint(spec)
        # insertion/access order = LRU order (oldest first)
        self._entries: "collections.OrderedDict[tuple[int, ...], BucketEntry]" = (
            collections.OrderedDict()
        )
        self._evicted_stats: dict[tuple[int, ...], BucketStats] = {}
        self.evictions: int = 0
        self._wrap_rounds = ...   # undecided until first routing

    @property
    def wrap_rounds(self) -> int | None:
        """The narrow-margin wrap depth this registration serves with.

        Decided once at first routing and pinned for the registration's
        lifetime (margins are baked into bucket routing): ``None`` unless
        the boundary is periodic *and* the pool is one device (the
        between-round re-wrap needs the whole grid resident; shard designs
        keep the wide ``iterations * radius`` margin, as in the reference).
        Then the design-level ranking for the declared shape picks the
        fusion depth ``s`` the bucket designs will run, and the margin is
        ``s * radius``; the round loop re-imposes the wrap between rounds
        from streamed wrap maps.
        """
        if self._wrap_rounds is ...:
            self._wrap_rounds = self._decide_wrap_rounds()
        return self._wrap_rounds

    def _decide_wrap_rounds(self) -> int | None:
        if self.spec.boundary.kind != "periodic" or len(self.devices) > 1:
            return None
        it = (
            self.spec.iterations if self.iterations is None
            else self.iterations
        )
        tuned = self.cache.design(
            self.spec, platform=self.platform, iterations=self.iterations,
            devices=self.devices, clip_to_devices=True,
        )
        return max(min(tuned.ranking[0].config.s, it), 1)

    def bucket_for(self, shape: Sequence[int]) -> tuple[int, ...]:
        """The bucket serving a *request* grid of ``shape``: routing fits
        the grid plus its per-axis halo margins (non-zero only for
        periodic specs, sized by :attr:`wrap_rounds`)."""
        return self.bucketer.bucket_for(
            padded_request_shape(
                self.spec, shape, self.iterations, self.wrap_rounds
            )
        )

    def runner_for(self, shape: Sequence[int], count: int = 1) -> BucketEntry:
        """The bucket entry serving request grids of ``shape`` (built and
        memoized on first use); ``count`` grids are attributed to the
        bucket's counters."""
        return self.entry_for_bucket(self.bucket_for(shape), count=count)

    def entry_for_bucket(
        self, bucket: tuple[int, ...], count: int = 1
    ) -> BucketEntry:
        """The entry for an already-routed bucket shape (what the server's
        flush loop calls after grouping requests per bucket)."""
        bucket = tuple(int(b) for b in bucket)
        entry = self._entries.get(bucket)
        if entry is not None:
            entry.stats.hits += 1
            entry.stats.requests += count
            self._entries.move_to_end(bucket)      # most recently hit
            return entry
        bspec = bucket_spec(self.spec, bucket, self.wrap_rounds)
        t0 = time.perf_counter()
        cached = self.cache.get_or_build(
            bspec, platform=self.platform, iterations=self.iterations,
            devices=self.devices, strict=self.strict,
        )
        wrapped = build_bucket_runner(
            self.spec, bucket, cached.design.config,
            iterations=self.iterations, devices=self.devices,
            inner=cached.runner, wrap_rounds=self.wrap_rounds,
        )
        # a previously evicted bucket resumes its archived counters
        stats = self._evicted_stats.pop(bucket, None) or BucketStats()
        stats.misses += 1
        stats.requests += count
        stats.build_time_s += 0.0 if cached.hit else time.perf_counter() - t0
        stats.cache_hit = cached.hit
        entry = BucketEntry(
            bucket=bucket, runner=wrapped, cached=cached, stats=stats
        )
        self._entries[bucket] = entry
        if self.max_buckets is not None:
            while len(self._entries) > self.max_buckets:
                old_bucket, old = self._entries.popitem(last=False)
                self._evicted_stats[old_bucket] = old.stats
                self.evictions += 1
        return entry

    def run(self, shape, arrays):
        """Convenience: serve one uniform-shape batch through its bucket."""
        return self.runner_for(shape).runner(arrays)

    @property
    def buckets(self) -> dict[tuple[int, ...], BucketEntry]:
        return dict(self._entries)

    @property
    def num_buckets(self) -> int:
        return len(self._entries)

    def stats(self) -> dict[tuple[int, ...], dict]:
        """Per-bucket counters, evicted rungs included (marked evicted)."""
        out = {b: e.stats.as_dict() for b, e in self._entries.items()}
        for b, s in self._evicted_stats.items():
            d = s.as_dict()
            d["evicted"] = True
            out[b] = d
        return out


_DEFAULT_CACHE = DesignCache()


def default_cache() -> DesignCache:
    """The process-wide cache used when callers don't bring their own."""
    return _DEFAULT_CACHE
