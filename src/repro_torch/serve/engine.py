"""Stencil serving engine: micro-batched, bucketed, async-dispatched
execution of cached designs on one device.

PyTorch port of ``repro.serve.engine`` without the LM engine re-exports.  A server owns a
:class:`repro_torch.runtime.DesignCache`; clients register stencil
designs (DSL text or :class:`StencilSpec`) and then submit grids:

  register(name, dsl)  -- ranking (cached) -- batched runner built
                          (cached) -- optional warmup dispatch
  submit(name, arrays) -- validated, queued (thread-safe)
  flush()              -- queued requests grouped by design (and, with
                          bucketing, by bucket shape), chunked into
                          micro-batches of ``max_batch`` grids, staged to
                          the device, dispatched through a bounded
                          in-flight queue, unpadded

**Shape bucketing** (``bucketing=True`` or a
:class:`repro_torch.runtime.ShapeBucketer`): a registered design is a
*logical* kernel that serves any grid shape its bucketer accepts, under
any boundary mode.  Each request is routed to a padded canonical bucket;
one streamed-boundary design per bucket is ranked and built on first use
(memoized in the shared cache), and grids of different sizes sharing a
bucket ride the same micro-batch, each carrying its own streamed service
inputs: the exterior mask, replicate halo-index maps (consumed in the
tile kernel after every stage), or periodic wrap margins and wrap maps
(consumed by the round loop between rounds).  Without bucketing, requests
must match the registered spec's exact shape.

**Async double-buffered dispatch** (``async_dispatch=True``, the
default): each micro-batch is staged (host stack/pad, pinned copy to the
card) and dispatched without blocking; the host stages micro-batch N+1
while the card runs micro-batch N, and only blocks (the runner's
``finalize``, which waits on the CUDA event recorded after the batch)
when the in-flight queue (``max_inflight``) is full or the flush drains.
``async_dispatch=False`` dispatches synchronously; results are bitwise
identical either way.

**Batch-axis semantics** (shared with :mod:`repro_torch.runtime.batching`):
one dispatch evaluates ``(B,) + bucket_shape`` arrays whose B grids are
independent, and the spec's boundary rule applies per grid (per *real*
grid under bucketing, through the streamed inputs).  Requests for
different designs never share a batch.  Short final chunks are padded up
to ``max_batch`` (so a design runs one batch shape) and the padding's
outputs are discarded.

Per-design counters (``stats()``): requests served, batches dispatched,
design-cache hit/miss for the register call, build/warmup seconds,
execution latency (count / total / mean / max seconds; staging to
completion), requests lost to dispatch faults (whose tickets resolve via
``failures``), and, for bucketed designs, per-bucket counters.

The device pool is ``devices`` (a device may repeat), or ``device``
alone, or every visible CUDA device, and it raises without CUDA (pass
``device="cpu"`` to serve through the kernels' plain versions).  The pool
goes to the design cache, as in the reference: designs are ranked for it,
and a multi-device design serves through the shard runner.

The LM token-serving engine lives in :mod:`repro_torch.serve.lm`; its
classes are re-exported here, as the reference's engine module does.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Mapping

import numpy as np

from repro_torch.core import analysis, numerics
from repro_torch.kernels.ops import resolve_pool
from repro_torch.serve.lm import Request, ServeEngine  # noqa: F401
from repro_torch.runtime.bucketing import ShapeBucketer
from repro_torch.runtime.cache import (
    BucketedDesign,
    DesignCache,
    _as_spec,
    default_cache,
    spec_fingerprint,
    structural_fingerprint,
)


@dataclasses.dataclass
class StencilRequest:
    """One grid to evaluate under a registered design."""

    design: str
    arrays: Mapping[str, np.ndarray]   # each shaped like one grid


@dataclasses.dataclass
class DesignCounters:
    cache_hit: bool = False            # register() served fully from cache
    build_time_s: float = 0.0          # ranking + runner build (0 on hit)
    warmup_time_s: float = 0.0
    requests: int = 0
    batches: int = 0
    padded_grids: int = 0              # throwaway grids added for batch pad
    failed_requests: int = 0           # requests lost to dispatch faults
    exec_count: int = 0
    exec_total_s: float = 0.0
    exec_max_s: float = 0.0

    @property
    def exec_mean_s(self) -> float:
        return self.exec_total_s / self.exec_count if self.exec_count else 0.0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["exec_mean_s"] = self.exec_mean_s
        return d


@dataclasses.dataclass
class _Registered:
    name: str
    cached: object          # runtime CachedDesign, or BucketedDesign
    counters: DesignCounters
    iterations: int | None = None      # as passed at register time
    # static-analysis findings from registration-time verification
    # (repro_torch.core.analysis.Diagnostic tuples; empty = clean)
    diagnostics: tuple = ()

    @property
    def bucketed(self) -> bool:
        return isinstance(self.cached, BucketedDesign)

    @property
    def spec(self):
        return self.cached.spec if self.bucketed else self.cached.design.spec

    @property
    def config(self):
        """The chosen config (exact mode) or per-bucket configs (bucketed)."""
        if not self.bucketed:
            return self.cached.design.config
        return {b: e.config for b, e in self.cached.buckets.items()}

    def bucket_for(self, shape):
        return self.cached.bucket_for(shape)


@dataclasses.dataclass
class _InFlight:
    """A dispatched, not-yet-materialised micro-batch."""

    reg: _Registered
    items: list                       # [(ticket, request, shape), ...]
    out: object                       # runner.dispatch result (Pending)
    finalize: object                  # runner.finalize: waits, -> numpy
    post: object                      # np batch -> {ticket: np grid}
    pad: int
    t0: float


class StencilServer:
    """Micro-batching server over cached, batched stencil designs.

    ``max_batch`` bounds grids per dispatch.  ``warmup=True`` (default)
    pushes one zero batch through a freshly built design at register time
    (building its CUDA kernel), so the first real request never pays the
    build.  ``bucketing`` (True / a :class:`ShapeBucketer`) turns
    registrations into multi-geometry logical kernels; ``max_buckets``
    caps each bucketed registration's ladder with LRU eviction;
    ``async_dispatch`` + ``max_inflight`` control the double-buffered
    dispatch loop; ``strict`` refuses registrations carrying
    error-severity static-analysis findings
    (:mod:`repro_torch.core.analysis`).  ``store_dir`` points the server
    at a persistent :class:`repro_torch.runtime.DesignStore` (the
    FPGA-bitstream analogue on disk): rankings, the CUDA kernel's built
    library and serving telemetry survive the process, so a restarted
    replica -- or a fresh one sharing the directory -- reaches its first
    bitwise-identical result without ranking or running ``nvcc``.
    """

    def __init__(
        self,
        max_batch: int = 8,
        platform=None,
        device=None,
        cache: DesignCache | None = None,
        warmup: bool = True,
        bucketing: bool | ShapeBucketer | None = None,
        async_dispatch: bool = True,
        max_inflight: int = 2,
        strict: bool = False,
        max_buckets: int | None = None,
        store_dir=None,
        devices=None,
    ):
        assert max_batch >= 1
        assert max_inflight >= 1
        if store_dir is not None:
            # a persistent replica owns a store-backed cache; passing a
            # cache too would be ambiguous about which memoization it owns
            if cache is not None:
                raise ValueError(
                    "pass either cache= (optionally DesignCache(store=...)) "
                    "or store_dir=, not both"
                )
            cache = DesignCache(store=store_dir)
        self.max_batch = max_batch
        self.platform = platform
        self.devices = resolve_pool(devices, device)
        self.cache = cache if cache is not None else default_cache()
        self.warmup = warmup
        self.bucketing = bucketing
        self.async_dispatch = async_dispatch
        self.max_inflight = max_inflight
        self.strict = strict
        self.max_buckets = max_buckets
        self._designs: dict[str, _Registered] = {}
        self._queue: list[tuple[int, StencilRequest, tuple]] = []
        self._lock = threading.Lock()
        self.failures: dict[int, Exception] = {}   # ticket -> dispatch fault
        self.completed: dict[int, np.ndarray] = {}  # ticket -> result
        self._next_ticket = 0

    # ------------------------------------------------------------------
    # design registration
    # ------------------------------------------------------------------

    def _bucketer_for(self, bucketing) -> ShapeBucketer | None:
        b = self.bucketing if bucketing is None else bucketing
        if not b:
            return None
        return b if isinstance(b, ShapeBucketer) else ShapeBucketer()

    def register(
        self,
        name: str,
        source_or_spec,
        iterations: int | None = None,
        bucketing: bool | ShapeBucketer | None = None,
    ) -> _Registered:
        """Rank + build (both through the design cache) and warm up.

        With bucketing (per-call override of the server default), the
        registration is a logical kernel: only the bucket containing the
        spec's declared shape is built/warmed now, further buckets
        lazily on first request.  Re-registering a name with the same
        design and iterations is idempotent; re-registering it with a
        different one raises.

        Registration runs the static verifier
        (:func:`repro_torch.core.analysis.verify`): findings are attached
        to the returned registration's ``diagnostics``, and under
        ``strict`` any error-severity finding refuses the registration
        with a :class:`repro_torch.core.analysis.VerificationError`
        before anything is built.
        """
        bucketer = self._bucketer_for(bucketing)
        if name in self._designs:
            existing = self._designs[name]
            spec = _as_spec(source_or_spec)
            # bucketed designs are shape-agnostic: compare structure only
            fp = (structural_fingerprint(spec) if existing.bucketed
                  else spec_fingerprint(spec))
            have = (existing.cached.structural if existing.bucketed
                    else existing.cached.fingerprint)
            policy_changed = (
                existing.bucketed != bool(bucketer)
                or (existing.bucketed
                    and existing.cached.bucketer != bucketer)
            )
            if fp != have or iterations != existing.iterations \
                    or policy_changed:
                raise ValueError(
                    f"design {name!r} is already registered with a "
                    "different spec, iteration count, or bucketing "
                    "policy; pick a new name"
                )
            return existing

        spec0 = _as_spec(source_or_spec)
        fn = analysis.verify_or_raise if self.strict else analysis.verify
        diags = tuple(fn(
            spec0, iterations=iterations, bucketed=bucketer is not None,
        ))
        # every registration carries its certified rounding-error bound
        diags += (numerics.bound_diagnostic(spec0, iterations=iterations),)

        if bucketer is not None:
            bucketed = self.cache.bucketed(
                source_or_spec, bucketer=bucketer, platform=self.platform,
                iterations=iterations, devices=self.devices,
                strict=self.strict, max_buckets=self.max_buckets,
            )
            entry = bucketed.runner_for(bucketed.spec.shape, count=0)
            ctr = DesignCounters(
                cache_hit=entry.stats.cache_hit,
                build_time_s=entry.stats.build_time_s,
            )
            reg = _Registered(
                name=name, cached=bucketed, counters=ctr,
                iterations=iterations, diagnostics=diags,
            )
            if self.warmup:
                spec = bucketed.spec
                zeros = {
                    n: np.zeros((self.max_batch,) + tuple(shape), dtype=dt)
                    for n, (dt, shape) in spec.inputs.items()
                }
                t0 = time.perf_counter()
                entry.runner(zeros)
                ctr.warmup_time_s = time.perf_counter() - t0
            self._designs[name] = reg
            return reg

        cached = self.cache.get_or_build(
            source_or_spec, platform=self.platform, iterations=iterations,
            devices=self.devices, strict=self.strict,
        )
        ctr = DesignCounters(
            cache_hit=cached.hit,
            build_time_s=0.0 if cached.hit else cached.build_time_s,
        )
        reg = _Registered(
            name=name, cached=cached, counters=ctr, iterations=iterations,
            diagnostics=diags,
        )
        # Warm even on a design-cache hit: the first dispatch builds the
        # kernel if this process has not; once built it is ~free.
        if self.warmup:
            spec = reg.spec
            zeros = {
                n: np.zeros((self.max_batch,) + tuple(shape), dtype=dt)
                for n, (dt, shape) in spec.inputs.items()
            }
            t0 = time.perf_counter()
            cached.runner(zeros)
            ctr.warmup_time_s = time.perf_counter() - t0
        self._designs[name] = reg
        return reg

    def design(self, name: str) -> _Registered:
        return self._designs[name]

    # ------------------------------------------------------------------
    # request path
    # ------------------------------------------------------------------

    def submit(self, request: StencilRequest, claim=None) -> int:
        """Queue one grid; returns a ticket resolved by a later flush().

        Requests are validated here (input names + grid shapes against
        the registered spec, bucketability under bucketing), so a
        malformed request is rejected at submit time instead of poisoning
        a later batch.  Safe to call from multiple threads.

        ``claim`` makes ticket ownership explicit **at submit time**: a
        ticket submitted under a claim token is invisible to plain
        ``flush()`` calls and is only drained by ``flush(claim=token)``.
        This is what lets concurrent ``serve()`` callers share one
        server without one caller's flush stealing (and racing the
        resolution of) another caller's tickets.
        """
        shape = self._validate(request)
        with self._lock:
            ticket = self._next_ticket
            self._next_ticket += 1
            self._queue.append((ticket, request, shape, claim))
        return ticket

    def _validate(self, request: StencilRequest) -> tuple:
        """Validate one request against its registration; returns the
        request's grid shape.  Raises on unknown designs, unknown/missing
        inputs, shape mismatches, and unbucketable shapes — shared by
        :meth:`submit` and the continuous scheduler's admission path."""
        if request.design not in self._designs:
            raise KeyError(
                f"design {request.design!r} is not registered "
                f"(have {sorted(self._designs)})"
            )
        reg = self._designs[request.design]
        spec = reg.spec
        unknown = sorted(set(request.arrays) - set(spec.inputs))
        if unknown:
            raise ValueError(
                f"request for {request.design!r} has unknown input(s) "
                f"{unknown} (spec inputs: {sorted(spec.inputs)})"
            )
        shape = None
        for n, (_, declared) in spec.inputs.items():
            if n not in request.arrays:
                raise ValueError(
                    f"request for {request.design!r} is missing input {n!r}"
                )
            got = tuple(np.shape(request.arrays[n]))
            if reg.bucketed:
                if shape is None:
                    if len(got) != spec.ndim:
                        raise ValueError(
                            f"request for {request.design!r}: {n} must be a "
                            f"{spec.ndim}-D grid, got shape {got}"
                        )
                    shape = got
                elif got != shape:
                    raise ValueError(
                        f"request for {request.design!r}: inconsistent grid "
                        f"shapes ({n} is {got}, expected {shape})"
                    )
            elif got != tuple(declared):
                raise ValueError(
                    f"request for {request.design!r}: {n} must be shaped "
                    f"{tuple(declared)}, got {got}"
                )
            else:
                shape = got
        if reg.bucketed:
            try:
                reg.bucket_for(shape)     # raises if unservable
            except ValueError as e:
                raise ValueError(
                    f"request for {request.design!r} is not bucketable: {e}"
                ) from e
        return shape

    def flush(self, claim=None) -> dict[int, np.ndarray]:
        """Dispatch queued requests, micro-batched per design/bucket.

        ``flush()`` claims exactly the **unclaimed** tickets queued at
        call time; ``flush(claim=token)`` claims exactly the tickets
        submitted under ``token``.  Either way the claimed set is fixed
        under one lock acquisition and nothing outside it is touched —
        tickets another caller claimed at submit time can never be
        drained (or have their resolution raced) by this call.

        The dispatch loop is double-buffered: while the device executes
        one micro-batch, the host stages the next; completed batches are
        only materialised when the bounded in-flight queue is full or the
        queue drains.  A dispatch fault in one micro-batch never drops
        other requests: every chunk is attempted, successful results are
        returned (and retained in ``self.completed`` until claimed), and
        the failed chunk's tickets land in ``self.failures`` (ticket ->
        exception) instead of resolving.
        """
        with self._lock:
            queue = [e for e in self._queue if e[3] == claim]
            self._queue = [e for e in self._queue if e[3] != claim]
        groups: dict[tuple, list] = {}
        for ticket, req, shape, _ in queue:
            reg = self._designs[req.design]
            bucket = reg.bucket_for(shape) if reg.bucketed else None
            groups.setdefault((req.design, bucket), []).append(
                (ticket, req, shape)
            )
        results: dict[int, np.ndarray] = {}
        inflight: collections.deque[_InFlight] = collections.deque()
        for (name, bucket), items in groups.items():
            reg = self._designs[name]
            for lo in range(0, len(items), self.max_batch):
                chunk = items[lo:lo + self.max_batch]
                while len(inflight) >= self.max_inflight:
                    self._resolve(inflight.popleft(), results)
                t0 = time.perf_counter()
                try:
                    runner, stacked, post, pad = self._prepare(
                        reg, bucket, chunk
                    )
                    chain = (
                        callable(getattr(runner, "stage", None))
                        and callable(getattr(runner, "dispatch", None))
                        and callable(getattr(runner, "finalize", None))
                    )
                    if bucket is None and not chain:
                        # legacy / monkeypatched runner: plain callable
                        out = np.asarray(runner(stacked))
                        self._account(reg, chunk, pad,
                                      time.perf_counter() - t0)
                        results.update(post(out))
                    elif self.async_dispatch:
                        out = runner.dispatch(runner.stage(stacked))
                        inflight.append(_InFlight(
                            reg=reg, items=chunk, out=out,
                            finalize=runner.finalize, post=post, pad=pad,
                            t0=t0,
                        ))
                    else:
                        out = runner.finalize(
                            runner.dispatch(runner.stage(stacked))
                        )
                        self._account(reg, chunk, pad,
                                      time.perf_counter() - t0)
                        results.update(post(out))
                except Exception as e:
                    self._fail(reg, chunk, e)
        while inflight:
            self._resolve(inflight.popleft(), results)
        self.completed.update(results)
        self.persist_telemetry()
        return results

    def persist_telemetry(self) -> None:
        """Write serving counters through to the cache's persistent store
        (no-op without one), so a restarted replica resumes its per-key
        and per-bucket statistics."""
        if self.cache.store is None:
            return
        for reg in self._designs.values():
            if reg.bucketed:
                reg.cached.persist_stats()
        self.cache.flush_telemetry()

    def serve(self, requests: list[StencilRequest]) -> list[np.ndarray]:
        """submit() + flush(), preserving request order; claims only THIS
        call's tickets from ``self.completed``.

        Each call submits under its own claim token, so concurrent
        serve() calls (and concurrent plain flush() callers) on one
        server never drain each other's tickets.

        Raises if any of this call's requests failed to dispatch — other
        tickets' results (and this call's successful ones) stay claimable
        in ``self.completed``.
        """
        claim = object()
        tickets = [self.submit(r, claim=claim) for r in requests]
        self.flush(claim=claim)
        failed = [t for t in tickets if t in self.failures]
        if failed:
            raise RuntimeError(
                f"{len(failed)}/{len(tickets)} requests failed to dispatch"
            ) from self.failures[failed[0]]
        return [self.completed.pop(t) for t in tickets]

    # ------------------------------------------------------------------
    # dispatch internals
    # ------------------------------------------------------------------

    def _prepare(self, reg: _Registered, bucket, chunk):
        """Host-side staging: stack (and under bucketing pad + mask) one
        micro-batch; returns (runner, stacked arrays, post, pad count)."""
        spec = reg.spec
        n = len(chunk)
        pad = self.max_batch - n
        if bucket is None:
            # exact-shape mode: pad the batch by repeating the first grid
            # (one batch shape per design)
            runner = reg.cached.runner
            stacked = {
                name: np.stack(
                    [np.asarray(req.arrays[name]) for _, req, _ in chunk]
                    + [np.asarray(chunk[0][1].arrays[name])] * pad
                )
                for name in spec.inputs
            }

            def post(out):
                return {t: out[i] for i, (t, _, _) in enumerate(chunk)}

            return runner, stacked, post, pad

        entry = reg.cached.entry_for_bucket(bucket, count=n)
        runner = entry.runner
        plan = runner.plan
        stacked = {}
        for name in spec.inputs:
            grids = [
                plan.place_entry(np.asarray(req.arrays[name]))
                for _, req, _ in chunk
            ]
            grids += [plan.filler_entry(name)] * pad
            stacked[name] = np.stack(grids)
        # per-entry streamed service arrays (mask and/or halo-index maps):
        # grids of different shapes share the batch, each re-imposing its
        # own real boundary in-kernel; batch-padding entries carry the
        # plan's throwaway filler (their outputs are discarded by post())
        service = [plan.service_entry(shape) for _, _, shape in chunk]
        filler = plan.service_filler()
        for sname in plan.service_names:
            stacked[sname] = np.stack(
                [e[sname] for e in service] + [filler[sname]] * pad
            )

        def post(out):
            return {
                t: out[i][plan.out_index(shape)]
                for i, (t, _, shape) in enumerate(chunk)
            }

        return runner, stacked, post, pad

    def _resolve(self, infl: _InFlight, results: dict) -> None:
        """Block on one in-flight micro-batch and resolve its tickets."""
        try:
            out = infl.finalize(infl.out)
            self._account(infl.reg, infl.items, infl.pad,
                          time.perf_counter() - infl.t0)
            results.update(infl.post(out))
        except Exception as e:
            self._fail(infl.reg, infl.items, e)

    def _account(self, reg: _Registered, chunk, pad: int, dt: float) -> None:
        ctr = reg.counters
        ctr.requests += len(chunk)
        ctr.batches += 1
        ctr.padded_grids += pad
        ctr.exec_count += 1
        ctr.exec_total_s += dt
        ctr.exec_max_s = max(ctr.exec_max_s, dt)

    def _fail(self, reg: _Registered, chunk, exc: Exception) -> None:
        reg.counters.failed_requests += len(chunk)
        for ticket, _, _ in chunk:
            self.failures[ticket] = exc

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    def stats(self) -> dict[str, dict]:
        """Per-design counters plus the shared cache's global hit/miss."""
        out = {}
        for n, r in self._designs.items():
            d = r.counters.as_dict()
            if r.bucketed:
                d["buckets"] = {
                    "x".join(map(str, b)): s
                    for b, s in r.cached.stats().items()
                }
                d["compiled_buckets"] = r.cached.num_buckets
            out[n] = d
        out["_cache"] = {
            "hits": self.cache.hits,
            "misses": self.cache.misses,
            "entries": len(self.cache),
            "runner_evictions": self.cache.runner_evictions,
            "autotune_calls": self.cache.autotune_calls,
            "jit_builds": self.cache.jit_builds,
            "store_hits": self.cache.store_hits,
        }
        if self.cache.store is not None:
            out["_store"] = self.cache.store.stats.as_dict()
        return out
