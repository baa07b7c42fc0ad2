"""Continuous-batching scheduler: flush-free serving over a StencilServer.

PyTorch port of ``repro.serve.scheduler``.  The flush-driven loop in
:mod:`repro_torch.serve.engine` is a *barrier*
scheduler: requests wait until some caller flushes, every queued ticket
dispatches, the flush returns.  That shape is fine for offline batches
but wrong for open-loop traffic — arrivals between flushes wait for the
next barrier, and a slow design's batch blocks an interactive one's.

``StencilScheduler`` replaces the barrier with the continuous-batching
idiom from the LLM-serving ecosystem, adapted to SASA's bucketed
micro-batches (which are already the right admission unit: one built
design serves one ``design x bucket`` group at a fixed batch width):

  * **admission** — ``submit()`` validates against the registration
    (same checks as the engine), stamps a deadline from the request's
    SLO lane, and enqueues into its ``design x bucket`` group in
    deadline order.  Admission is bounded: a full queue or an exhausted
    per-tenant quota rejects with :class:`Backpressure` carrying a
    ``retry_after_s`` hint instead of growing without bound.
  * **dispatch loop** — a background thread coalesces each group up to
    the server's ``max_batch``, dispatching a group when it is full,
    when its oldest ticket has waited out the gather window, or when its
    head deadline's slack runs low.  Among due groups the earliest head
    deadline wins, tie-broken round-robin by least-recently-served
    design so one hot kernel cannot starve the others.  In-flight
    micro-batches are reaped **non-blockingly** (``runner.ready``, a query
    of the CUDA event recorded after the batch) so admission and staging
    overlap device execution, exactly like the engine's double-buffered
    flush; ``runner.finalize`` waits on that event.
  * **resolution** — every ticket is a small future: ``result()``
    blocks (with timeout) until its micro-batch materialises; dispatch
    faults surface per ticket, never as a dropped request.  ``drain()``
    resolves every outstanding ticket; ``close()`` drains and stops.

Results are **bitwise-identical** to the synchronous engine path: the
scheduler stages through the server's own ``_prepare`` (same padding to
the ``max_batch`` width, same streamed service inputs, same
built runner), so a grid's result does not depend on which batch -- or
which scheduler -- carried it.

Unit tests drive the loop deterministically: construct with
``start=False`` and call :meth:`StencilScheduler.step` by hand.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import threading
import time

import numpy as np

# default SLO lanes (seconds of slack granted at admission). Tighter
# lane -> earlier deadline -> dispatched first under contention.
DEFAULT_LANES = {
    "interactive": 0.05,
    "standard": 0.5,
    "batch": 5.0,
}


class Backpressure(RuntimeError):
    """Admission rejected: queue or tenant quota is full.

    ``retry_after_s`` is the scheduler's estimate of when capacity
    frees up — clients back off instead of the queue growing without
    bound (reject-with-retry-after, not buffer-until-OOM).
    """

    def __init__(self, message: str, retry_after_s: float):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)

    def __reduce__(self):
        # default exception pickling calls cls(*args) with args=(message,),
        # losing retry_after_s — the router ships these across processes
        return (Backpressure, (str(self), self.retry_after_s))


@dataclasses.dataclass(eq=False)      # identity hash: tickets key results
class Ticket:
    """One admitted request: a future resolved by the dispatch loop."""

    id: int
    design: str
    lane: str
    tenant: str
    deadline: float                       # monotonic seconds
    _event: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False
    )
    _result: "np.ndarray | None" = dataclasses.field(
        default=None, repr=False
    )
    _error: Exception | None = dataclasses.field(default=None, repr=False)
    completed_at: float | None = None     # monotonic resolution stamp

    def done(self) -> bool:
        return self._event.is_set()

    def exception(self) -> Exception | None:
        """The dispatch fault that resolved this ticket, if any (does
        not block; ``None`` while pending or on success)."""
        return self._error

    def result(self, timeout: float | None = None) -> np.ndarray:
        """Block until resolved; returns the grid or raises the fault."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"ticket {self.id} ({self.design!r}, lane {self.lane!r}) "
                f"not resolved within {timeout}s"
            )
        if self._error is not None:
            raise self._error
        return self._result


@dataclasses.dataclass
class _Group:
    """Pending tickets of one ``design x bucket``, deadline-ordered."""

    key: tuple                            # (design name, bucket | None)
    heap: list = dataclasses.field(default_factory=list)
    oldest_t: float = 0.0                 # enqueue time of current oldest

    def __len__(self) -> int:
        return len(self.heap)


@dataclasses.dataclass
class _InFlight:
    reg: object
    chunk: list                           # [(ticket, request, shape), ...]
    out: object
    runner: object
    post: object
    pad: int
    t0: float


class StencilScheduler:
    """Flush-free continuous batching over a :class:`StencilServer`.

    The scheduler owns admission and dispatch; the server contributes
    its registrations, validation, staging (``_prepare``), counters, and
    batch geometry (``max_batch`` / ``max_inflight``).  Both serving
    paths can coexist on one server: the scheduler never touches the
    server's flush queue or ticket space.

    ``lanes`` maps lane name -> SLO seconds (:data:`DEFAULT_LANES` when
    omitted); ``max_queue`` bounds total pending tickets; ``quota``
    bounds *outstanding* (admitted, unresolved) tickets per tenant — an
    int applies to every tenant, a dict sets per-tenant limits with
    ``None`` meaning unlimited.  ``gather_window_s`` is how long a
    non-full group may wait for coalescing partners before it dispatches
    anyway.  ``start=False`` skips the background thread: tests call
    :meth:`step` / :meth:`drain` deterministically.
    """

    def __init__(
        self,
        server,
        lanes: dict | None = None,
        default_lane: str = "standard",
        max_queue: int = 1024,
        quota=None,
        gather_window_s: float = 0.002,
        poll_interval_s: float = 0.0005,
        start: bool = True,
    ):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.server = server
        self.lanes = dict(lanes) if lanes is not None else dict(DEFAULT_LANES)
        if default_lane not in self.lanes:
            raise ValueError(
                f"default lane {default_lane!r} not in lanes "
                f"{sorted(self.lanes)}"
            )
        self.default_lane = default_lane
        self.max_queue = max_queue
        self.quota = quota
        self.gather_window_s = gather_window_s
        self.poll_interval_s = poll_interval_s
        self._mutex = threading.Lock()
        self._work = threading.Condition(self._mutex)
        self._groups: "collections.OrderedDict[tuple, _Group]" = (
            collections.OrderedDict()
        )
        self._pending = 0                 # tickets admitted, not dispatched
        self._outstanding: collections.Counter = collections.Counter()
        self._inflight: collections.deque[_InFlight] = collections.deque()
        self._dispatching = 0             # chunks owned by a dispatch/reap
        self._last_served: dict[str, int] = {}   # design -> serve sequence
        self._serve_seq = 0
        self._seq = 0                     # heap tie-break
        self._next_id = 0
        self._draining = False
        self._stop = False
        self._step_lock = threading.Lock()
        # counters (stats() keeps these finite-clean by construction)
        self.admitted = 0
        self.rejected = 0                 # Backpressure admissions
        self.dispatched_batches = 0
        self.completed = 0
        self.failed = 0
        self.deadline_misses = 0          # resolved after their deadline
        self._thread: threading.Thread | None = None
        if start:
            self._thread = threading.Thread(
                target=self._loop, name="stencil-scheduler", daemon=True
            )
            self._thread.start()

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def _quota_for(self, tenant: str):
        if self.quota is None:
            return None
        if isinstance(self.quota, dict):
            return self.quota.get(tenant)
        return self.quota

    def _retry_after(self) -> float:
        """Capacity hint for rejected admissions: roughly one queue's
        worth of micro-batches at the fleet's observed mean batch
        latency (zero-guarded; floors at the gather window)."""
        mean_s, n = 0.0, 0
        for reg in self.server._designs.values():
            c = reg.counters
            if c.exec_count:
                mean_s += c.exec_mean_s
                n += 1
        mean_s = (mean_s / n) if n else 0.01
        batches = (self._pending // max(1, self.server.max_batch)) + 1
        return max(self.gather_window_s, batches * mean_s)

    def submit(
        self,
        request,
        lane: str | None = None,
        tenant: str = "default",
        deadline_s: float | None = None,
    ) -> Ticket:
        """Admit one request; returns a :class:`Ticket` future.

        Validation is the server's own (unknown design / bad inputs
        raise immediately).  ``lane`` picks the SLO deadline
        (``deadline_s`` overrides it outright); ``tenant`` is the quota
        accounting unit.  Raises :class:`Backpressure` — with a
        ``retry_after_s`` hint — when the queue or the tenant's quota
        is full.
        """
        shape = self.server._validate(request)
        reg = self.server._designs[request.design]
        bucket = reg.bucket_for(shape) if reg.bucketed else None
        lane = lane if lane is not None else self.default_lane
        if lane not in self.lanes:
            raise ValueError(f"unknown lane {lane!r} ({sorted(self.lanes)})")
        now = time.monotonic()
        slo = self.lanes[lane] if deadline_s is None else deadline_s
        with self._work:
            if self._pending >= self.max_queue:
                self.rejected += 1
                raise Backpressure(
                    f"queue full ({self._pending}/{self.max_queue} pending)",
                    retry_after_s=self._retry_after(),
                )
            limit = self._quota_for(tenant)
            if limit is not None and self._outstanding[tenant] >= limit:
                self.rejected += 1
                raise Backpressure(
                    f"tenant {tenant!r} quota exhausted "
                    f"({self._outstanding[tenant]}/{limit} outstanding)",
                    retry_after_s=self._retry_after(),
                )
            ticket = Ticket(
                id=self._next_id, design=request.design, lane=lane,
                tenant=tenant, deadline=now + slo,
            )
            self._next_id += 1
            key = (request.design, bucket)
            group = self._groups.get(key)
            if group is None:
                group = self._groups[key] = _Group(key=key)
            if not group.heap:
                group.oldest_t = now
            heapq.heappush(
                group.heap, (ticket.deadline, self._seq, ticket, request,
                             shape)
            )
            self._seq += 1
            self._pending += 1
            self._outstanding[tenant] += 1
            self.admitted += 1
            self._work.notify_all()
        return ticket

    # ------------------------------------------------------------------
    # the dispatch loop
    # ------------------------------------------------------------------

    def _has_work(self) -> bool:
        return bool(self._pending or self._dispatching or self._inflight)

    def _loop(self) -> None:
        while True:
            with self._work:
                if self._stop and not self._has_work():
                    return
                if not self._has_work():
                    self._work.wait(timeout=0.05)
                    continue
            if not self.step():
                time.sleep(self.poll_interval_s)

    def _select_due(self, now: float):
        """The due group to dispatch next, or None.

        Due = full batch, gather window elapsed, head-deadline slack at
        or below the gather window, or draining.  Earliest head deadline
        wins; ties go to the least-recently-served design (round-robin
        fairness across registered kernels).
        """
        best, best_rank = None, None
        for group in self._groups.values():
            if not group.heap:
                continue
            head_deadline = group.heap[0][0]
            due = (
                len(group.heap) >= self.server.max_batch
                or (now - group.oldest_t) >= self.gather_window_s
                or (head_deadline - now) <= self.gather_window_s
                or self._draining
                or self._stop
            )
            if not due:
                continue
            rank = (head_deadline, self._last_served.get(group.key[0], -1))
            if best_rank is None or rank < best_rank:
                best, best_rank = group, rank
        return best

    def step(self) -> bool:
        """One scheduling iteration: reap what finished, dispatch the
        most urgent due group.  Returns whether any progress was made
        (the loop sleeps a poll interval when idle).  Thread-safe;
        tests with ``start=False`` call this directly."""
        with self._step_lock:
            progressed = self._reap(block=False)
            now = time.monotonic()
            with self._work:
                group = self._select_due(now)
                chunk = None
                if group is not None:
                    n = min(len(group.heap), self.server.max_batch)
                    chunk = []
                    for _ in range(n):
                        _, _, ticket, request, shape = heapq.heappop(
                            group.heap
                        )
                        chunk.append((ticket, request, shape))
                    self._pending -= n
                    # counted until the chunk lands in _inflight or
                    # resolves, so drain()'s _has_work() barrier cannot
                    # slip through mid-dispatch
                    self._dispatching += 1
                    if group.heap:
                        group.oldest_t = now
                    self._serve_seq += 1
                    self._last_served[group.key[0]] = self._serve_seq
            if chunk is None:
                if self._draining and self._inflight:
                    return self._reap(block=True) or progressed
                return progressed
            try:
                while len(self._inflight) >= self.server.max_inflight:
                    self._reap(block=True)   # free an in-flight slot
                self._dispatch(group.key, chunk)
            finally:
                with self._work:
                    self._dispatching -= 1
                    self._work.notify_all()
            return True

    def _dispatch(self, key, chunk) -> None:
        """Stage + dispatch one micro-batch through the server's own
        staging path (identical padding and runner as the sync engine,
        hence bitwise-identical results)."""
        name, bucket = key
        reg = self.server._designs[name]
        t0 = time.perf_counter()
        try:
            runner, stacked, post, pad = self.server._prepare(
                reg, bucket, chunk
            )
            chain = (
                callable(getattr(runner, "stage", None))
                and callable(getattr(runner, "dispatch", None))
                and callable(getattr(runner, "finalize", None))
            )
            if not chain:
                # legacy / monkeypatched runner: synchronous plain call
                out = np.asarray(runner(stacked))
                self.server._account(reg, chunk, pad,
                                     time.perf_counter() - t0)
                self._resolve_chunk(chunk, post(out))
                self.dispatched_batches += 1
                return
            out = runner.dispatch(runner.stage(stacked))
        except Exception as e:
            self._fail_chunk(reg, chunk, e)
            return
        self.dispatched_batches += 1
        self._inflight.append(_InFlight(
            reg=reg, chunk=chunk, out=out, runner=runner, post=post,
            pad=pad, t0=t0,
        ))

    def _reap(self, block: bool) -> bool:
        """Resolve finished in-flight batches; with ``block`` resolve at
        least the oldest one even if it means waiting on the device."""
        did = False
        while self._inflight:
            head = self._inflight[0]
            ready = getattr(head.runner, "ready", None)
            is_done = bool(ready(head.out)) if callable(ready) else True
            if not (block or is_done):
                break
            # own the chunk across the reap: between popleft and
            # resolution it is in neither _inflight nor any queue, and
            # drain()'s _has_work() barrier must not slip through that
            # window while finalize waits on the device
            with self._work:
                self._dispatching += 1
            try:
                infl = self._inflight.popleft()
                try:
                    out = infl.runner.finalize(infl.out)
                    self.server._account(
                        infl.reg, infl.chunk, infl.pad,
                        time.perf_counter() - infl.t0,
                    )
                    self._resolve_chunk(infl.chunk, infl.post(out))
                except Exception as e:
                    self._fail_chunk(infl.reg, infl.chunk, e)
            finally:
                with self._work:
                    self._dispatching -= 1
                    self._work.notify_all()
            did = True
            block = False                 # only force the oldest
        return did

    def _resolve_chunk(self, chunk, results: dict) -> None:
        now = time.monotonic()
        with self._work:
            for ticket, _, _ in chunk:
                ticket._result = results[ticket]
                ticket.completed_at = now
                if now > ticket.deadline:
                    self.deadline_misses += 1
                self._outstanding[ticket.tenant] -= 1
                self.completed += 1
                ticket._event.set()
            self._work.notify_all()

    def _fail_chunk(self, reg, chunk, exc: Exception) -> None:
        reg.counters.failed_requests += len(chunk)
        now = time.monotonic()
        with self._work:
            for ticket, _, _ in chunk:
                ticket._error = exc
                ticket.completed_at = now
                self._outstanding[ticket.tenant] -= 1
                self.failed += 1
                ticket._event.set()
            self._work.notify_all()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def drain(self, timeout: float = 120.0) -> None:
        """Dispatch and resolve every outstanding ticket (all groups
        become due; in-flight batches block-reap).  Every admitted
        ticket is resolved — with a result or a fault — before this
        returns."""
        self._draining = True
        try:
            deadline = time.monotonic() + timeout
            if self._thread is None or not self._thread.is_alive():
                while self._has_work():
                    if not self.step():
                        self._reap(block=True)
                    if time.monotonic() > deadline:
                        raise TimeoutError("drain timed out")
            else:
                with self._work:
                    self._work.notify_all()
                    while self._has_work():
                        if not self._work.wait(timeout=0.05):
                            if time.monotonic() > deadline:
                                raise TimeoutError("drain timed out")
        finally:
            self._draining = False
        self.server.persist_telemetry()

    def close(self, timeout: float = 120.0) -> None:
        """Drain, then stop the background loop.  Idempotent."""
        self.drain(timeout=timeout)
        self._stop = True
        with self._work:
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    def stats(self) -> dict:
        """Scheduler counters (always finite): admission, queue depth,
        dispatch, and per-lane pending breakdown."""
        with self._mutex:
            per_lane = collections.Counter()
            for group in self._groups.values():
                for _, _, ticket, _, _ in group.heap:
                    per_lane[ticket.lane] += 1
            return {
                "admitted": self.admitted,
                "rejected": self.rejected,
                "pending": self._pending,
                "inflight": len(self._inflight),
                "dispatched_batches": self.dispatched_batches,
                "completed": self.completed,
                "failed": self.failed,
                "deadline_misses": self.deadline_misses,
                "pending_by_lane": dict(per_lane),
                "outstanding_by_tenant": {
                    t: n for t, n in self._outstanding.items() if n
                },
            }
