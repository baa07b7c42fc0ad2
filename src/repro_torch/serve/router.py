"""Multi-replica serving tier: N scheduler processes, one design store.

PyTorch port of ``repro.serve.router``.  One
:class:`repro_torch.serve.StencilServer` process scales until a single
host's dispatch loop saturates.  The SASA analogy scales further by
*replication*: the expensive artefact (the ranked design and the CUDA
kernel's ``nvcc``-built library) lives in one persistent
:class:`repro_torch.runtime.DesignStore` directory, so extra replicas are
cheap -- each cold-starts warm from disk -- and this module adds the
serving half:

  * **workers** -- ``python -m repro_torch.serve --worker`` runs one
    replica: a ``StencilServer`` + continuous-batching
    ``StencilScheduler`` pair on ``--device`` (``cuda`` by default)
    speaking a length-prefixed pickle protocol over stdin/stdout (no
    ports; stdout is re-pointed at stderr inside the worker, before torch
    is imported, so only protocol frames travel the pipe).
  * **routing** -- :class:`StencilRouter` spawns N workers sharing one
    store directory and routes each request by **rendezvous (HRW)
    hashing of its design's structural fingerprint**: the replica serving
    a design keeps serving it (built buckets stay hot and the batcher
    sees coherent traffic), and when the replica set changes only that
    replica's designs move.
  * **health & handoff** -- a dead worker (crash, EOF, kill) is detected
    by its reader thread; its in-flight submissions are **re-routed to
    surviving replicas** (requests are retained router-side until their
    reply arrives, so handoff needs no worker cooperation), and later
    routing skips the dead replica.  ``ping()`` health-checks the fleet;
    ``close()`` drains every replica before exit so no admitted ticket is
    dropped.

Results are bitwise-identical to a single in-process server: a replica
runs the same scheduler over the same staging path and the same kernel,
and the store only shares *designs*, never numerics.
"""
from __future__ import annotations

import hashlib
import os
import pickle
import struct
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

from repro_torch.runtime.cache import _as_spec, structural_fingerprint
from repro_torch.serve.engine import StencilRequest

_LEN = struct.Struct(">I")


def write_frame(stream, obj, lock=None) -> None:
    """One protocol frame: 4-byte big-endian length + pickle body."""
    body = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    data = _LEN.pack(len(body)) + body
    if lock is None:
        stream.write(data)
        stream.flush()
    else:
        with lock:
            stream.write(data)
            stream.flush()


def read_frame(stream):
    """The next frame, or ``None`` on EOF / truncation (peer is gone)."""
    header = stream.read(_LEN.size)
    if len(header) < _LEN.size:
        return None
    (n,) = _LEN.unpack(header)
    body = stream.read(n)
    if len(body) < n:
        return None
    return pickle.loads(body)


class ReplicaDied(ConnectionError):
    """A worker exited with requests outstanding and no survivor could
    take them over."""


class _Future:
    """Router-side pending reply (submit result or control-op ack)."""

    def __init__(self, payload: dict):
        self.payload = payload            # kept for re-route on death
        self._event = threading.Event()
        self._result = None
        self._error: Exception | None = None

    def resolve(self, msg: dict) -> None:
        if msg.get("ok"):
            self._result = msg.get("result")
        else:
            err = msg.get("error")
            self._error = err if isinstance(err, Exception) else \
                RuntimeError(str(err))
        self._event.set()

    def fail(self, exc: Exception) -> None:
        self._error = exc
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"no reply for {self.payload.get('op')} within {timeout}s"
            )
        if self._error is not None:
            raise self._error
        return self._result


class _Replica:
    """One spawned worker process + its reader thread."""

    def __init__(self, name: str, proc: subprocess.Popen):
        self.name = name
        self.proc = proc
        self.healthy = True
        self.write_lock = threading.Lock()
        self.reader: threading.Thread | None = None

    def send(self, payload: dict) -> None:
        write_frame(self.proc.stdin, payload, self.write_lock)


class StencilRouter:
    """Route requests across N worker replicas sharing one design store.

    ``store_dir`` is the shared persistent store (created on first use);
    ``replicas`` is the worker count; ``device`` (``"cuda"`` by default,
    ``"cpu"`` for the kernels' plain versions), ``max_batch`` /
    ``bucketing`` / ``max_inflight`` configure each worker's server.
    Workers inherit this process's environment plus a ``PYTHONPATH`` that
    makes ``repro_torch`` importable, so the router works from a source
    checkout without installation.
    """

    def __init__(
        self,
        store_dir,
        replicas: int = 2,
        max_batch: int = 4,
        bucketing: bool = False,
        max_inflight: int = 2,
        warmup: bool = False,
        spawn_timeout_s: float = 120.0,
        device: str = "cuda",
    ):
        if replicas < 1:
            raise ValueError(f"need >= 1 replica, got {replicas}")
        self.store_dir = str(store_dir)
        self.max_batch = max_batch
        self._lock = threading.Lock()
        self._pending: dict[int, tuple[_Future, _Replica]] = {}
        self._next_id = 0
        self._specs: dict[str, object] = {}      # name -> registered spec
        self._registrations: list[dict] = []     # replayed on re-route
        self._closed = False
        self._replicas: list[_Replica] = []

        import repro_torch

        src_dir = str(Path(next(iter(repro_torch.__path__))).resolve().parent)
        env = dict(os.environ)
        env["PYTHONPATH"] = src_dir + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else ""
        )
        argv = [
            sys.executable, "-m", "repro_torch.serve", "--worker",
            "--store", self.store_dir,
            "--device", str(device),
            "--max-batch", str(max_batch),
            "--max-inflight", str(max_inflight),
        ]
        if bucketing:
            argv.append("--bucketing")
        if warmup:
            argv.append("--warmup")
        for i in range(replicas):
            proc = subprocess.Popen(
                argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                env=env,
            )
            replica = _Replica(f"replica-{i}", proc)
            replica.reader = threading.Thread(
                target=self._read_loop, args=(replica,),
                name=f"router-read-{i}", daemon=True,
            )
            replica.reader.start()
            self._replicas.append(replica)
        # health-check now: a worker that can't even import dies here,
        # at construction, not at the first request
        for replica in self._replicas:
            self._control(replica, {"op": "ping"}).result(spawn_timeout_s)

    # ------------------------------------------------------------------
    # wire plumbing
    # ------------------------------------------------------------------

    def _enqueue(self, replica: _Replica, payload: dict) -> _Future:
        future = _Future(payload)
        with self._lock:
            payload["id"] = self._next_id
            self._next_id += 1
            self._pending[payload["id"]] = (future, replica)
        try:
            replica.send(payload)
        except (OSError, ValueError) as e:       # broken pipe: dead worker
            self._on_death(replica, e)
        return future

    def _control(self, replica: _Replica, payload: dict) -> _Future:
        return self._enqueue(replica, dict(payload))

    def _read_loop(self, replica: _Replica) -> None:
        while True:
            try:
                msg = read_frame(replica.proc.stdout)
            except Exception:
                msg = None
            if msg is None:
                break
            with self._lock:
                entry = self._pending.pop(msg.get("id"), None)
            if entry is not None:
                entry[0].resolve(msg)
        self._on_death(replica, None)

    def _on_death(self, replica: _Replica, cause) -> None:
        """Mark a replica dead and hand its outstanding requests to the
        survivors (re-routed whole: the router retains every payload
        until its reply arrives, so handoff needs nothing back from the
        dead worker)."""
        if not replica.healthy:
            return
        replica.healthy = False
        with self._lock:
            orphans = [
                (rid, fut) for rid, (fut, rep) in self._pending.items()
                if rep is replica
            ]
            for rid, _ in orphans:
                del self._pending[rid]
        if self._closed:
            for _, fut in orphans:
                fut.fail(ReplicaDied(
                    f"{replica.name} exited during shutdown"
                ))
            return
        for _, fut in orphans:
            survivor = self._pick(self._healthy())
            if survivor is None:
                fut.fail(ReplicaDied(
                    f"{replica.name} died ({cause!r}) with no surviving "
                    "replica to take over"
                ))
                continue
            payload = dict(fut.payload)
            payload.pop("id", None)
            if payload.get("op") == "submit":
                # the survivor may never have seen this design: replay
                # registrations first (idempotent server-side)
                self._ensure_registered(survivor)
            with self._lock:
                payload["id"] = self._next_id
                self._next_id += 1
                self._pending[payload["id"]] = (fut, survivor)
            fut.payload = payload
            try:
                survivor.send(payload)
            except (OSError, ValueError) as e:
                self._on_death(survivor, e)

    def _healthy(self) -> list[_Replica]:
        return [r for r in self._replicas if r.healthy]

    @staticmethod
    def _pick(candidates: list[_Replica], token: str = ""):
        """Rendezvous (highest-random-weight) hash: each token owns a
        stable replica while the set is unchanged, and a membership
        change only moves the dead replica's tokens."""
        best, best_score = None, None
        for replica in candidates:
            score = hashlib.sha256(
                f"{token}|{replica.name}".encode()
            ).digest()
            if best_score is None or score > best_score:
                best, best_score = replica, score
        return best

    def _route(self, design: str) -> _Replica:
        spec = self._specs.get(design)
        token = structural_fingerprint(spec) if spec is not None else design
        replica = self._pick(self._healthy(), token)
        if replica is None:
            raise ReplicaDied("no healthy replicas")
        return replica

    def _ensure_registered(self, replica: _Replica) -> None:
        for msg in list(self._registrations):
            if replica.name not in msg["_sent_to"]:
                self._control(replica, {
                    k: v for k, v in msg.items() if k != "_sent_to"
                }).result(120.0)
                msg["_sent_to"].add(replica.name)

    # ------------------------------------------------------------------
    # serving surface
    # ------------------------------------------------------------------

    def register(self, name: str, source_or_spec, iterations=None,
                 bucketing=None) -> None:
        """Register a design on every replica.

        The first replica registers alone -- it ranks, builds the kernel
        and writes the shared store -- then the rest register
        concurrently, each warm-starting from the persisted design and
        library instead of ranking and compiling again.  ``bucketing``
        (True / a :class:`repro_torch.runtime.ShapeBucketer`) overrides
        the workers' default for this registration, as
        :meth:`StencilServer.register`'s does."""
        spec = _as_spec(source_or_spec)
        payload = {
            "op": "register", "name": name, "spec": spec,
            "iterations": iterations, "bucketing": bucketing,
            "_sent_to": set(),
        }
        healthy = self._healthy()
        if not healthy:
            raise ReplicaDied("no healthy replicas")
        wire = {k: v for k, v in payload.items() if k != "_sent_to"}
        self._control(healthy[0], wire).result(300.0)
        payload["_sent_to"].add(healthy[0].name)
        futures = [
            (replica, self._control(replica, wire))
            for replica in healthy[1:]
        ]
        for replica, future in futures:
            future.result(300.0)
            payload["_sent_to"].add(replica.name)
        self._specs[name] = spec
        self._registrations.append(payload)

    def submit(
        self, request: StencilRequest, lane: str | None = None,
        tenant: str = "default",
    ) -> _Future:
        """Route one request to its design's replica; returns a future
        whose ``result()`` is the grid (or raises the replica's fault,
        :class:`repro_torch.serve.Backpressure` included)."""
        replica = self._route(request.design)
        return self._enqueue(replica, {
            "op": "submit", "design": request.design,
            "arrays": {n: np.asarray(a) for n, a in request.arrays.items()},
            "lane": lane, "tenant": tenant,
        })

    def serve(self, requests: list[StencilRequest], timeout: float = 300.0):
        """Submit a batch and gather results in request order."""
        futures = [self.submit(r) for r in requests]
        return [f.result(timeout) for f in futures]

    def ping(self) -> dict:
        """Health-check every live replica; returns per-replica scheduler
        stats (dead replicas are reported, not raised)."""
        out = {}
        for replica in self._replicas:
            if not replica.healthy:
                out[replica.name] = {"healthy": False}
                continue
            try:
                stats = self._control(replica, {"op": "ping"}).result(60.0)
                out[replica.name] = {"healthy": True, **(stats or {})}
            except Exception as e:
                out[replica.name] = {"healthy": False, "error": repr(e)}
        return out

    def drain(self) -> None:
        """Resolve every outstanding ticket on every replica."""
        futures = [
            self._control(r, {"op": "drain"}) for r in self._healthy()
        ]
        for f in futures:
            f.result(300.0)

    def close(self) -> None:
        """Drain, stop, and reap every worker.  Idempotent."""
        if self._closed:
            return
        try:
            self.drain()
        except Exception:
            pass
        self._closed = True
        for replica in self._healthy():
            try:
                self._control(replica, {"op": "exit"}).result(60.0)
            except Exception:
                pass
        for replica in self._replicas:
            try:
                replica.proc.stdin.close()
            except Exception:
                pass
            try:
                replica.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                replica.proc.kill()
                replica.proc.wait(timeout=30)
            replica.healthy = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
