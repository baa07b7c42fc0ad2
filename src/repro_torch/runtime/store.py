"""Persistent design store: the on-disk half of the FPGA-bitstream analogy.

PyTorch port of ``repro.runtime.store``.  SASA synthesizes a tuned design
**once** into a bitstream and reuses it for the deployment's lifetime;
:class:`repro_torch.runtime.DesignCache` is the in-process analogue, and
``DesignStore`` persists both of its levels to a directory that N replica
processes can share:

  * **design entries** -- the ranking (the lowered spec and the full
    :class:`repro_torch.core.model.Prediction` list), so a warm start
    never re-enumerates the design space;
  * **executable entries** -- the ``nvcc``-built shared library of the
    CUDA tile kernel (``libsasa.so``, :mod:`repro_torch.kernels.cuda_build`),
    one file per (runner, kernel key), so a warm replica reaches its first
    bitwise-identical result without running ``nvcc``.  This is the one
    executable tier, ``cuda_so``.  On a CPU pool the kernels' plain
    versions compile nothing and the store holds rankings only;
  * **telemetry** -- the cache's per-key :class:`KeyStats` and each
    registration's per-bucket :class:`BucketStats` counters, restored on
    warm start.

Layout and invalidation::

    <root>/
      manifest.json                  # schema + the envs ever written
      <env>/                         # schema<N>-torch<version>-cuda<version>
        designs/<digest>.pkl         # ranking entries
        executables/<digest>.<sig>.pkl
        telemetry/<writer>.pkl       # one counter file per writer
        telemetry.pkl                # legacy single-snapshot (read-only)
        quarantine/                  # corrupt/undecodable entries land here

The **environment tag** bakes the store schema, the torch version and the
CUDA version torch was built for into the directory name, from the
installation alone (no device is queried, so opening a store on a host
without a card chooses no device).  An upgrade makes every stale entry
invisible and ``python -m repro_torch.store prune`` deletes the dead
environments.  An executable entry's signature is the kernel key
(:func:`repro_torch.kernels.cuda_build.kernel_key`: generated sources,
template hash, ``nvcc`` flags), so a template change invalidates every
binary without a schema bump; its metadata records the compute capability,
CUDA version and pool size, and :meth:`DesignStore.get_executable` treats
a mismatch on any of them as a miss.

Every write is atomic (tmp file + ``os.replace`` in the same directory)
and every entry is framed with a magic header + SHA-256 checksum: a
corrupt, truncated or undecodable file is **quarantined** (moved aside,
counted) rather than crashing the replica.  Telemetry writes never
read-modify-write a shared record: each writer owns one file under
``telemetry/`` and :meth:`DesignStore.get_telemetry` merges all of them
with the monotone-counter policy of :func:`merge_counters`.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import pickle
import shutil
import subprocess
import tempfile
import time
import uuid
from pathlib import Path

import torch

from repro_torch.kernels import cuda_build

SCHEMA_VERSION = 1
AOT_KIND = "cuda_so"

_MAGIC = b"SASA-STORE\x01"


def environment_tag() -> str:
    """The invalidation unit: schema x torch version x CUDA version."""
    return (
        f"schema{SCHEMA_VERSION}-torch{torch.__version__}-"
        f"cuda{torch.version.cuda or 'none'}"
    )


def _digest(payload: str, n: int = 24) -> str:
    return hashlib.sha256(payload.encode()).hexdigest()[:n]


def design_key(structural: str, shape, platform, iterations) -> str:
    """Process-independent key for a ranking entry (the cache's
    design-level key; ``platform`` is the whole :class:`GPUPlatform`, so
    a recalibrated ranker misses old rankings)."""
    return repr(("design", structural, tuple(shape), platform, iterations))


def runner_key(
    structural: str, shape, cfg, pool_key, n_used: int, iterations,
) -> str:
    """Process-independent key for an executable entry: the runner the
    library serves, with the pool it was built for and the device count
    it occupies."""
    return repr((
        "runner", structural, tuple(shape), cfg, tuple(pool_key), n_used,
        iterations,
    ))


def merge_counters(a: dict, b: dict) -> dict:
    """Merge two counter dicts of the same shape, field-wise, under the
    monotone-counter policy:

      * booleans OR (``cache_hit`` stays sticky once any writer hit);
      * fields named ``*max*`` take the max of the two observations;
      * derived means (``*mean*``) are **recomputed from the merged
        sums** (``exec_mean_s`` from ``exec_total_s / exec_count``),
        zero-guarded, never summed or averaged naively;
      * every other numeric field sums;
      * non-numeric fields keep ``a``'s value.
    """
    out = dict(a)
    for k, vb in b.items():
        if k not in out:
            out[k] = vb
            continue
        va = out[k]
        if isinstance(va, bool) or isinstance(vb, bool):
            out[k] = bool(va) or bool(vb)
        elif "mean" in k:
            continue                       # recomputed from sums below
        elif not (isinstance(va, (int, float))
                  and isinstance(vb, (int, float))):
            continue                       # non-numeric: first writer wins
        elif "max" in k:
            out[k] = max(va, vb)
        else:
            out[k] = va + vb
    for k in list(out):
        if "mean" not in k:
            continue
        total_key = k.replace("mean", "total")
        count_key = k.replace("_mean_s", "_count").replace("_mean", "_count")
        if total_key in out and count_key in out:
            cnt = out[count_key]
            out[k] = out[total_key] / cnt if cnt else 0.0
    return out


def subtract_counters(current: dict, baseline: dict) -> dict:
    """``current - baseline`` under the same policy: the delta a writer
    persists when its in-memory counters were *seeded* from restored
    telemetry, so the restored history is never written back.  Summed
    fields subtract (clamped at zero); max / mean / bool fields pass
    through."""
    out = dict(current)
    for k, vb in baseline.items():
        va = out.get(k)
        if (
            isinstance(va, bool) or not isinstance(va, (int, float))
            or not isinstance(vb, (int, float))
            or "max" in k or "mean" in k
        ):
            continue
        out[k] = max(0, va - vb) if isinstance(va, int) else max(0.0, va - vb)
    return out


@functools.lru_cache(maxsize=1)
def nvcc_release() -> str | None:
    """The release line of ``nvcc --version``, or ``None`` without nvcc."""
    try:
        out = subprocess.run(
            [cuda_build.nvcc_path(), "--version"], capture_output=True,
            text=True, timeout=60,
        ).stdout
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return None
    lines = [ln.strip() for ln in out.splitlines() if "release" in ln]
    return lines[0] if lines else None


def _capability(device) -> tuple[int, int] | None:
    if device is None or torch.device(device).type != "cuda":
        return None
    return tuple(torch.cuda.get_device_capability(device))


@dataclasses.dataclass
class StoreStats:
    design_hits: int = 0
    design_misses: int = 0
    executable_hits: int = 0
    executable_misses: int = 0
    writes: int = 0
    quarantined: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class DesignStore:
    """A persistent, multi-process-safe design store rooted at ``root``.

    ``readonly=True`` never writes (no manifest update, no entry or
    telemetry writes).  All ``get_*`` methods return ``None`` on miss and
    *never raise on bad entries*: undecodable files are quarantined and
    reported as misses.
    """

    def __init__(self, root, readonly: bool = False,
                 env_tag: str | None = None):
        self.root = Path(root)
        self.readonly = readonly
        self.env_tag = env_tag or environment_tag()
        self.stats = StoreStats()
        self._env = self.root / self.env_tag
        # telemetry writer identity: one counter file per store instance
        self._writer_id = f"{os.getpid()}-{uuid.uuid4().hex[:8]}"
        if not readonly:
            for sub in ("designs", "executables", "quarantine"):
                (self._env / sub).mkdir(parents=True, exist_ok=True)
            self._update_manifest()

    # ------------------------------------------------------------------
    # manifest
    # ------------------------------------------------------------------

    def _update_manifest(self) -> None:
        path = self.root / "manifest.json"
        manifest = {"schema": SCHEMA_VERSION, "environments": []}
        if path.exists():
            try:
                manifest = json.loads(path.read_text())
            except (json.JSONDecodeError, OSError):
                pass  # rewrite a fresh manifest below
        envs = set(manifest.get("environments", ()))
        if self.env_tag in envs and manifest.get("schema") == SCHEMA_VERSION:
            return
        envs.add(self.env_tag)
        manifest = {
            "schema": SCHEMA_VERSION,
            "environments": sorted(envs),
            "updated": time.time(),
        }
        self._atomic_write(path, json.dumps(manifest, indent=2).encode())

    # ------------------------------------------------------------------
    # framed atomic file IO
    # ------------------------------------------------------------------

    def _atomic_write(self, path: Path, data: bytes) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            dir=str(path.parent), prefix=path.name, suffix=".tmp"
        )
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)   # atomic on POSIX: readers see old or new
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def _write_entry(self, path: Path, obj) -> None:
        if self.readonly:
            return
        body = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        framed = _MAGIC + hashlib.sha256(body).digest() + body
        self._atomic_write(path, framed)
        self.stats.writes += 1

    def _read_entry(self, path: Path):
        """Decode one framed entry; quarantine anything undecodable."""
        try:
            raw = path.read_bytes()
        except OSError:
            return None
        try:
            if not raw.startswith(_MAGIC):
                raise ValueError("bad magic")
            digest, body = raw[len(_MAGIC):len(_MAGIC) + 32], \
                raw[len(_MAGIC) + 32:]
            if hashlib.sha256(body).digest() != digest:
                raise ValueError("checksum mismatch")
            return pickle.loads(body)
        except Exception:
            self._quarantine(path)
            return None

    def _quarantine(self, path: Path) -> None:
        """Move a bad entry aside (atomic) so the replica keeps serving."""
        self.stats.quarantined += 1
        if self.readonly:
            return
        target = self._env / "quarantine" / f"{path.name}.{os.getpid()}"
        try:
            target.parent.mkdir(parents=True, exist_ok=True)
            os.replace(path, target)
        except OSError:
            pass  # another replica quarantined it first

    # ------------------------------------------------------------------
    # design (ranking) entries
    # ------------------------------------------------------------------

    def _design_path(self, key: str) -> Path:
        return self._env / "designs" / f"{_digest(key)}.pkl"

    def put_design(self, key: str, spec, ranking) -> None:
        """Persist one ranking (write-through on build)."""
        self._write_entry(self._design_path(key), {
            "key": key,
            "spec": spec,
            "ranking": list(ranking),
            "meta": self._meta(),
        })

    def get_design(self, key: str):
        """``(spec, ranking)`` or ``None``; the key echo is verified (a
        digest collision or hand-copied file must not serve the wrong
        design)."""
        entry = self._read_entry(self._design_path(key))
        if entry is None or entry.get("key") != key:
            self.stats.design_misses += 1
            return None
        self.stats.design_hits += 1
        return entry["spec"], entry["ranking"]

    # ------------------------------------------------------------------
    # executable entries
    # ------------------------------------------------------------------

    def _executable_path(self, key: str, signature: str) -> Path:
        return (
            self._env / "executables"
            / f"{_digest(key)}.{_digest(signature, 16)}.pkl"
        )

    def has_executable(self, key: str, signature: str) -> bool:
        """Whether an entry file exists for (runner key, kernel key)
        (undecoded: a cheap check before writing one through)."""
        return self._executable_path(key, signature).is_file()

    def put_executable(
        self, key: str, signature: str, kind: str, blob: bytes,
        device=None, pool_size: int | None = None,
    ) -> None:
        """Persist one kernel library for one runner.

        ``signature`` is the library's kernel key; ``device`` and
        ``pool_size`` are the runner's, recorded in the metadata.
        """
        self._write_entry(self._executable_path(key, signature), {
            "key": key,
            "signature": signature,
            "kind": kind,
            "blob": blob,
            "meta": self._meta(device, pool_size),
        })

    def get_executable(
        self, key: str, signature: str, device=None,
        pool_size: int | None = None,
    ):
        """The loaded :class:`repro_torch.kernels.cuda_build.KernelLib`,
        or ``None``.

        An entry recorded for another compute capability, CUDA version or
        pool size is a miss, never a crash: the caller rebuilds with
        ``nvcc``.  A blob that the dynamic loader refuses although the
        entry matches this environment is corrupt: it is quarantined and
        missed.
        """
        path = self._executable_path(key, signature)
        entry = self._read_entry(path)
        if (
            entry is None
            or entry.get("key") != key
            or entry.get("signature") != signature
            or entry.get("kind") != AOT_KIND
        ):
            self.stats.executable_misses += 1
            return None
        meta = entry.get("meta", {})
        if (
            meta.get("capability") != _capability(device)
            or meta.get("cuda") != torch.version.cuda
            or meta.get("pool_size") != pool_size
        ):
            self.stats.executable_misses += 1
            return None
        try:
            lib = cuda_build.install_library(signature, entry["blob"])
        except OSError:
            self._quarantine(path)
            self.stats.executable_misses += 1
            return None
        self.stats.executable_hits += 1
        return lib

    def _meta(self, device=None, pool_size: int | None = None) -> dict:
        cuda_dev = device is not None and torch.device(device).type == "cuda"
        return {
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "capability": _capability(device),
            "device_name": (torch.cuda.get_device_name(device)
                            if cuda_dev else None),
            "pool_size": pool_size,
            "nvcc": nvcc_release() if cuda_dev else None,
            "schema": SCHEMA_VERSION,
            "aot_kind": AOT_KIND,
            "created": time.time(),
            "pid": os.getpid(),
        }

    # ------------------------------------------------------------------
    # telemetry (KeyStats / BucketStats persistence)
    # ------------------------------------------------------------------

    def _telemetry_path(self) -> Path:
        # legacy single-snapshot location: read (and merged), never written
        return self._env / "telemetry.pkl"

    def _telemetry_dir(self) -> Path:
        return self._env / "telemetry"

    def put_telemetry(self, keys: dict, buckets: dict) -> None:
        """Persist THIS writer's serving counters.

        ``keys`` maps cache key tuples to :class:`KeyStats`-shaped dicts;
        ``buckets`` maps ``(structural, bucket)`` to
        :class:`BucketStats`-shaped dicts.  Each store instance owns one
        file under ``telemetry/`` and replaces it whole; callers whose
        counters were seeded from restored telemetry persist **deltas**
        (:func:`subtract_counters`) so history is counted exactly once.
        """
        if self.readonly:
            return
        self._write_entry(
            self._telemetry_dir() / f"{self._writer_id}.pkl",
            {"keys": dict(keys), "buckets": dict(buckets)},
        )

    def get_telemetry(self) -> dict | None:
        """All writers' counters (legacy snapshot included), merged under
        the monotone-counter policy; ``None`` when nothing is persisted."""
        paths = [self._telemetry_path()]
        tdir = self._telemetry_dir()
        if tdir.is_dir():
            paths += sorted(tdir.glob("*.pkl"))
        merged = None
        for path in paths:
            entry = self._read_entry(path)
            if not isinstance(entry, dict) or "keys" not in entry:
                continue
            if merged is None:
                merged = {"keys": {}, "buckets": {}}
            for section in ("keys", "buckets"):
                for k, d in entry.get(section, {}).items():
                    have = merged[section].get(k)
                    merged[section][k] = (
                        merge_counters(have, d) if have else dict(d)
                    )
        return merged

    # ------------------------------------------------------------------
    # maintenance (the `python -m repro_torch.store` CLI surface)
    # ------------------------------------------------------------------

    def entries(self) -> list[dict]:
        """Decoded summaries of every entry in THIS environment."""
        out = []
        for sub, etype in (("designs", "design"), ("executables",
                                                   "executable")):
            base = self._env / sub
            if not base.is_dir():
                continue
            for path in sorted(base.glob("*.pkl")):
                entry = self._read_entry(path)
                if entry is None:
                    out.append({
                        "type": etype, "file": path.name,
                        "status": "quarantined",
                    })
                    continue
                meta = entry.get("meta", {})
                out.append({
                    "type": etype,
                    "file": path.name,
                    "status": "ok",
                    "key": entry.get("key", "?"),
                    "kind": entry.get("kind"),
                    "bytes": path.stat().st_size if path.exists() else 0,
                    "torch": meta.get("torch"),
                    "cuda": meta.get("cuda"),
                    "capability": meta.get("capability"),
                })
        return out

    def verify(self) -> dict:
        """Decode every entry; corrupt ones are quarantined as a side
        effect.  Returns ``{"ok": n, "quarantined": n, "backlog": n}``:
        ``quarantined`` counts entries quarantined by THIS pass, and
        ``backlog`` the files already in this environment's quarantine
        directory (cleared by :meth:`prune`)."""
        before = self.stats.quarantined
        entries = self.entries()
        ok = sum(1 for e in entries if e["status"] == "ok")
        q = self._env / "quarantine"
        backlog = sum(1 for p in q.iterdir() if p.is_file()) \
            if q.is_dir() else 0
        return {
            "ok": ok,
            "quarantined": self.stats.quarantined - before,
            "backlog": backlog,
        }

    def environments(self) -> list[str]:
        """Every environment directory present under the root."""
        if not self.root.is_dir():
            return []
        return sorted(
            p.name for p in self.root.iterdir()
            if p.is_dir() and p.name.startswith("schema")
        )

    def prune(self, keep_current: bool = True) -> list[str]:
        """Delete stale environments (and always the quarantine of the
        current one).  Returns the removed directory names."""
        removed = []
        for env in self.environments():
            if keep_current and env == self.env_tag:
                q = self.root / env / "quarantine"
                if q.is_dir() and any(q.iterdir()):
                    shutil.rmtree(q, ignore_errors=True)
                    removed.append(f"{env}/quarantine")
                continue
            shutil.rmtree(self.root / env, ignore_errors=True)
            removed.append(env)
        if not self.readonly:
            self._atomic_write(
                self.root / "manifest.json",
                json.dumps({
                    "schema": SCHEMA_VERSION,
                    "environments": self.environments(),
                    "updated": time.time(),
                }, indent=2).encode(),
            )
        return removed


def as_store(store) -> DesignStore | None:
    """Normalize a ``store=`` argument: None, a path, or a DesignStore."""
    if store is None or isinstance(store, DesignStore):
        return store
    return DesignStore(store)
