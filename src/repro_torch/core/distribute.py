"""Multi-device stencil execution: the five SASA parallelisms over a device pool.

PyTorch port of ``repro.core.distribute``.  The reference is one
``jit(shard_map(...))`` program over a 1-D device mesh, driven by one
process.  The port keeps that single-controller model over a **pool**: a
list of ``torch.device`` s in one process, in which a device may repeat.

  * Placement: shard ``i`` is a tensor on ``pool[i]``.
  * ``ppermute``: a halo exchange is ``rows.to(pool[j], non_blocking=True)``.
    Between two cards that is a peer copy, which PyTorch orders after the
    source's work by events on both devices' streams (no host sync); on a
    pool that repeats one card the rows stay where they are, and the
    concatenation that builds the extended shard copies them, on the
    card's current stream.
  * ``psum``: the temporal pipeline's broadcast.  Only the last live stage
    contributes, so the sum is that stage's output, copied to every device.

The variants (Sec. 3 of the paper; ``r`` is the spec's radius):

  temporal    row tiles stream through the pool; device j applies iteration
              j of each round of up to k iterations (T + k - 1 steps).
  spatial_r   one up-front exchange of it*r rows, then a local trapezoid.
  spatial_s   an r-row exchange every iteration.
  hybrid_r    the up-front it*r exchange, then rounds of s fused iterations.
  hybrid_s    an s*r-row exchange per round of s fused iterations.

Every shard computes through
:func:`repro_torch.kernels.blockops.fused_iterations_on_block` with its
global row origin, as the reference's local programs do.  The reference
reaches no Pallas kernel on this path, and the port reaches no CUDA
kernel: runners say so with ``path == "shard_map"`` and
``backend == "torch"``.

Boundaries.  zero: edge shards receive zeros.  periodic: the exchange
closes into a ring (device 0 <-> device k-1).  constant and replicate: the
per-stage fixup in global coordinates.  The non-row axes are resident in
full on every shard and carry a boundary belt filled from the shard's own
columns before every block call (:func:`_with_col_belt`): ``r`` cells deep
for constant and replicate, whose fixup re-imposes it after every stage,
and ``step * r`` deep for periodic, whose wrapped cells arrive as data and
go stale under the trapezoid (the port's tile body treats every axis as
the reference treats rows; see :mod:`repro_torch.kernels.blockops`).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.model import ParallelismConfig
from repro_torch.core.spec import StencilSpec
from repro_torch.kernels.blockops import (
    boundary_pad,
    fused_iterations_on_block,
    torch_dtype,
)
from repro_torch.kernels.ops import resolve_pool


@dataclasses.dataclass
class Mesh:
    """A 1-D pool of devices, and the halo bytes its exchanges moved.

    ``moved_bytes`` counts the bytes handed from one shard to another
    (on a pool that repeats a card they do not leave it).
    """

    devices: list[torch.device]
    ndim: int             # grid axes; the row axis leads the trailing ndim
    moved_bytes: int = 0

    @property
    def k(self) -> int:
        return len(self.devices)

    def send(self, t: torch.Tensor, src: int, dst: int) -> torch.Tensor:
        """Shard ``src``'s tensor ``t`` delivered to shard ``dst``."""
        if src != dst:
            self.moved_bytes += t.numel() * t.element_size()
        return t.to(self.devices[dst], non_blocking=True)


def _rows(a: torch.Tensor, start, stop, nd: int) -> torch.Tensor:
    """Rows ``start:stop`` of a (possibly batched) grid-shaped tensor."""
    return a[(Ellipsis, slice(start, stop)) + (slice(None),) * (nd - 1)]


def _zero_rows(a: torch.Tensor, h: int, nd: int) -> torch.Tensor:
    shape = list(a.shape)
    shape[a.dim() - nd] = h
    return a.new_zeros(shape)


def _pad_rows(a: torch.Tensor, lo: int, hi: int, nd: int) -> torch.Tensor:
    if not lo and not hi:
        return a
    return torch.cat(
        [_zero_rows(a, lo, nd), a, _zero_rows(a, hi, nd)], dim=a.dim() - nd
    )


# --------------------------------------------------------------------------
# Halo exchange primitives (the "border streaming" wires)
# --------------------------------------------------------------------------


def exchange_halo(shards, h: int, mesh: Mesh, wrap: bool = False):
    """Return ``[(up_halo, down_halo)]`` per shard: ``h`` rows from the
    previous / next shard.

    With ``wrap=False`` edge shards receive zeros (the exterior-zero
    boundary; padded-row shards are handled by the boundary fixup too).
    With ``wrap=True`` the exchange closes into a ring: shard 0 receives
    shard k-1's bottom rows and vice versa; on a pool of one the ring
    degenerates to the shard's own opposite edge.
    """
    k, nd = mesh.k, mesh.ndim
    out = []
    for i, local in enumerate(shards):
        if h == 0 or (k == 1 and not wrap):
            zeros = _zero_rows(local, h, nd)
            out.append((zeros, zeros))
            continue
        if k == 1:
            out.append((_rows(local, -h, None, nd), _rows(local, 0, h, nd)))
            continue
        up_i, down_i = i - 1, i + 1
        if wrap:
            up_i, down_i = up_i % k, down_i % k
        up = (mesh.send(_rows(shards[up_i], -h, None, nd), up_i, i)
              if up_i >= 0 else _zero_rows(local, h, nd))
        down = (mesh.send(_rows(shards[down_i], 0, h, nd), down_i, i)
                if down_i < k else _zero_rows(local, h, nd))
        out.append((up, down))
    return out


def _extend(shards, h: int, mesh: Mesh, wrap: bool = False):
    """Every shard with ``h`` halo rows from its neighbours on each side."""
    axis = shards[0].dim() - mesh.ndim
    return [
        torch.cat([up, a, down], dim=axis)
        for a, (up, down) in zip(shards, exchange_halo(shards, h, mesh, wrap))
    ]


def _with_col_belt(spec: StencilSpec):
    """The block call of every local program: ``call(env, step, row0)``
    runs ``step`` fused iterations over a row band that holds every column.

    Non-zero boundaries pad the band's columns with the boundary rule's
    belt first (edge, wrap or constant of the shard's own columns equals
    the global rule) and slice it off after: ``r`` deep for constant and
    replicate, which the per-stage fixup keeps current, ``step * r`` for
    periodic, whose wrapped columns are data that goes stale.
    """
    nd, r, boundary = spec.ndim, spec.radius, spec.boundary
    grid_shape = spec.shape

    def call(env: Mapping[str, torch.Tensor], step: int, row0: int):
        q = 0 if boundary.is_zero else (
            step * r if boundary.kind == "periodic" else r
        )
        if q:
            env = {
                n: boundary_pad(a, [(q, q)] * (nd - 1), boundary)
                for n, a in env.items()
            }
        out = fused_iterations_on_block(
            spec, env, step, (row0,) + (-q,) * (nd - 1), grid_shape
        )
        if not q:
            return out
        return out[(Ellipsis, slice(None)) + tuple(
            slice(q, q + c) for c in grid_shape[1:]
        )]

    return call


def block_call_work(spec: StencilSpec, step: int) -> tuple[int, int]:
    """What one block call of ``step`` fused iterations runs, for the
    ranker (:func:`repro_torch.core.model.predict_gpu`): the operators
    that launch a kernel (all but views; eager torch launches one kernel
    per operator on a card) and, of those, the passes over the whole band
    (an output at least the band's size).  Neither depends on the grid's
    size, so they are counted once per spec structure and depth, by
    running the block call on the CPU over a small band.
    """
    small = (8,) + (6,) * (spec.ndim - 1)
    return _count_block_call(
        dataclasses.replace(
            spec, inputs={n: (dt, small) for n, (dt, _) in spec.inputs.items()}
        ),
        step,
    )


@functools.lru_cache(maxsize=256)
def _count_block_call(spec: StencilSpec, step: int) -> tuple[int, int]:
    from torch.utils._python_dispatch import TorchDispatchMode

    band = (2 * step * spec.radius + spec.rows,) + tuple(spec.shape[1:])
    env = {n: torch.zeros(band, dtype=torch_dtype(dt))
           for n, (dt, _) in spec.inputs.items()}
    cells = math.prod(band)
    counts = [0, 0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view:
                counts[0] += 1
                counts[1] += isinstance(out, torch.Tensor) and out.numel() >= cells
            return out

    with Count():
        _with_col_belt(spec)(env, step, -step * spec.radius)
    return counts[0], counts[1]


# --------------------------------------------------------------------------
# Local programs: each maps the shards' arrays to the shards' results
# --------------------------------------------------------------------------


def _split(parts, name):
    return [p[name] for p in parts]


def _spatial_s_local(spec, iterations, R_k, wrap, mesh, call):
    r, nd, it_name = spec.radius, spec.ndim, spec.iterate_input

    def fn(parts):
        consts = {
            n: _extend(_split(parts, n), r, mesh, wrap)
            for n in spec.inputs if n != it_name
        }
        cur = _split(parts, it_name)
        for _ in range(iterations):
            ext = _extend(cur, r, mesh, wrap)
            cur = [
                _rows(call(
                    {**{n: c[i] for n, c in consts.items()}, it_name: ext[i]},
                    1, i * R_k - r,
                ), r, r + R_k, nd)
                for i in range(mesh.k)
            ]
        return cur

    return fn


def _spatial_r_local(spec, iterations, R_k, wrap, mesh, call):
    r, nd, it_name = spec.radius, spec.ndim, spec.iterate_input
    H = min(iterations * r, R_k)

    def fn(parts):
        ext = {n: _extend(_split(parts, n), H, mesh, wrap) for n in spec.inputs}
        cur = ext[it_name]
        # one HBM round trip per iteration (faithful Spatial_R: the fused
        # trapezoid depth is 1; the halo just shrinks by r per iteration)
        for _ in range(iterations):
            cur = [
                call({**{n: e[i] for n, e in ext.items()}, it_name: cur[i]},
                     1, i * R_k - H)
                for i in range(mesh.k)
            ]
        return [_rows(c, H, H + R_k, nd) for c in cur]

    return fn


def _hybrid_local(spec, iterations, R_k, s, streaming, wrap, mesh, call):
    """hybrid_s (streaming=True): exchange s*r rows per round.
    hybrid_r (streaming=False): exchange iter*r rows once, then rounds."""
    r, nd, it_name = spec.radius, spec.ndim, spec.iterate_input

    def fn(parts):
        if streaming:
            cur = _split(parts, it_name)
            left = iterations
            while left > 0:
                step = min(s, left)
                h = step * r
                ext = {
                    n: _extend(_split(parts, n), h, mesh, wrap)
                    for n in spec.inputs if n != it_name
                }
                ext[it_name] = _extend(cur, h, mesh, wrap)
                cur = [
                    _rows(call({n: e[i] for n, e in ext.items()},
                               step, i * R_k - h), h, h + R_k, nd)
                    for i in range(mesh.k)
                ]
                left -= step
            return cur
        # hybrid_r: single up-front exchange of the full run's halo
        H = min(iterations * r, R_k)
        ext = {n: _extend(_split(parts, n), H, mesh, wrap) for n in spec.inputs}
        cur = ext[it_name]
        left = iterations
        while left > 0:
            step = min(s, left)
            cur = [
                call({**{n: e[i] for n, e in ext.items()}, it_name: cur[i]},
                     step, i * R_k - H)
                for i in range(mesh.k)
            ]
            left -= step
        return [_rows(c, H, H + R_k, nd) for c in cur]

    return fn


def _temporal_pipeline_local(spec, iterations, tile_rows, mesh, call):
    """SODA-analogue temporal pipeline: row tiles stream through the pool,
    device j applies stencil iteration j of the current round.

    Per round of up to k iterations the loop runs T + k - 1 steps (the
    paper's d*(s_t-1) pipeline-fill delay, Eq. 4); at step n device j
    holds tile ``n - j``.  Input is replicated (one logical HBM); only the
    last live stage commits its tile's centre, and its output is then
    broadcast.  Stages past the last live one (a short last round) would
    pass tiles through that nothing commits, and steps whose tile index
    lies outside the grid compute what nothing commits; the port runs
    neither.
    """
    r, nd, it_name = spec.radius, spec.ndim, spec.iterate_input
    k = mesh.k
    h = k * r
    R = spec.rows
    T = math.ceil(R / tile_rows)
    boundary = spec.boundary
    window = tile_rows + 2 * h

    def _row_pad(a):
        """Boundary halo around the real rows, then the tile-alignment
        zeros: the fill is laid against row ``R``, not ``R_pad``."""
        extra = a.shape[a.dim() - nd] - R
        if boundary.is_zero:
            return _pad_rows(a, h, h + extra, nd)
        padded = boundary_pad(
            _rows(a, 0, R, nd), [(h, h)] + [(0, 0)] * (nd - 1), boundary
        )
        return _pad_rows(padded, 0, extra, nd)

    def one_round(parts, active: int):
        last = active - 1
        padded = _row_pad(parts[0][it_name])   # stage 0 ingests from "HBM"
        consts = [
            {n: _row_pad(a) for n, a in parts[j].items() if n != it_name}
            for j in range(active)
        ]
        out = torch.zeros_like(parts[last][it_name])
        bufs = [None] * k
        for n in range(T + k - 1):
            nxt = [None] * k
            for j in range(active):
                t_idx = n - j
                if not 0 <= t_idx < T:
                    continue
                start = t_idx * tile_rows
                buf = (_rows(padded, start, start + window, nd) if j == 0
                       else bufs[j])
                env = {
                    name: _rows(a, start, start + window, nd)
                    for name, a in consts[j].items()
                }
                env[it_name] = buf
                applied = call(env, 1, start - h)
                if j == last:
                    # the last live stage commits the tile's valid centre
                    _rows(out, start, start + tile_rows, nd).copy_(
                        _rows(applied, h, h + tile_rows, nd)
                    )
                else:
                    nxt[j + 1] = mesh.send(applied, j, j + 1)
            bufs = nxt
        return [mesh.send(out, last, j) for j in range(k)]

    def fn(parts):
        cur = _split(parts, it_name)
        left = iterations
        while left > 0:
            active = min(k, left)
            cur = one_round(
                [{**p, it_name: c} for p, c in zip(parts, cur)], active
            )
            left -= active
        return cur

    return fn


# --------------------------------------------------------------------------
# Public entry point: build_runner
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ShardPending:
    """A dispatched run: every shard's result and an event per card."""

    shards: list
    events: list


def build_runner(
    spec: StencilSpec,
    cfg: ParallelismConfig,
    iterations: int | None = None,
    devices=None,
    tile_rows: int = 64,
    batched: bool = False,
):
    """Build a multi-device runner for a parallelism configuration.

    ``devices`` is the pool, used whole (a device may repeat); with none
    given, the first ``cfg.devices_needed`` visible CUDA devices (and a
    :class:`RuntimeError` without CUDA).  ``tile_rows`` is the temporal
    pipeline's row tile.  ``run(arrays) -> np.ndarray`` places inputs
    shard by shard, executes, and gathers.

    With ``batched=True`` the runner takes ``(B,) + spec.shape`` arrays
    and evaluates B independent grids per dispatch: every local program
    carries the batch as a leading axis, rows stay sharded, and
    ``cfg.batch_tile`` (when it divides a larger batch) runs the batch in
    sequential chunks of that many entries.

    The runner exposes ``stage`` / ``dispatch`` / ``ready`` / ``finalize``
    and the attributes of the port's other runners (``.path`` is
    "shard_map", ``.backend`` "torch", ``.device`` the pool's first,
    ``.n_devices`` the pool's size, ``.devices_requested``
    ``cfg.devices_needed``, ``.degraded`` whether the pool is smaller,
    ``.tile`` None), plus ``.mesh``, ``.R_pad`` and ``.halo_bytes`` (bytes
    the last dispatch's exchanges moved between shards).
    """
    it = spec.iterations if iterations is None else iterations
    if spec.wrap_index_inputs:
        # re-imposing a streamed wrap margin between rounds needs the wrap
        # source rows of the opposite shard; shard designs keep the wide
        # iterations*radius periodic margin (the reference's refusal)
        raise ValueError(
            "streamed wrap margins (wrap_index_inputs) are single-device "
            "only; shard_map designs require the wide periodic margin"
        )
    if devices is None:
        pool = resolve_pool()[:cfg.devices_needed]
    else:
        pool = resolve_pool(devices)
    k = len(pool)
    nd = spec.ndim
    mesh = Mesh(pool, nd)
    R = spec.rows
    wrap = spec.boundary.kind == "periodic"
    call = _with_col_belt(spec)

    replicated = cfg.variant == "temporal"
    if replicated:
        R_pad = math.ceil(R / tile_rows) * tile_rows
        R_k = R_pad
        local = _temporal_pipeline_local(spec, it, tile_rows, mesh, call)
    else:
        R_pad = math.ceil(R / k) * k
        R_k = R_pad // k
        if cfg.variant in ("spatial_r", "hybrid_r") and it * spec.radius > R_k:
            raise ValueError(
                f"{cfg.variant} needs iter*r <= rows/device "
                f"({it}*{spec.radius} > {R_k}); the auto-tuner excludes "
                "such configs (halo would span multiple neighbours)"
            )
        if wrap and R_pad != R:
            raise ValueError(
                f"periodic boundary needs rows divisible by the spatial "
                f"degree ({R} rows over k={k} devices leaves "
                f"{R_pad - R} padding rows that would break the "
                "wraparound halo adjacency); the auto-tuner falls back to "
                "the next candidate"
            )
        if spec.boundary.kind == "replicate" and (k - 1) * R_k > R - 1:
            raise ValueError(
                f"replicate boundary needs every device to own at least "
                f"one real grid row ({R} rows over k={k} devices leaves "
                "an all-padding shard that cannot clamp to the edge); "
                "the auto-tuner falls back to the next candidate"
            )
        s = max(cfg.s, 1)
        if cfg.variant == "spatial_s":
            local = _spatial_s_local(spec, it, R_k, wrap, mesh, call)
        elif cfg.variant == "spatial_r":
            local = _spatial_r_local(spec, it, R_k, wrap, mesh, call)
        elif cfg.variant == "hybrid_s":
            local = _hybrid_local(spec, it, R_k, s, True, wrap, mesh, call)
        elif cfg.variant == "hybrid_r":
            local = _hybrid_local(spec, it, R_k, s, False, wrap, mesh, call)
        else:
            raise ValueError(cfg.variant)

    bt = cfg.batch_tile

    def program(parts):
        B = next(iter(parts[0].values())).shape[0] if batched else 0
        if not (bt and B > bt and B % bt == 0):
            return local(parts)
        # the batch in sequential chunks of batch_tile entries
        chunks = [
            local([{n: a[c:c + bt] for n, a in p.items()} for p in parts])
            for c in range(0, B, bt)
        ]
        return [torch.cat(pieces) for pieces in zip(*chunks)]

    def stage(arrays_host: Mapping[str, object]) -> list[dict]:
        parts = [{} for _ in pool]
        for n, (dt, _) in spec.inputs.items():
            a = arrays_host[n]
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
                np.require(a, requirements="CW")   # broadcast views copy
            )
            t = _pad_rows(t.to(torch_dtype(dt)), 0, R_pad - R, nd)
            placed = {}
            for i, dev in enumerate(pool):
                if replicated and dev in placed:
                    parts[i][n] = placed[dev]   # one copy per card
                    continue
                piece = t if replicated else _rows(t, i * R_k, (i + 1) * R_k, nd)
                if dev.type == "cuda" and piece.device.type == "cpu":
                    piece = piece.contiguous().pin_memory()
                parts[i][n] = placed[dev] = piece.to(
                    dev, non_blocking=True
                ).contiguous()
        return parts

    def dispatch(staged) -> ShardPending:
        mesh.moved_bytes = 0
        out = program(staged)
        run.halo_bytes = mesh.moved_bytes
        events = []
        for dev in dict.fromkeys(pool):
            if dev.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                events.append(ev)
        return ShardPending(out, events)

    def ready(pending: ShardPending) -> bool:
        return all(ev.query() for ev in pending.events)

    def finalize(pending: ShardPending) -> np.ndarray:
        for ev in pending.events:
            ev.synchronize()
        shards = pending.shards[:1] if replicated else pending.shards
        out = torch.cat([o.cpu() for o in shards], dim=shards[0].dim() - nd)
        if out.dtype == torch.bfloat16:
            out = out.float()
        return _rows(out, 0, R, nd).numpy()

    def run(arrays_host: Mapping[str, object]) -> np.ndarray:
        return finalize(dispatch(stage(arrays_host)))

    run.spec = spec
    run.cfg = cfg
    run.iterations = it
    run.path = "shard_map"
    run.backend = "torch"
    run.device = pool[0]
    run.devices = pool
    run.n_devices = k
    run.devices_requested = cfg.devices_needed
    run.degraded = k < cfg.devices_needed
    run.tile = None
    run.mesh = mesh
    run.R_pad = R_pad
    run.batched = batched
    run.halo_bytes = 0
    run.stage = stage
    run.dispatch = dispatch
    run.ready = ready
    run.finalize = finalize
    return run
