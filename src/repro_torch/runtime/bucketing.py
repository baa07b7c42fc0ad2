"""Shape bucketing: one compiled design serves a whole family of grid sizes.

PyTorch port of ``repro.runtime.bucketing`` (numpy only), near verbatim.
The in-kernel consumers of the streamed maps are the CUDA tile kernel
(``kernels/csrc/stencil_tile.cuh``, halo-index maps) and the round loop
(``kernels/ops.py::run_rounds``, wrap maps between rounds).


SASA's economics rest on amortizing one expensive artefact (the FPGA
bitstream; here the auto-tuned jitted design) across many invocations.
Compiling one design per *exact* grid shape breaks that the moment traffic
carries heterogeneous geometries.  This module maps a requested grid shape
onto a small ladder of padded canonical **bucket** shapes, so a kernel
registration owns at most a handful of compiled designs (one per bucket
actually hit) instead of one per distinct request shape.

Three pieces:

  * :class:`ShapeBucketer` — the bucket-ladder policy.  By default every
    dimension rounds up to the next power of two (floored at ``min_size``);
    alternatively callers supply an explicit per-dimension ladder of sizes.
    **Trade-off:** a coarser ladder (pure powers of two) means fewer
    compiled designs (less compile time, fewer cached executors) but more
    padded cells per dispatch (wasted FLOPs and HBM traffic up to ~4x for a
    2D grid just past a rung); a finer user ladder caps the padding waste
    at the cost of more designs.  ``max_shape`` bounds the largest bucket
    so one oversized request cannot force a huge compile.

  * the **spec transforms** — :func:`bucket_spec` rewrites a stencil spec
    onto the bucket shape and threads the streamed inputs its boundary
    mode needs (see below); the compiled design is shape-agnostic within
    its bucket, every per-request quantity arrives as data.

  * the **host staging plan** — :func:`bucket_plan` captures everything
    the serving layers need to stage one request into a bucket design:
    where the real grid sits inside the bucket, how the margin is filled,
    which streamed service arrays (mask / halo indices) ride along, and
    which output slice to return.

Boundary rules (docs/DESIGN.md §Boundaries × bucketed serving) — every
mode is bucketable, each by the streaming trick that fits its semantics:

  ``zero``        streamed ``_mask`` input (1 on the real grid, 0 on the
                  padding) multiplied into every stage: padding cells
                  compute ``expr * 0.0 == 0.0``, exactly the zeros an
                  unpadded run reads from its exterior.  Bit-identical.
  ``constant v``  mask-plus-offset form ``expr * m + v * (1 - m)`` with
                  the bucket margin host-padded to ``v``.  Bit-identical.
  ``replicate``   ``_mask`` plus per-dimension streamed **halo-index**
                  inputs: after every stage the shared trapezoid helper
                  gathers each padding cell from its clamped nearest real
                  edge cell (:func:`repro_torch.kernels.blockops.streamed_halo_fixup`),
                  re-creating the clamped exterior in-kernel from
                  per-request data.  Bit-identical: real cells compute
                  ``expr * 1.0`` over identical operand values.
  ``periodic``    **halo-streamed data**: the host lays the wrapped
                  extension of the real grid into a reserved margin of
                  ``iterations * radius`` cells per side
                  (:func:`bucket_margins`), computed from the real shape
                  at pad time.  A stencil commutes with its own periodic
                  extension, so the margin evolves as correct halo data;
                  staleness creeps inward from the bucket edge at
                  ``radius`` per iteration (the whole-run trapezoid
                  argument) and never reaches the real region.  The
                  compiled design is a plain zero-boundary bucket
                  iteration — no wrap machinery, no mask — and the real
                  region is bit-identical to unpadded execution.  On
                  single-device paths the serving layer passes
                  ``wrap_rounds`` (the design's fused depth ``s``), which
                  shrinks the margin to ``s * radius``: streamed
                  per-dimension **wrap maps** re-impose the wrap on the
                  iterate between fused rounds
                  (:func:`repro_torch.kernels.blockops.wrap_round_fixup`), so
                  the margin only has to survive one round.  shard_map
                  designs keep the wide ``iterations * radius`` margin
                  (the re-wrap would need a cross-shard collective; see
                  the TODO in the reference's ``repro.core.distribute``).

Kernels whose padding cells could compute non-finite values (a division
whose divisor interval contains zero: 0/0 or x/0 would survive the mask
multiply as NaN) are rejected at transform time by the static analyzer —
see :func:`repro_torch.core.analysis.require_bucketable`; serve those
exact-shape.  Divisors provably bounded away from zero (constants,
``abs(...) + c``) are admitted.
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Sequence

import numpy as np

from repro_torch.core.analysis import require_bucketable
from repro_torch.core.spec import (
    BinOp,
    Num,
    Ref,
    StencilSpec,
    ZERO_BOUNDARY,
)


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << (max(int(n), 1) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class ShapeBucketer:
    """Maps a requested grid shape to a padded canonical bucket shape.

    ``ladder`` — optional per-dimension rung lists; each dimension resolves
    to its smallest rung >= the requested size (a request exceeding the top
    rung raises).  Without a ladder, each dimension rounds up to the next
    power of two, floored at ``min_size``.  ``max_shape`` (optional) caps
    every bucket dimension; oversized requests raise instead of silently
    compiling an unbounded design.
    """

    ladder: tuple[tuple[int, ...], ...] | None = None
    min_size: int = 8
    max_shape: tuple[int, ...] | None = None

    def __post_init__(self):
        if self.ladder is not None:
            norm = tuple(
                tuple(sorted(int(x) for x in dim)) for dim in self.ladder
            )
            for dim in norm:
                if not dim or any(x < 1 for x in dim):
                    raise ValueError(f"ladder rungs must be >= 1, got {dim}")
            object.__setattr__(self, "ladder", norm)
        if self.max_shape is not None:
            object.__setattr__(
                self, "max_shape", tuple(int(x) for x in self.max_shape)
            )

    def bucket_for(self, shape: Sequence[int]) -> tuple[int, ...]:
        """The canonical bucket shape serving ``shape`` (>= it per dim)."""
        shape = tuple(int(s) for s in shape)
        if any(s < 1 for s in shape):
            raise ValueError(f"grid shape must be positive, got {shape}")
        if self.ladder is not None:
            if len(self.ladder) != len(shape):
                raise ValueError(
                    f"{len(shape)}-D shape {shape} vs "
                    f"{len(self.ladder)}-D bucket ladder"
                )
            bucket = []
            for d, (size, rungs) in enumerate(zip(shape, self.ladder)):
                for rung in rungs:
                    if rung >= size:
                        bucket.append(rung)
                        break
                else:
                    raise ValueError(
                        f"dim {d} size {size} exceeds the bucket ladder's "
                        f"top rung {rungs[-1]}"
                    )
            bucket = tuple(bucket)
        else:
            bucket = tuple(max(next_pow2(s), self.min_size) for s in shape)
        if self.max_shape is not None:
            if len(self.max_shape) != len(bucket):
                raise ValueError(
                    f"{len(bucket)}-D shape {shape} vs "
                    f"{len(self.max_shape)}-D max_shape"
                )
            if any(b > m for b, m in zip(bucket, self.max_shape)):
                raise ValueError(
                    f"shape {shape} buckets to {bucket}, exceeding "
                    f"max_shape {self.max_shape}"
                )
        return bucket


# --------------------------------------------------------------------------
# Spec transforms: re-shape + streamed boundary inputs
# --------------------------------------------------------------------------


def with_shape(spec: StencilSpec, shape: Sequence[int]) -> StencilSpec:
    """The same stencil structure declared on a different grid shape."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != spec.ndim:
        raise ValueError(
            f"spec {spec.name!r} is {spec.ndim}-D, got shape {shape}"
        )
    inputs = {n: (dt, shape) for n, (dt, _) in spec.inputs.items()}
    return dataclasses.replace(spec, inputs=inputs)


def _fresh_name(spec: StencilSpec, base: str, taken=()) -> str:
    """Collision-free streamed-input name for ``spec``."""
    used = set(spec.inputs) | {s.name for s in spec.stages} | set(taken)
    name = base
    while name in used:
        name += "_"
    return name


def mask_input_name(spec: StencilSpec) -> str:
    """Collision-free name for the streamed mask input of ``spec``."""
    return _fresh_name(spec, "_mask")


def halo_index_names(spec: StencilSpec) -> tuple[str, ...]:
    """Collision-free per-dimension streamed halo-index input names."""
    names: list[str] = []
    for d in range(spec.ndim):
        names.append(_fresh_name(spec, f"_bidx{d}", taken=names))
    return tuple(names)


def wrap_index_names(spec: StencilSpec) -> tuple[str, ...]:
    """Collision-free per-dimension streamed wrap-index input names."""
    names: list[str] = []
    for d in range(spec.ndim):
        names.append(_fresh_name(spec, f"_widx{d}", taken=names))
    return tuple(names)


def check_bucketable(spec: StencilSpec) -> None:
    """Deprecated: use :func:`repro_torch.core.analysis.require_bucketable`.

    Historically this refused *any* array reference in a denominator
    syntactically.  The static analyzer's interval domain now proves
    divisors nonzero instead — admitting provably-safe kernels like
    ``x / (abs(y) + 2)`` that the syntactic rule rejected — so this shim
    just delegates and warns.  Raises the same ``ValueError`` family
    (:class:`repro_torch.core.analysis.VerificationError`) for kernels whose
    divisor interval contains zero.
    """
    warnings.warn(
        "check_bucketable is deprecated; use "
        "repro_torch.core.analysis.require_bucketable (interval-based division "
        "safety) instead",
        DeprecationWarning,
        stacklevel=2,
    )
    require_bucketable(spec)


def boundary_fill(spec: StencilSpec) -> float:
    """The value host padding must carry outside the real grid."""
    return spec.boundary.value if spec.boundary.kind == "constant" else 0.0


def bucket_margins(
    spec: StencilSpec,
    iterations: int | None = None,
    wrap_rounds: int | None = None,
) -> tuple[int, ...]:
    """Per-dimension margin a bucket reserves on *each* side of the grid.

    Only ``periodic`` needs one: the wrapped extension is streamed in as
    data and goes stale from the bucket edge inward at ``spec.radius``
    per iteration.  With ``wrap_rounds=None`` (the legacy wide margin)
    the margin covers the whole run (``iterations * radius``); with
    ``wrap_rounds`` set, the executors re-impose the wrap between fused
    rounds from streamed wrap maps, so the margin only has to survive
    one round: ``wrap_rounds * radius``.  All other modes re-impose
    their exterior in-kernel every stage and place the grid at the
    bucket origin.
    """
    if spec.boundary.kind != "periodic":
        return (0,) * spec.ndim
    it = spec.iterations if iterations is None else iterations
    rounds = int(it) if wrap_rounds is None else min(int(wrap_rounds), int(it))
    return (max(rounds, 1) * spec.radius,) * spec.ndim


def padded_request_shape(
    spec: StencilSpec,
    shape: Sequence[int],
    iterations: int | None = None,
    wrap_rounds: int | None = None,
) -> tuple[int, ...]:
    """The shape bucket routing must fit: grid plus both halo margins."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != spec.ndim:
        raise ValueError(
            f"spec {spec.name!r} is {spec.ndim}-D, got shape {shape}"
        )
    margins = bucket_margins(spec, iterations, wrap_rounds)
    return tuple(s + 2 * m for s, m in zip(shape, margins))


def masked_spec(
    spec: StencilSpec, wrap_rounds: int | None = None
) -> StencilSpec:
    """The streamed-boundary spec a bucket design is compiled from.

    ``zero``/``constant`` weave a constant (non-iterated) ``_mask`` input
    into every stage — ``expr * m`` for zero, ``expr * m + v * (1 - m)``
    for constant-``v`` — so every executor re-imposes the real grid's
    exterior at every stage of every fused iteration, in-kernel.

    ``replicate`` additionally threads per-dimension int32 halo-index
    inputs and records them in ``halo_index_inputs``: the shared
    trapezoid helper gathers every padding cell from its clamped nearest
    real edge cell after each stage, *then* the bucket-level replicate
    rule clamps out-of-bucket reads to the (freshly re-imposed) belt —
    so leading edges (always real) and trailing edges both see the
    clamped exterior of the real grid.

    ``periodic`` threads nothing by default: the design is the plain
    zero-boundary iteration of the bucket grid, and the wrapped exterior
    arrives as host-streamed margin data (see :func:`bucket_margins`).
    Masking would zero the evolving halo, so the real region is
    recovered by output slicing instead.  With ``wrap_rounds`` set
    (single-device narrow-margin serving) the spec additionally threads
    per-dimension int32 **wrap-index** inputs and records them (plus the
    round-depth cap) in ``wrap_index_inputs``/``wrap_round_depth``:
    executors re-impose the wrap between fused rounds from the streamed
    maps, so the margin shrinks from ``iterations * radius`` to
    ``wrap_rounds * radius``.

    Raises for kernels no bucket transform can serve (a divisor whose
    value interval contains zero — see
    :func:`repro_torch.core.analysis.require_bucketable`).
    """
    require_bucketable(spec)
    kind = spec.boundary.kind
    if kind != "periodic" and wrap_rounds is not None:
        raise ValueError(
            f"wrap_rounds only applies to periodic boundaries, not "
            f"{kind!r}"
        )
    if kind == "periodic":
        if wrap_rounds is None:
            out = dataclasses.replace(
                spec, name=spec.name + "@halo", boundary=ZERO_BOUNDARY
            )
            out.validate()
            return out
        wrap_rounds = max(int(wrap_rounds), 1)
        widx = wrap_index_names(spec)
        inputs = dict(spec.inputs)
        for n in widx:
            inputs[n] = ("int32", spec.shape)
        out = dataclasses.replace(
            spec, name=spec.name + f"@wrap{wrap_rounds}",
            boundary=ZERO_BOUNDARY, inputs=inputs,
            wrap_index_inputs=widx, wrap_round_depth=wrap_rounds,
        )
        out.validate()
        return out
    mname = mask_input_name(spec)
    mref = Ref(mname, (0,) * spec.ndim)
    fill = boundary_fill(spec)

    def weave(expr):
        masked = BinOp("*", expr, mref)
        if fill == 0.0:
            return masked
        # constant boundary: out-of-grid cells read v, in-grid cells are
        # expr*1 + v*0 (bit-identical to expr up to +0.0)
        return BinOp(
            "+", masked, BinOp("*", Num(fill), BinOp("-", Num(1.0), mref))
        )

    stages = tuple(
        dataclasses.replace(st, expr=weave(st.expr)) for st in spec.stages
    )
    inputs = dict(spec.inputs)
    inputs[mname] = (spec.dtype, spec.shape)
    halo_idx: tuple[str, ...] = ()
    if kind == "replicate":
        halo_idx = halo_index_names(spec)
        for n in halo_idx:
            inputs[n] = ("int32", spec.shape)
    out = dataclasses.replace(
        spec, name=spec.name + "@masked", inputs=inputs, stages=stages,
        halo_index_inputs=halo_idx,
    )
    out.validate()
    return out


def bucket_spec(
    spec: StencilSpec,
    bucket_shape: Sequence[int],
    wrap_rounds: int | None = None,
) -> StencilSpec:
    """The streamed bucket-shaped spec a bucket design is compiled from.

    Per-request fit (grid + margins <= bucket) is validated by the bucket
    runner; the spec's own declared shape only contributes structure here.
    """
    return masked_spec(with_shape(spec, bucket_shape), wrap_rounds)


# --------------------------------------------------------------------------
# Host-side staging plan (numpy: used while staging micro-batches)
# --------------------------------------------------------------------------


def grid_mask_host(
    shape: Sequence[int], bucket_shape: Sequence[int], dtype="float32"
) -> np.ndarray:
    """Bucket-shaped mask: 1 on the leading ``shape`` region, 0 on padding."""
    shape, bucket_shape = tuple(shape), tuple(bucket_shape)
    if len(shape) != len(bucket_shape) or any(
        s > b for s, b in zip(shape, bucket_shape)
    ):
        raise ValueError(f"grid {shape} does not fit bucket {bucket_shape}")
    m = np.zeros(bucket_shape, dtype=np.dtype(dtype))
    m[tuple(slice(0, s) for s in shape)] = 1
    return m


def halo_index_host(
    shape: Sequence[int], bucket_shape: Sequence[int], dim: int
) -> np.ndarray:
    """Bucket-shaped int32 gather-source map for dimension ``dim``.

    Cell value = the global bucket coordinate (along ``dim``) the cell
    copies from under the clamped-edge rule: identity below ``shape[dim]``,
    the last real coordinate beyond it.  A *clamp-form* map — the static
    contract :func:`repro_torch.kernels.blockops.streamed_halo_fixup` lowers to
    slice/select ops instead of a gather.
    """
    shape, bucket_shape = tuple(shape), tuple(bucket_shape)
    idx = np.clip(np.arange(bucket_shape[dim]), 0, shape[dim] - 1)
    view = idx.reshape(
        tuple(-1 if d == dim else 1 for d in range(len(bucket_shape)))
    )
    return np.broadcast_to(view, bucket_shape).astype(np.int32)


def wrap_index_host(
    shape: Sequence[int],
    bucket_shape: Sequence[int],
    margin: int,
    dim: int,
) -> np.ndarray:
    """Bucket-shaped int32 wrap-source map for dimension ``dim``.

    Cell value = the bucket coordinate the cell copies from under the
    periodic rule with the real grid placed at offset ``margin``:
    identity on the real region ``[margin, margin + shape[dim])``,
    wrapped into it (modulo the real size) everywhere else.  Consumed
    between fused rounds by
    :func:`repro_torch.kernels.blockops.wrap_round_fixup` — a modular map, so
    it stays a gather, once per round at grid granularity.
    """
    shape, bucket_shape = tuple(shape), tuple(bucket_shape)
    S = shape[dim]
    idx = margin + ((np.arange(bucket_shape[dim]) - margin) % S)
    view = idx.reshape(
        tuple(-1 if d == dim else 1 for d in range(len(bucket_shape)))
    )
    return np.broadcast_to(view, bucket_shape).astype(np.int32)


def pad_grid(
    a: np.ndarray, bucket_shape: Sequence[int], fill: float = 0.0
) -> np.ndarray:
    """Pad one grid (no batch axis) up to the bucket shape with ``fill``.

    ``fill`` is the spec's boundary value (:func:`boundary_fill`): under a
    constant-``v`` boundary, real edge cells read ``v`` from the bucket
    margin, exactly what an unpadded run reads from its exterior.
    """
    a = np.asarray(a)
    bucket_shape = tuple(bucket_shape)
    if a.ndim != len(bucket_shape) or any(
        s > b for s, b in zip(a.shape, bucket_shape)
    ):
        raise ValueError(
            f"grid shaped {a.shape} does not fit bucket {bucket_shape}"
        )
    if tuple(a.shape) == bucket_shape:
        return a
    return np.pad(
        a, [(0, b - s) for s, b in zip(a.shape, bucket_shape)],
        constant_values=fill,
    )


def pad_batch(
    a: np.ndarray, bucket_shape: Sequence[int], fill: float = 0.0
) -> np.ndarray:
    """Pad a batched array ``(B,) + grid`` up to ``(B,) + bucket``."""
    a = np.asarray(a)
    bucket_shape = tuple(bucket_shape)
    if a.ndim != len(bucket_shape) + 1 or any(
        s > b for s, b in zip(a.shape[1:], bucket_shape)
    ):
        raise ValueError(
            f"batched array shaped {a.shape} does not fit (B,) + "
            f"{bucket_shape}"
        )
    if tuple(a.shape[1:]) == bucket_shape:
        return a
    return np.pad(
        a,
        [(0, 0)] + [(0, b - s) for s, b in zip(a.shape[1:], bucket_shape)],
        constant_values=fill,
    )


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Everything the host needs to stage requests into one bucket design.

    Built once per (spec, bucket, iterations) by :func:`bucket_plan`;
    shared by :func:`repro_torch.runtime.batching.build_bucket_runner` (uniform
    batches) and the server's micro-batch staging (mixed shapes sharing a
    bucket, each entry carrying its own streamed service arrays).
    """

    spec: StencilSpec                 # the request-facing spec
    bucket: tuple[int, ...]
    mspec: StencilSpec                # the compiled-design (streamed) spec
    margins: tuple[int, ...]          # leading placement offset per dim
    mask_name: str | None             # None for periodic (no mask woven)
    halo_idx_names: tuple[str, ...]   # per-dim index inputs (replicate)
    wrap_idx_names: tuple[str, ...] = ()  # per-dim wrap maps (narrow periodic)
    wrap_rounds: int | None = None    # round-depth cap (narrow periodic)
    # per-(grid shape) placement index memo + build/reuse counters: a
    # mixed-shape serving trace replays the same few shapes thousands of
    # times and must not rebuild bucket-length index vectors per entry
    # (and the batched/unbatched call sites must share one memo — only
    # the batch slot differs).  Excluded from eq/hash/repr.
    _place_index_cache: dict = dataclasses.field(
        default_factory=dict, compare=False, repr=False
    )
    _place_stats: dict = dataclasses.field(
        default_factory=lambda: {"builds": 0, "reuses": 0},
        compare=False, repr=False,
    )

    @property
    def fill(self) -> float:
        return boundary_fill(self.spec)

    @property
    def service_names(self) -> tuple[str, ...]:
        """The streamed non-data inputs of the bucket design, in order."""
        names = () if self.mask_name is None else (self.mask_name,)
        return names + self.halo_idx_names + self.wrap_idx_names

    @property
    def place_index_builds(self) -> int:
        return self._place_stats["builds"]

    @property
    def place_index_reuses(self) -> int:
        return self._place_stats["reuses"]

    def validate_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """Check a request grid (plus its halo margins) fits the bucket."""
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(self.bucket) or any(
            s + 2 * m > b
            for s, m, b in zip(shape, self.margins, self.bucket)
        ):
            need = tuple(
                s + 2 * m for s, m in zip(shape, self.margins)
            ) if len(shape) == len(self.bucket) else shape
            raise ValueError(
                f"grid shaped {shape} (with halo margins: {need}) does "
                f"not fit bucket {self.bucket}"
            )
        return shape

    def out_index(self, shape: Sequence[int]) -> tuple[slice, ...]:
        """Slice of the bucket output holding the real grid's results."""
        return tuple(
            slice(m, m + s) for m, s in zip(self.margins, shape)
        )

    def place_entry(self, a: np.ndarray, batched: bool = False) -> np.ndarray:
        """Lay one grid (or ``(B,) + grid``) into the bucket shape.

        zero/constant fill the trailing margin with the boundary value;
        replicate extends the clamped edge (the correct exterior at t=0);
        periodic streams the wrapped extension into both margins — the
        per-request halo data the compiled design consumes.
        """
        a = np.asarray(a)
        off = 1 if batched else 0
        if a.ndim != len(self.bucket) + off:
            raise ValueError(
                f"array shaped {a.shape} does not fit "
                f"{'(B,) + ' if batched else ''}{self.bucket}"
            )
        self.validate_shape(a.shape[off:])
        kind = self.spec.boundary.kind
        if kind in ("zero", "constant"):
            pads = [(0, 0)] * off + [
                (0, b - s) for s, b in zip(a.shape[off:], self.bucket)
            ]
            if tuple(a.shape[off:]) == self.bucket:
                return a
            return np.pad(a, pads, constant_values=self.fill)
        for d, idx in enumerate(self._place_indices(tuple(a.shape[off:]))):
            if idx is not None:
                a = np.take(a, idx, axis=d + off)
        return a

    def _place_indices(
        self, shape: tuple[int, ...]
    ) -> tuple[np.ndarray | None, ...]:
        """Per-dimension placement index vectors for one grid shape,
        memoized per plan (``None`` marks a full-size dim needing no
        take).  Pure function of (shape, boundary mode); batched and
        unbatched placements of the same grid hit the same entry."""
        hit = self._place_index_cache.get(shape)
        if hit is not None:
            self._place_stats["reuses"] += 1
            return hit
        kind = self.spec.boundary.kind
        out: list[np.ndarray | None] = []
        for d, b in enumerate(self.bucket):
            s = shape[d]
            if s == b:
                out.append(None)
            elif kind == "replicate":
                out.append(np.clip(np.arange(b), 0, s - 1))
            else:  # periodic: wrapped extension around the placed grid
                out.append((np.arange(b) - self.margins[d]) % s)
        entry = tuple(out)
        self._place_index_cache[shape] = entry
        self._place_stats["builds"] += 1
        return entry

    def service_entry(self, shape: Sequence[int]) -> dict[str, np.ndarray]:
        """The streamed service arrays (mask / halo indices) for one grid.

        Pure functions of ``(plan, shape)``, so they are memoized: a
        serving trace replaying the same few shapes thousands of times
        must not rebuild bucket-sized masks and index maps per request.
        Callers stack or broadcast the returned arrays — never mutate
        them in place.
        """
        return _service_entry_cached(self, self.validate_shape(shape))

    def service_filler(self) -> dict[str, np.ndarray]:
        """Service arrays for throwaway batch-padding entries.

        An all-zero mask makes a padding entry's output the boundary
        constant everywhere (discarded by the caller); zero halo indices
        gather every cell from the bucket origin — finite, discarded.
        """
        out: dict[str, np.ndarray] = {}
        if self.mask_name is not None:
            dt = self.mspec.inputs[self.mask_name][0]
            out[self.mask_name] = np.zeros(self.bucket, np.dtype(dt))
        for name in self.halo_idx_names + self.wrap_idx_names:
            out[name] = np.zeros(self.bucket, np.int32)
        return out

    def filler_entry(self, name: str) -> np.ndarray:
        """A throwaway data grid for batch padding (boundary fill value)."""
        dt = self.spec.inputs[name][0]
        return np.full(self.bucket, self.fill, np.dtype(dt))


@functools.lru_cache(maxsize=512)
def _service_entry_cached(
    plan: BucketPlan, shape: tuple[int, ...]
) -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    if plan.mask_name is not None:
        out[plan.mask_name] = grid_mask_host(
            shape, plan.bucket, plan.mspec.inputs[plan.mask_name][0]
        )
    for d, name in enumerate(plan.halo_idx_names):
        out[name] = halo_index_host(shape, plan.bucket, d)
    for d, name in enumerate(plan.wrap_idx_names):
        out[name] = wrap_index_host(shape, plan.bucket, plan.margins[d], d)
    return out


def bucket_plan(
    spec: StencilSpec,
    bucket_shape: Sequence[int],
    iterations: int | None = None,
    wrap_rounds: int | None = None,
) -> BucketPlan:
    """Build the host staging plan for ``spec`` served from ``bucket_shape``.

    ``wrap_rounds`` (periodic only) switches the design to the
    narrow-margin streamed-wrap form: the margin shrinks to
    ``wrap_rounds * radius`` and per-dimension wrap maps join the
    streamed service inputs (single-device executors only — see
    :func:`masked_spec`).
    """
    bucket = tuple(int(b) for b in bucket_shape)
    if spec.boundary.kind != "periodic":
        wrap_rounds = None
    mspec = bucket_spec(spec, bucket, wrap_rounds)
    kind = spec.boundary.kind
    return BucketPlan(
        spec=spec,
        bucket=bucket,
        mspec=mspec,
        margins=bucket_margins(spec, iterations, wrap_rounds),
        mask_name=None if kind == "periodic" else mask_input_name(spec),
        halo_idx_names=mspec.halo_index_inputs,
        wrap_idx_names=mspec.wrap_index_inputs,
        wrap_rounds=wrap_rounds,
    )
