"""Static verification of stencil specs: diagnostics before any build.

PyTorch port of ``repro.core.analysis`` (pure Python).  It departs from
the reference in one place: SASA401 reports candidates whose thread
block needs more shared memory than the card gives a block (the H100
ranker's analogue of the TPU's VMEM budget).


SASA's premise is that design validity and performance are decided
*statically* — the framework analyzes the DSL and rejects or ranks
configurations before any hardware build (paper §4–5).  This module is
that front door for the reproduction: a pass suite over the (lowered)
stencil IR returning structured :class:`Diagnostic` objects with stable
codes, severities, and source spans pointing back into the DSL text.

Code families (see ``DIAGNOSTIC_CODES`` for the full table, mirrored in
docs/DESIGN.md §Static verification):

  ``SASA1xx``  parse errors (lexical, expression syntax, declarations)
  ``SASA2xx``  semantic errors and dataflow hygiene (unknown arrays,
               dead stages, unused inputs, single-use bindings)
  ``SASA3xx``  feasibility (division safety, periodic divisibility,
               replicate row ownership, wrap-spec sharding, margins)
  ``SASA4xx``  performance warnings (shared-memory overflow, redundant
               iteration, loop-invariant recomputation)

Analyses:

  * **Footprint/halo inference** (:func:`spec_footprint`) — a use-def
    traversal through ``Let``/``Var`` computes per-stage, per-input tap
    bounding boxes, composes them across stages (Minkowski sum per
    path, union hull across paths) and across iterations, and proves
    the bucket margin (``rounds * radius`` per side) and shard
    halo-exchange depth sufficient for each boundary mode.  Per-dim
    interval extremes compose exactly (the max of a Minkowski sum is
    the sum of the maxes), so the inferred bounding box equals the
    empirically observed blast radius — tests/test_analysis.py checks
    this against the pure-numpy oracle by NaN perturbation.
  * **Interval-domain division safety** (:func:`division_diagnostics`)
    — divisors are evaluated over value intervals (constants exact,
    streamed data unbounded, stage values widened by the mask-weave
    fill in bucketed modes); a divisor interval excluding zero is a
    proof the kernel is safe to bucket-serve, replacing the old
    syntactic refusal with a verdict that admits e.g.
    ``x / (abs(y) + 2)``.
  * **Dataflow hygiene** (:func:`hygiene_diagnostics`) — dead local
    stages, unused inputs, single-use ``Let`` bindings,
    iteration-invariant subexpressions recomputed every iteration.
  * **Feasibility preflight** (:func:`preflight`) — every
    :class:`ParallelismConfig` candidate is classified
    feasible/infeasible-with-reason by mirroring the runtime guards in
    the reference's ``repro.core.distribute.build_runner``, so the auto-tuner's
    retry loop consumes a precomputed verdict table instead of
    rediscovering failures via ``ValueError``.

Entry points: :func:`verify` (spec -> diagnostics), :func:`verify_or_raise`
(raises :class:`VerificationError` on error severity), :func:`lint_text`
(DSL text -> diagnostics, mapping parser errors to SASA1xx/SASA2xx), and
:func:`require_bucketable` (the analyzer-backed replacement for the old
``check_bucketable``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Mapping, Sequence

from repro_torch.core.spec import (
    BinOp,
    Call,
    Expr,
    Let,
    Neg,
    Num,
    Ref,
    SourceSpan,
    Stage,
    StencilSpec,
    Var,
    count_ops,
    refs_in,
)

# --------------------------------------------------------------------------
# Diagnostics
# --------------------------------------------------------------------------

SEVERITIES = ("error", "warning", "info")
_SEV_ORDER = {s: i for i, s in enumerate(SEVERITIES)}

#: Stable code registry.  Codes are API: tests, CI lint output, and user
#: suppressions key on them, so a code is never renumbered or reused.
DIAGNOSTIC_CODES: dict[str, str] = {
    # -- SASA1xx: parse --------------------------------------------------
    "SASA100": "generic parse error",
    "SASA101": "unrecognized token",
    "SASA102": "malformed expression",
    "SASA103": "bad tap offset (non-integer or wrong arity)",
    "SASA104": "malformed declaration line",
    "SASA105": "bad header value (iteration / boundary / dtype / iterate)",
    "SASA106": "missing or duplicated section",
    "SASA107": "duplicate or shadowing declaration",
    # -- SASA2xx: semantic / dataflow hygiene ----------------------------
    "SASA200": "generic semantic error",
    "SASA201": "reference to unknown array",
    "SASA202": "tap arity does not match the grid rank",
    "SASA203": "unbound Let variable",
    "SASA210": "dead local stage (never reaches the output)",
    "SASA211": "unused input",
    "SASA212": "single-use Let binding",
    # -- SASA3xx: feasibility --------------------------------------------
    "SASA301": "divisor interval contains zero (not bucket-safe)",
    "SASA302": "periodic boundary: rows not divisible by spatial degree",
    "SASA303": "replicate boundary: a shard would own no real row",
    "SASA304": "streamed wrap margin is single-device only",
    "SASA305": "iter*radius exceeds rows per device for *_r variants",
    "SASA306": "no feasible parallelism candidate",
    "SASA307": "bucket margin smaller than the staleness depth",
    "SASA308": "candidate refused at build time (unpredicted by preflight)",
    # -- SASA4xx: performance --------------------------------------------
    "SASA401": "candidate schedules more shared memory per block than the card allows",
    "SASA402": "iterations > 1 but the output never reads the iterate",
    "SASA403": "iteration-invariant subexpression recomputed per iteration",
    # -- SASA5xx: certified numerics (repro_torch.core.numerics) ----------------
    "SASA500": "certified rounding-error bound (informational)",
    "SASA501": "value envelope may overflow the dtype's finite range",
    "SASA502": "harmful cancellation amplifies accumulated rounding error",
    "SASA503": "ill-conditioned divisor amplifies rounding error",
    "SASA510": "accumulated error bound exceeds dtype-meaningful precision",
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding of the static analyzer.

    ``span`` points into the DSL text the spec was parsed from (None for
    hand-built specs); ``stage`` names the stage the finding concerns,
    when there is one.
    """

    code: str
    severity: str  # one of SEVERITIES
    message: str
    span: SourceSpan | None = None
    stage: str | None = None

    def __post_init__(self):
        assert self.severity in SEVERITIES, self.severity
        assert self.code in DIAGNOSTIC_CODES, self.code

    @property
    def is_error(self) -> bool:
        return self.severity == "error"

    def format(self, source: str | None = None) -> str:
        """Render ``file:line:col severity[CODE]: message`` plus, when the
        DSL source is at hand, the offending line with a caret column."""
        loc = f"{self.span} " if self.span else ""
        head = f"{loc}{self.severity}[{self.code}]: {self.message}"
        if source is None or self.span is None:
            return head
        lines = source.splitlines()
        if not 1 <= self.span.line <= len(lines):
            return head
        text = lines[self.span.line - 1]
        width = max(self.span.end_col - self.span.col, 1)
        caret = " " * (self.span.col - 1) + "^" * min(
            width, max(len(text) - self.span.col + 1, 1)
        )
        return f"{head}\n  {text}\n  {caret}"


def sort_diagnostics(diags: Iterable[Diagnostic]) -> list[Diagnostic]:
    """Errors first, then source order."""
    return sorted(
        diags,
        key=lambda d: (
            _SEV_ORDER[d.severity],
            d.span.line if d.span else 1 << 30,
            d.span.col if d.span else 0,
            d.code,
        ),
    )


class VerificationError(ValueError):
    """Raised by strict verification; carries the structured findings.

    Subclasses ``ValueError`` so pre-analyzer callers (the auto-tuner's
    retry loop, the serving layer's registration guards) keep catching
    it without change.
    """

    def __init__(self, message: str, diagnostics: Sequence[Diagnostic] = ()):
        super().__init__(message)
        self.diagnostics = tuple(diagnostics)


def _raise_errors(
    diags: Sequence[Diagnostic], spec_name: str, source: str | None = None
) -> None:
    errors = [d for d in diags if d.is_error]
    if not errors:
        return
    body = "\n".join(d.format(source) for d in sort_diagnostics(errors))
    raise VerificationError(
        f"spec {spec_name!r} failed static verification "
        f"({len(errors)} error{'s' if len(errors) != 1 else ''}):\n{body}",
        diagnostics=tuple(diags),
    )


# --------------------------------------------------------------------------
# Footprint / halo inference
# --------------------------------------------------------------------------
#
# A footprint is a per-dimension bounding box of read offsets,
# represented as ``((lo0, hi0), (lo1, hi1), ...)``.  Boxes compose by
# Minkowski sum along a use-def path and by union hull across paths;
# because per-dim extremes are additive under Minkowski sum, the hull of
# the exact (possibly non-rectangular) tap set has the same per-dim
# extremes as the composed boxes — the inference is exact for bounding
# boxes, which is what margins and halo depths are sized from.

Box = tuple[tuple[int, int], ...]


def _box_union(a: Box, b: Box) -> Box:
    return tuple(
        (min(al, bl), max(ah, bh)) for (al, ah), (bl, bh) in zip(a, b)
    )


def _box_add(a: Box, b: Box) -> Box:
    return tuple(
        (al + bl, ah + bh) for (al, ah), (bl, bh) in zip(a, b)
    )


def _merge(into: dict[str, Box], new: Mapping[str, Box]) -> None:
    for name, box in new.items():
        into[name] = _box_union(into[name], box) if name in into else box


def expr_taps(
    expr: Expr, env: Mapping[str, Mapping[str, Box]] | None = None
) -> dict[str, Box]:
    """Per-array bounding box of the offsets ``expr`` reads.

    ``Let`` bindings are traversed use-def style: a binding's taps are
    computed once and every ``Var`` use resolves to them, so the result
    matches the inlined expression regardless of CSE.
    """
    env = dict(env) if env else {}
    if isinstance(expr, Ref):
        return {expr.name: tuple((int(o), int(o)) for o in expr.offsets)}
    if isinstance(expr, Num):
        return {}
    if isinstance(expr, Var):
        return dict(env.get(expr.name, {}))
    if isinstance(expr, Let):
        for name, bound in expr.bindings:
            env[name] = expr_taps(bound, env)
        return expr_taps(expr.body, env)
    out: dict[str, Box] = {}
    if isinstance(expr, BinOp):
        children: tuple[Expr, ...] = (expr.lhs, expr.rhs)
    elif isinstance(expr, Call):
        children = expr.args
    elif isinstance(expr, Neg):
        children = (expr.arg,)
    else:  # pragma: no cover - exhaustive over Expr
        raise TypeError(type(expr))
    for c in children:
        _merge(out, expr_taps(c, env))
    return out


def stage_reach(spec: StencilSpec) -> dict[str, dict[str, Box]]:
    """For every array (input or stage), its reach onto the declared inputs.

    ``reach[name][inp]`` is the bounding box of offsets through which
    the value of array ``name`` at a cell depends on input ``inp``
    within one iteration; absent keys mean no dependence.  Inputs reach
    themselves at offset zero; stages compose their direct taps with
    the reach of what they read (Minkowski sum per read, union across
    reads).
    """
    zero: Box = tuple((0, 0) for _ in range(spec.ndim))
    reach: dict[str, dict[str, Box]] = {
        inp: {inp: zero} for inp in spec.inputs
    }
    for st in spec.stages:
        acc: dict[str, Box] = {}
        for arr, box in expr_taps(st.expr).items():
            base = reach.get(arr)
            if base is None:
                continue  # unknown array: validate()/parse reject it
            for inp, through in base.items():
                composed = _box_add(box, through)
                _merge(acc, {inp: composed})
        reach[st.name] = acc
    return reach


def spec_footprint(
    spec: StencilSpec, iterations: int | None = None
) -> dict[str, Box | None]:
    """Total reach of each declared input onto the final output.

    Composes the per-iteration output reach across ``iterations``
    ping-pong rounds: the initial iterate value is seen only through
    ``F`` composed ``it`` times (per-dim ``(it*lo, it*hi)``), while a
    constant input is re-read every round, i.e. through
    ``union_{t<it} (t*F + G)`` — per-dim
    ``(G_lo + min(0, (it-1)*F_lo), G_hi + max(0, (it-1)*F_hi))``.
    ``None`` marks an input that never influences the output (its
    empirical blast radius is empty).
    """
    it = spec.iterations if iterations is None else int(iterations)
    per_iter = stage_reach(spec)[spec.output_name]
    F = per_iter.get(spec.iterate_input)
    total: dict[str, Box | None] = {}
    for inp in spec.inputs:
        if inp == spec.iterate_input:
            total[inp] = (
                None if F is None
                else tuple((lo * it, hi * it) for lo, hi in F)
            )
            continue
        G = per_iter.get(inp)
        if G is None:
            total[inp] = None
        elif F is None or it <= 1:
            total[inp] = G
        else:
            t = it - 1
            total[inp] = tuple(
                (glo + min(0, flo * t), ghi + max(0, fhi * t))
                for (glo, ghi), (flo, fhi) in zip(G, F)
            )
    return total


def per_dim_radii(spec: StencilSpec) -> tuple[int, ...]:
    """Per-dimension one-iteration staleness depth of the composite stencil.

    The max absolute offset, per dim, through which the output depends
    on any input within a single iteration.  Bounded above by the
    declared Chebyshev ``spec.radius`` (which sums stage radii over the
    worst dim), so margins sized from ``spec.radius`` are always
    sufficient — this function makes the per-dim slack visible and lets
    :func:`margin_diagnostics` prove a given margin adequate.
    """
    per_iter = stage_reach(spec)[spec.output_name]
    radii = [0] * spec.ndim
    for box in per_iter.values():
        for d, (lo, hi) in enumerate(box):
            radii[d] = max(radii[d], -lo, hi, 0)
    return tuple(radii)


def required_margins(
    spec: StencilSpec,
    iterations: int | None = None,
    wrap_rounds: int | None = None,
) -> tuple[int, ...]:
    """Per-dim margin depth a periodic bucket must reserve per side.

    The streamed wrap extension goes stale from the bucket edge inward
    at the per-dim staleness depth per iteration, and survives
    ``rounds`` iterations between re-wraps — ``iterations`` total for
    the legacy wide margin, ``wrap_rounds`` when executors re-impose
    the wrap between fused rounds.  Non-periodic modes re-impose their
    exterior in-kernel every stage and need no margin.
    """
    if spec.boundary.kind != "periodic":
        return (0,) * spec.ndim
    it = spec.iterations if iterations is None else int(iterations)
    rounds = it if wrap_rounds is None else min(int(wrap_rounds), it)
    rounds = max(rounds, 1)
    return tuple(rounds * r for r in per_dim_radii(spec))


def margin_diagnostics(
    spec: StencilSpec,
    margins: Sequence[int],
    iterations: int | None = None,
    wrap_rounds: int | None = None,
) -> list[Diagnostic]:
    """Prove ``margins`` (per-dim, per-side) sufficient, or say why not."""
    need = required_margins(spec, iterations, wrap_rounds)
    diags = []
    for d, (have, want) in enumerate(zip(margins, need)):
        if have < want:
            diags.append(Diagnostic(
                "SASA307", "error",
                f"bucket margin for dim {d} is {have} cells but staleness "
                f"reaches {want} (= rounds * per-dim radius "
                f"{per_dim_radii(spec)[d]}); wrapped data would go stale "
                "inside the real grid",
                stage=spec.output_name,
            ))
    return diags


# --------------------------------------------------------------------------
# Interval domain: division safety
# --------------------------------------------------------------------------

_INF = math.inf


@dataclasses.dataclass(frozen=True)
class Interval:
    """Closed interval over the extended reals; TOP = (-inf, inf)."""

    lo: float
    hi: float

    @property
    def contains_zero(self) -> bool:
        return self.lo <= 0.0 <= self.hi

    def hull(self, other: "Interval") -> "Interval":
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi))


TOP = Interval(-_INF, _INF)


def _xmul(a: float, b: float) -> float:
    # 0 * inf -> 0: the zero endpoint dominates in interval products
    if a == 0.0 or b == 0.0:
        return 0.0
    return a * b


def _iadd(a: Interval, b: Interval) -> Interval:
    return Interval(a.lo + b.lo, a.hi + b.hi)


def _isub(a: Interval, b: Interval) -> Interval:
    return Interval(a.lo - b.hi, a.hi - b.lo)


def _ineg(a: Interval) -> Interval:
    return Interval(-a.hi, -a.lo)


def _imul(a: Interval, b: Interval) -> Interval:
    prods = [_xmul(x, y) for x in (a.lo, a.hi) for y in (b.lo, b.hi)]
    return Interval(min(prods), max(prods))


def _idiv(a: Interval, b: Interval) -> Interval:
    if b.contains_zero:
        return TOP
    inv = Interval(
        0.0 if math.isinf(b.hi) else 1.0 / b.hi,
        0.0 if math.isinf(b.lo) else 1.0 / b.lo,
    )
    return _imul(a, inv)


def _iabs(a: Interval) -> Interval:
    if a.lo >= 0.0:
        return a
    if a.hi <= 0.0:
        return _ineg(a)
    return Interval(0.0, max(-a.lo, a.hi))


def expr_interval(
    expr: Expr,
    arrays: Mapping[str, Interval] | None = None,
    env: Mapping[str, Interval] | None = None,
    on_division=None,
) -> Interval:
    """Value interval of ``expr``.

    ``arrays`` maps array names to their value intervals (unknown names
    default to TOP — streamed data is unbounded).  ``on_division`` is
    called with ``(node, divisor_interval)`` for every ``/`` node, which
    is how :func:`division_diagnostics` collects unsafe divisors in one
    traversal.
    """
    arrays = arrays or {}
    env = dict(env) if env else {}

    def go(e: Expr, env: dict[str, Interval]) -> Interval:
        if isinstance(e, Num):
            return Interval(float(e.value), float(e.value))
        if isinstance(e, Ref):
            return arrays.get(e.name, TOP)
        if isinstance(e, Var):
            return env.get(e.name, TOP)
        if isinstance(e, Let):
            inner = dict(env)
            for name, bound in e.bindings:
                inner[name] = go(bound, inner)
            return go(e.body, inner)
        if isinstance(e, Neg):
            return _ineg(go(e.arg, env))
        if isinstance(e, Call):
            ivs = [go(a, env) for a in e.args]
            if e.fn == "abs":
                return _iabs(ivs[0])
            if e.fn == "max":
                return Interval(
                    max(v.lo for v in ivs), max(v.hi for v in ivs)
                )
            if e.fn == "min":
                return Interval(
                    min(v.lo for v in ivs), min(v.hi for v in ivs)
                )
            return TOP
        if isinstance(e, BinOp):
            a, b = go(e.lhs, env), go(e.rhs, env)
            if e.op == "+":
                return _iadd(a, b)
            if e.op == "-":
                return _isub(a, b)
            if e.op == "*":
                return _imul(a, b)
            if e.op == "/":
                if on_division is not None:
                    on_division(e, b)
                return _idiv(a, b)
        return TOP  # pragma: no cover - exhaustive over Expr

    return go(expr, env)


def division_diagnostics(
    spec: StencilSpec, bucketed: bool = True
) -> list[Diagnostic]:
    """Prove every divisor nonzero over value intervals, else SASA301.

    Stage value intervals chain: a stage dividing by an earlier local
    whose interval excludes zero (e.g. ``abs(x) + 1``) is admitted.
    With ``bucketed`` (the default — the serving north-star), stage
    intervals are widened by the mask-weave fill value: ``zero`` /
    ``constant`` buckets overwrite padding cells of *every* stage with
    the fill, so a later stage dividing by an earlier one must tolerate
    the fill appearing as a divisor.  Input arrays are TOP regardless —
    padding holds the fill, a subset of unbounded streamed data.

    Severity is ``error`` in the bucketed context (a NaN on padding
    bleeds into the real grid — the kernel must be refused) and
    ``warning`` exact-shape (the division runs on real data only; a
    zero there is the kernel author's own runtime hazard).
    """
    severity = "error" if bucketed else "warning"
    fill: Interval | None = None
    if bucketed and spec.boundary.kind in ("zero", "constant"):
        v = spec.boundary.value if spec.boundary.kind == "constant" else 0.0
        fill = Interval(v, v)

    diags: list[Diagnostic] = []
    arrays: dict[str, Interval] = {}
    for st in spec.stages:

        def report(node: BinOp, divisor: Interval, _st=st):
            if not divisor.contains_zero:
                return
            names = sorted({r.name for r in refs_in(node.rhs)})
            if names:
                what = (
                    f"divides by streamed data ({', '.join(names)}): the "
                    f"divisor's value interval "
                    f"[{divisor.lo:g}, {divisor.hi:g}] contains zero, so "
                    "zero padding could produce non-finite values that "
                    "survive the exterior mask; this kernel cannot be "
                    "shape-bucketed — serve it exact-shape, or bound the "
                    "divisor away from zero (e.g. abs(...) + c)"
                    if bucketed else
                    f"divides by streamed data ({', '.join(names)}) whose "
                    f"value interval [{divisor.lo:g}, {divisor.hi:g}] "
                    "contains zero: a zero in the real data produces "
                    "inf/NaN at run time"
                )
            else:
                what = (
                    "divides by a constant expression whose value interval "
                    f"[{divisor.lo:g}, {divisor.hi:g}] contains zero"
                )
            diags.append(Diagnostic(
                "SASA301", severity,
                f"stage {_st.name!r} {what}",
                span=node.span or _st.span,
                stage=_st.name,
            ))

        iv = expr_interval(st.expr, arrays, on_division=report)
        arrays[st.name] = iv.hull(fill) if fill is not None else iv
    return diags


# --------------------------------------------------------------------------
# Dataflow hygiene
# --------------------------------------------------------------------------


def _live_stages(spec: StencilSpec) -> set[str]:
    """Stage names whose values (transitively) reach the output."""
    reads = {
        st.name: {r.name for r in refs_in(st.expr)} for st in spec.stages
    }
    live = {spec.output_name}
    changed = True
    while changed:
        changed = False
        for st in spec.stages:
            if st.name in live:
                for dep in reads[st.name]:
                    if dep in reads and dep not in live:
                        live.add(dep)
                        changed = True
    return live


def hygiene_diagnostics(spec: StencilSpec) -> list[Diagnostic]:
    """Dead stages, unused inputs, single-use Lets, invariant subtrees."""
    from repro_torch.core.ir import inline_lets

    diags: list[Diagnostic] = []
    live = _live_stages(spec)
    service = set(spec.halo_index_inputs) | set(spec.wrap_index_inputs)

    for st in spec.local_stages:
        if st.name not in live:
            diags.append(Diagnostic(
                "SASA210", "warning",
                f"local stage {st.name!r} is dead: no path from it to the "
                f"output stage {spec.output_name!r}",
                span=st.span, stage=st.name,
            ))

    read_by_live: set[str] = set()
    for st in spec.stages:
        if st.name in live:
            read_by_live |= {r.name for r in refs_in(st.expr)}
    it = spec.iterations
    for inp in spec.inputs:
        if inp in read_by_live or inp in service:
            continue
        if inp == spec.iterate_input and it > 1:
            continue  # reported as SASA402 below, with the iteration angle
        diags.append(Diagnostic(
            "SASA211", "warning",
            f"input {inp!r} is never read by any live stage",
            stage=None,
        ))

    # Iterations only do work if the output depends on the iterate input.
    per_iter = stage_reach(spec)[spec.output_name]
    if it > 1 and spec.iterate_input not in per_iter:
        diags.append(Diagnostic(
            "SASA402", "warning",
            f"iterations = {it} but the output never reads the iterate "
            f"input {spec.iterate_input!r}: every iteration recomputes the "
            "same grid",
            span=spec.output_stage.span, stage=spec.output_name,
        ))

    # Single-use Let bindings (hand-built IR; CSE emits multi-use ones,
    # though collapsing an outer repeat can strand an inner binding).
    for st in spec.stages:
        uses: dict[str, int] = {}
        bindings: dict[str, Let] = {}

        def scan(e: Expr):
            if isinstance(e, Var):
                uses[e.name] = uses.get(e.name, 0) + 1
            elif isinstance(e, Let):
                for name, bound in e.bindings:
                    bindings[name] = e
                    scan(bound)
                scan(e.body)
            elif isinstance(e, BinOp):
                scan(e.lhs)
                scan(e.rhs)
            elif isinstance(e, Call):
                for a in e.args:
                    scan(a)
            elif isinstance(e, Neg):
                scan(e.arg)

        scan(st.expr)
        for name, owner in bindings.items():
            if uses.get(name, 0) <= 1:
                diags.append(Diagnostic(
                    "SASA212", "info",
                    f"Let binding {name!r} in stage {st.name!r} is used "
                    f"{uses.get(name, 0)} time(s); inline it",
                    span=owner.span, stage=st.name,
                ))

    # Iteration-invariant subexpressions: a maximal subtree reading only
    # arrays outside the iterate's influence is recomputed identically
    # every iteration — hoistable in principle.
    if it > 1:
        varying = {spec.iterate_input}
        for st in spec.stages:
            if {r.name for r in refs_in(st.expr)} & varying:
                varying.add(st.name)

        def invariant(e: Expr) -> bool:
            names = {r.name for r in refs_in(e)}
            return bool(names) and not (names & varying)

        def find(e: Expr, st: Stage):
            if invariant(e) and count_ops(e) >= 2:
                diags.append(Diagnostic(
                    "SASA403", "warning",
                    f"subexpression in stage {st.name!r} reads only "
                    "iteration-invariant arrays "
                    f"({', '.join(sorted({r.name for r in refs_in(e)}))}) "
                    f"and is recomputed in each of the {it} iterations",
                    span=e.span or st.span, stage=st.name,
                ))
                return  # maximal subtree only
            if isinstance(e, BinOp):
                find(e.lhs, st)
                find(e.rhs, st)
            elif isinstance(e, Call):
                for a in e.args:
                    find(a, st)
            elif isinstance(e, Neg):
                find(e.arg, st)

        for st in spec.stages:
            if st.name in live and st.name in varying:
                find(inline_lets(st.expr), st)
    return diags


# --------------------------------------------------------------------------
# Feasibility preflight
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CandidateVerdict:
    """Static feasibility of one parallelism candidate.

    ``code``/``reason`` explain an infeasible verdict; ``k`` is the
    device count the build would actually use (what the guards key on).
    """

    config: "object"  # ParallelismConfig (kept untyped: no model import cycle)
    feasible: bool
    k: int = 1
    code: str | None = None
    reason: str = ""

    def diagnostic(self, severity: str = "info") -> Diagnostic | None:
        if self.feasible:
            return None
        return Diagnostic(
            self.code or "SASA306", severity,
            f"candidate {self.config} infeasible: {self.reason}",
        )


def candidate_verdict(
    spec: StencilSpec,
    cfg,
    n_devices: int,
    iterations: int | None = None,
    batched: bool = False,
    k_override: int | None = None,
) -> CandidateVerdict:
    """Mirror of the reference's ``distribute.build_runner`` refusals.

    ``n_devices`` is the device pool the build would draw from; the
    guards key on ``k = min(cfg.devices_needed, n_devices)``, exactly
    as ``build_runner`` slices ``jax.devices()``.  Callers that pass an
    explicit device list to ``build_runner`` (which then uses *all* of
    them) give its length as ``k_override``.  With ``batched`` (the
    :func:`repro_torch.runtime.batching.build_batched_runner` path) a
    candidate that runs on a single device -- one degraded to it, or a
    temporal one, which that path runs as fused rounds of the tile kernel
    on any pool -- bypasses ``build_runner`` entirely: the single-PE path
    has no shard guards.
    """
    it = spec.iterations if iterations is None else int(iterations)
    if k_override is not None:
        k = max(int(k_override), 1)
    else:
        k = min(max(cfg.devices_needed, 1), max(int(n_devices), 1))
    if batched and (k <= 1 or cfg.variant == "temporal"):
        return CandidateVerdict(cfg, True, k=1)
    if spec.wrap_index_inputs:
        return CandidateVerdict(
            cfg, False, k=k, code="SASA304",
            reason=(
                "streamed wrap margins (wrap_index_inputs) are "
                "single-device only; shard_map designs require the wide "
                "periodic margin"
            ),
        )
    if cfg.variant == "temporal":
        return CandidateVerdict(cfg, True, k=1)
    R = spec.rows
    r = spec.radius
    R_pad = math.ceil(R / k) * k
    R_k = R_pad // k
    if cfg.variant in ("spatial_r", "hybrid_r") and it * r > R_k:
        return CandidateVerdict(
            cfg, False, k=k, code="SASA305",
            reason=(
                f"{cfg.variant} needs iter*r <= rows/device "
                f"({it}*{r} > {R_k}): the halo would span multiple "
                "neighbour shards"
            ),
        )
    if spec.boundary.kind == "periodic" and R_pad != R:
        return CandidateVerdict(
            cfg, False, k=k, code="SASA302",
            reason=(
                f"periodic boundary needs rows divisible by the spatial "
                f"degree ({R} rows over k={k} leaves {R_pad - R} padding "
                "rows that would break the wraparound halo adjacency)"
            ),
        )
    if spec.boundary.kind == "replicate" and (k - 1) * R_k > R - 1:
        return CandidateVerdict(
            cfg, False, k=k, code="SASA303",
            reason=(
                f"replicate boundary needs every device to own at least "
                f"one real grid row ({R} rows over k={k} leaves an "
                "all-padding shard that cannot clamp to the edge)"
            ),
        )
    return CandidateVerdict(cfg, True, k=k)


def preflight(
    spec: StencilSpec,
    configs: Sequence,
    n_devices: int,
    iterations: int | None = None,
    batched: bool = False,
    k_override: int | None = None,
) -> list[CandidateVerdict]:
    """Classify every candidate feasible/infeasible-with-reason, in order."""
    return [
        candidate_verdict(spec, c, n_devices, iterations, batched, k_override)
        for c in configs
    ]


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------


def verify(
    spec: StencilSpec,
    platform=None,
    iterations: int | None = None,
    n_devices: int | None = None,
    batched: bool = False,
    bucketed: bool = True,
    optimize: bool = True,
) -> list[Diagnostic]:
    """Run the full pass suite over ``spec``; returns sorted diagnostics.

    Spec-level analyses (division safety, hygiene, margin proof) always
    run; with ``platform`` the candidate space is ranked and preflighted
    too — infeasible candidates surface as info diagnostics (the tuner
    skips them by design) and *no* feasible candidate at all is the
    SASA306 error.  ``optimize`` lowers through the IR pipeline first,
    matching what executors compile; spans survive lowering.
    """
    from repro_torch.core.ir import lower

    from repro_torch.core import numerics

    lowered = lower(spec).spec if optimize else spec
    it = spec.iterations if iterations is None else int(iterations)
    diags: list[Diagnostic] = []
    diags += division_diagnostics(lowered, bucketed=bucketed)
    diags += hygiene_diagnostics(lowered)
    diags += numerics.numerics_diagnostics(
        lowered, iterations=it, bucketed=bucketed, optimize=False
    )

    # Margin-sufficiency proof: the margins the bucket layer reserves
    # (rounds * spec.radius per side, see runtime.bucketing.bucket_margins)
    # against the inferred per-dim staleness depth.
    if spec.boundary.kind == "periodic":
        rounds = (
            min(spec.wrap_round_depth, it) if spec.wrap_index_inputs else it
        )
        margins = (max(rounds, 1) * spec.radius,) * spec.ndim
        diags += margin_diagnostics(
            lowered, margins, iterations=it,
            wrap_rounds=spec.wrap_round_depth or None,
        )

    if platform is not None:
        from repro_torch.core.model import FPGAPlatform, choose_best

        ranking = choose_best(
            spec, platform, iterations=iterations, optimize=optimize
        )
        budget = getattr(platform, "smem_per_block", None)
        overflow = [
            p.config for p in ranking
            if budget is not None and p.smem_bytes > budget
        ]
        if overflow:
            diags.append(Diagnostic(
                "SASA401", "warning",
                f"{len(overflow)} candidate(s) need more shared memory per "
                f"block than the card's {budget} bytes: "
                f"{overflow[:3]}{'...' if len(overflow) > 3 else ''}",
            ))
        if not isinstance(platform, FPGAPlatform):
            pool = (
                int(n_devices) if n_devices is not None
                else int(getattr(platform, "num_gpus", 1))
            )
            verdicts = preflight(
                spec, [p.config for p in ranking], pool,
                iterations=iterations, batched=batched,
            )
            for v in verdicts:
                d = v.diagnostic("info")
                if d is not None:
                    diags.append(d)
            if verdicts and not any(v.feasible for v in verdicts):
                diags.append(Diagnostic(
                    "SASA306", "error",
                    f"no feasible parallelism candidate for spec "
                    f"{spec.name!r} on a {pool}-device pool: "
                    + "; ".join(
                        f"{v.config.variant}(k={v.config.k},s={v.config.s})"
                        f" -> {v.code}"
                        for v in verdicts[:6]
                    ),
                ))
    return sort_diagnostics(diags)


def verify_or_raise(
    spec: StencilSpec,
    platform=None,
    iterations: int | None = None,
    source: str | None = None,
    **kwargs,
) -> list[Diagnostic]:
    """:func:`verify`, raising :class:`VerificationError` on any error."""
    diags = verify(spec, platform=platform, iterations=iterations, **kwargs)
    _raise_errors(diags, spec.name, source)
    return diags


def require_bucketable(spec: StencilSpec) -> None:
    """Refuse specs the streamed bucket transforms cannot serve bit-exactly.

    The analyzer-backed replacement for the old syntactic
    ``check_bucketable``: instead of refusing *any* array reference in a
    denominator, the interval domain proves divisors nonzero — so
    ``x / (abs(y) + 2)`` is admitted while ``x / (y + 1)`` (interval
    straddles zero) is still refused.  Raises :class:`VerificationError`
    (a ``ValueError``) listing the offending divisions.
    """
    diags = division_diagnostics(spec, bucketed=True)
    _raise_errors(diags, spec.name)


def lint_text(text: str, platform=None, **kwargs):
    """Parse + verify DSL ``text``: ``(spec | None, diagnostics)``.

    Parser failures become SASA1xx diagnostics carrying the error's
    line/column; semantic ``ValueError``s from spec validation become
    SASA200.  On a clean parse the full :func:`verify` suite runs.
    """
    from repro_torch.core import dsl

    try:
        spec = dsl.parse(text)
    except dsl.DSLSyntaxError as e:
        return None, [Diagnostic(
            e.code if e.code in DIAGNOSTIC_CODES else "SASA100",
            "error", e.msg, span=e.span,
        )]
    except SyntaxError as e:
        return None, [Diagnostic("SASA100", "error", str(e))]
    except ValueError as e:
        return None, [Diagnostic("SASA200", "error", str(e))]
    return spec, verify(spec, platform=platform, **kwargs)
