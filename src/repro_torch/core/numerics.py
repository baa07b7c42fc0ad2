"""Certified numerics: first-order rounding-error bounds over the stencil IR.

PyTorch port of ``repro.core.numerics`` (numpy only), verbatim but for
the package's imports.


SASA's correctness story claims generated designs are provably equivalent
to the reference stencil, yet the repo's differential gates historically
leaned on hand-tuned constants (a repo-wide ``2e-4``, a 4-ULP pipeline
bound).  This module replaces the magic with a *certified* bound: a
static analysis in the style of affine arithmetic / FPTaylor-class
first-order error analyses that propagates, for every expression node,

  * a **value envelope** — an interval (static mode) or a measured
    per-node max magnitude (envelope mode) of the *exact* real-arithmetic
    value, and
  * an **absolute error bound** ``E`` — a certified bound on
    ``|computed - exact|`` for any executor whose individual float ops
    are faithful to ``unit_roundoff(dtype)``.

Propagation rules (``u`` = :func:`repro_torch.core.spec.unit_roundoff`, which
is ``eps`` — 2x the correctly-rounded per-op error ``eps/2``, headroom
for merely-faithful backends; ``M(x)`` = magnitude envelope of ``x``):

  ``a + b``, ``a - b``   ``E = (Ea + Eb)(1 + u) + u * M(r)``
  ``a * b``              ``E = Ea*M(b) + Eb*M(a) + Ea*Eb
                               + u * (M(a)+Ea) * (M(b)+Eb)``
  ``a / b``              with ``m = min|b| - Eb`` (certified smallest
                         computed divisor magnitude; ``E = inf`` when
                         ``m <= 0``):
                         ``E = Ea/m + M(a)*Eb/m^2 + 4u*(M(a)+Ea)/m``
                         — division charges ``4u`` because XLA may
                         rewrite ``x / c`` into ``x * (1/c)`` (two
                         roundings, each up to a couple of ULP; this is
                         also what justified the old 4-ULP pipeline
                         differential bound)
  ``-a``, ``abs(a)``     exact: ``E = Ea``
  ``max/min(a, b, ...)`` compare-select is exact: ``E = max(Ei)``
                         (``|max(a,b) - max(a',b')| <= max(|a-a'|,
                         |b-b'|)``)
  ``Num(v)``             representation error ``|v - dtype(v)|``
  ``Let``/``Var``        the binding is analyzed **once** and every use
                         shares its ``(envelope, E)`` — matching the
                         CSE'd evaluation the executors run

Per stage, one extra ``u * (M + E)`` term covers the cast of the stage
result to its declared dtype (the numpy oracle computes ops in float64
and casts per stage; executors are float32 throughout — both patterns
are covered).  Across iterations the iterate input is rebound to the
output's ``(envelope, E)``; constant inputs keep ``E = 0``.

**Soundness of the differential gate**: both an executor and the
pure-numpy oracle are float evaluations within the forward bound ``F``
of the exact iteration, so their mutual divergence is at most ``2F`` —
:func:`tolerance_for` returns exactly that (raw-tree ``F`` + lowered-
tree ``F``; lowering is exact in real arithmetic, so both evaluations
approximate the same ideal value).  tests/test_conformance.py asserts
measured divergence <= certified bound for every spec x executor x
boundary mode on the 200-seed corpus, and that the bound stays within
:data:`NONVACUITY_SLACK` of the measured error on the corpus median —
certified, and not vacuous.

Two analysis modes:

  * :func:`analyze` — **static interval mode**: inputs are assumed to
    range over ``[-input_range, input_range]`` (documented unit-range
    default; pass a mapping of per-input :class:`Interval` s to
    override).  Powers the SASA5xx diagnostics, ``repro.lint
    --numerics`` budget tables, and the stock-kernel finite-bound CI
    gate.
  * :func:`measured_report` / :func:`tolerance_for` — **envelope mode**:
    the expression trees are evaluated in float64 on the actual input
    arrays, mirroring the oracle's per-stage boundary padding, and the
    same propagation rules run **cell-by-cell** — each cell's error is
    amplified only by the magnitudes that cell actually meets, not the
    array-wide max (measured magnitudes are widened by ``1 + 2**-30``
    to cover the float64 evaluation of the envelopes themselves).
    This is what derives per-case conformance tolerances: interval
    envelopes compound geometrically on iterated multiplicative
    kernels, and even measured *scalar* (max-magnitude) envelopes
    over-charge deep product chains by orders of magnitude, because
    the large-magnitude cells and large-error cells are generally
    different cells.

Diagnostics (registered in ``analysis.DIAGNOSTIC_CODES``; all carry DSL
source spans that survive IR lowering):

  SASA500  info     certified bound attached to ``TunedDesign``
  SASA501  warning  value envelope reaches the dtype's finite max
  SASA502  warning  +/- can cancel below the accumulated error
                    (``E_in >= 2**-12 * M(result)``)
  SASA503  warning  divisor's certified magnitude spread
                    ``M(b)/m >= 1e3`` amplifies error per cell
  SASA510  warning  total relative bound beyond dtype-meaningful
                    precision (``E/M >= 2**-10``)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import numpy as np

from repro_torch.core.analysis import (
    TOP,
    Diagnostic,
    Interval,
    _iabs,
    _iadd,
    _idiv,
    _imul,
    _ineg,
    _isub,
    sort_diagnostics,
)
from repro_torch.core.spec import (
    BinOp,
    Call,
    Expr,
    Let,
    Neg,
    Num,
    Ref,
    Stage,
    StencilSpec,
    Var,
    finite_max,
    unit_roundoff,
)

_INF = math.inf

#: Division's unit-roundoff multiplier (reciprocal-multiply rewrites).
DIV_ROUNDOFF_FACTOR = 4.0

#: SASA502: fire when incoming accumulated error is at least this
#: fraction of the result's magnitude envelope at a +/- node.
CANCEL_THRESHOLD = 2.0 ** -12

#: SASA502's second gate: the result envelope must actually *drop* below
#: this fraction of the operand envelopes — cancellation destroys leading
#: digits; mere error accumulation (result as large as its operands) is
#: SASA510's business, not a cancellation finding.
CANCEL_MAGNITUDE_DROP = 2.0 ** -6

#: SASA503: fire when the divisor's magnitude spread ``M(b) / min|b|``
#: reaches this factor (some cells divide by values this much smaller
#: than others, amplifying their error relative to the rest).
DIV_CONDITION_THRESHOLD = 1.0e3

#: SASA510: total relative bound beyond which the result's digits stop
#: being dtype-meaningful (about 2.4 of float32's ~7.2 decimal digits).
MEANINGFUL_RELATIVE = 2.0 ** -10

#: Iteration-propagation cap: beyond this many fused rounds the static
#: bound is reported as ``inf`` (not certified) instead of looping.
ROUND_CAP = 16384

#: Documented non-vacuity slack: on the 200-seed conformance corpus the
#: certified bound must stay within this factor of the *measured*
#: executor-vs-oracle error on the corpus median (tests/test_conformance
#: asserts it).  First-order static bounds genuinely cost 1-2 orders of
#: magnitude over typical measured error (errors add as bounds, measured
#: errors partially cancel); this factor says "bounded pessimism".
NONVACUITY_SLACK = 1024.0

#: Widening applied to float64-measured envelopes so they certifiably
#: cover the exact real-arithmetic values (f64 evaluation noise is
#: ~2**-52 relative per op; 2**-30 covers any expression this DSL
#: can express with astronomic headroom).
_ENVELOPE_WIDEN = 1.0 + 2.0 ** -30


def _mag(iv: Interval) -> float:
    return max(abs(iv.lo), abs(iv.hi))


def _min_abs(iv: Interval) -> float:
    if iv.contains_zero:
        return 0.0
    return min(abs(iv.lo), abs(iv.hi))


def _pmul(a: float, b: float) -> float:
    # 0 * inf -> 0: a zero magnitude/error annihilates regardless
    if a == 0.0 or b == 0.0:
        return 0.0
    return a * b


# --------------------------------------------------------------------------
# Shared error-propagation rules (magnitudes in, absolute bound out)
# --------------------------------------------------------------------------


def err_add(ea: float, eb: float, mag_r: float, u: float) -> float:
    """``a + b`` / ``a - b``: errors add, result rounds once."""
    return (ea + eb) * (1.0 + u) + _pmul(u, mag_r)


def err_mul(
    ea: float, eb: float, mag_a: float, mag_b: float, u: float
) -> float:
    """``a * b``: first-order cross terms plus rounding of the product."""
    return (
        _pmul(ea, mag_b) + _pmul(eb, mag_a) + _pmul(ea, eb)
        + _pmul(u, _pmul(mag_a + ea, mag_b + eb))
    )


def err_div(
    ea: float, eb: float, mag_a: float, min_b: float, u_div: float
) -> float:
    """``a / b``: infinite unless the computed divisor is bounded away
    from zero (``min_b`` is the certified min magnitude of the *exact*
    divisor; subtracting ``eb`` covers the computed one)."""
    m = min_b - eb
    if not m > 0.0:
        return _INF
    return ea / m + _pmul(mag_a, eb) / (m * m) + u_div * (mag_a + ea) / m


def cast_err(err: float, mag: float, u: float) -> float:
    """One rounding of the stage result to its declared dtype."""
    return err * (1.0 + u) + _pmul(u, mag)


# --------------------------------------------------------------------------
# Report structure
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StageBudget:
    """Error budget of one stage after the final analyzed round."""

    stage: str
    lo: float           # value envelope (interval or measured +- mag)
    hi: float
    err: float          # accumulated absolute error bound
    ulps: float         # err in units of u * max(|envelope|, 1)

    def row(self) -> str:
        return (
            f"{self.stage:<12} [{self.lo:>11.4g}, {self.hi:>11.4g}]"
            f" {self.err:>12.3g} {self.ulps:>10.1f}"
        )


@dataclasses.dataclass(frozen=True)
class ErrorReport:
    """Outcome of one certified-numerics analysis.

    ``bound`` certifies ``|computed - exact| <= bound`` per output cell
    for any executor with faithful per-op rounding; ``differential``
    (``2 * bound``) bounds the divergence between two such executors
    (or executor vs the numpy oracle).  ``assumed_range`` is the static
    input-range assumption, ``None`` for measured (envelope) analyses.
    """

    spec_name: str
    dtype: str
    iterations: int
    rounds_analyzed: int
    bound: float
    scale: float        # output magnitude envelope
    budgets: tuple[StageBudget, ...]
    diagnostics: tuple[Diagnostic, ...] = ()
    assumed_range: float | None = None
    #: Envelope mode only: the per-output-cell error-bound array (f64),
    #: ``None`` for static analyses.  ``bound`` is its max; keeping the
    #: cells lets :func:`tolerance_for` sum raw + lowered bounds
    #: cell-by-cell instead of max + max.
    cell_err: object = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def relative(self) -> float:
        if self.bound == 0.0:
            return 0.0
        if not math.isfinite(self.bound) or self.scale == 0.0:
            return _INF
        return self.bound / self.scale

    @property
    def differential(self) -> float:
        """Sound bound on |executor - oracle| (two faithful evaluations)."""
        return 2.0 * self.bound

    @property
    def certified(self) -> bool:
        return math.isfinite(self.bound)

    def table(self) -> str:
        """The per-stage error budget table (``repro.lint --numerics``)."""
        head = (
            f"{'stage':<12} {'value envelope':<26} {'abs error':>12}"
            f" {'ulps':>10}"
        )
        lines = [head, "-" * len(head)]
        lines += [b.row() for b in self.budgets]
        src = (
            f"inputs in [-{self.assumed_range:g}, {self.assumed_range:g}]"
            if self.assumed_range is not None else "measured input data"
        )
        lines.append(
            f"certified ({src}, {self.dtype}): |computed - exact| <= "
            f"{self.bound:.3g} per cell over {self.iterations} "
            f"iteration(s); relative {self.relative:.3g}"
        )
        return "\n".join(lines)


# --------------------------------------------------------------------------
# Static interval mode
# --------------------------------------------------------------------------


class _StaticAnalyzer:
    """One traversal state: per-stage dtype constants + fired diagnostics."""

    def __init__(self, spec: StencilSpec, assumed_range: float | None):
        self.spec = spec
        self.assumed_range = assumed_range
        self.diags: list[Diagnostic] = []
        self._seen: set = set()
        self.unsafe_division = False
        self.stage: Stage | None = None
        self.u = unit_roundoff(spec.dtype)
        self.fmax = finite_max(spec.dtype)
        self._np_dtype = None

    def set_stage(self, st: Stage) -> None:
        self.stage = st
        self.u = unit_roundoff(st.dtype)
        self.fmax = finite_max(st.dtype)
        self._np_dtype = np.dtype(st.dtype) if st.dtype in (
            "float16", "float32", "float64"
        ) else None

    # -- diagnostics -------------------------------------------------------

    def _fire(self, code: str, node, message: str, key=None) -> None:
        span = getattr(node, "span", None) or (
            self.stage.span if self.stage is not None else None
        )
        if key is not None:
            k = key
        else:
            loc = (span.line, span.col) if span is not None else None
            k = (code, self.stage.name, loc)
        if k in self._seen:
            return
        self._seen.add(k)
        self.diags.append(Diagnostic(
            code, "warning", message, span=span,
            stage=self.stage.name if self.stage is not None else None,
        ))

    def _note_range(self) -> str:
        if self.assumed_range is None:
            return ""
        return (
            f" (assuming inputs in [-{self.assumed_range:g},"
            f" {self.assumed_range:g}])"
        )

    def _check_overflow(self, node, iv: Interval, err: float) -> None:
        if self.unsafe_division:
            return  # interval blew up through a zero-straddling divisor
        reach = _mag(iv) + err
        if reach >= self.fmax:
            self._fire(
                "SASA501", node,
                f"value envelope [{iv.lo:g}, {iv.hi:g}] (+ error {err:.3g})"
                f" reaches the {self.stage.dtype} finite max "
                f"{self.fmax:.4g}: overflow to inf is possible"
                + self._note_range(),
                key=("SASA501", self.stage.name),
            )

    def _check_cancel(
        self,
        node,
        ea: float,
        eb: float,
        a_iv: Interval,
        b_iv: Interval,
        iv: Interval,
    ) -> None:
        # both gates must hold: the operands' leading digits actually
        # cancel (result envelope drops well below the operand
        # envelopes), and what survives is dominated by incoming error.
        # Each add also charges its own u * max(mag_a, mag_b) of lost
        # exactness relative to the surviving magnitude.
        mag_in = max(_mag(a_iv), _mag(b_iv))
        mag_r = _mag(iv)
        if not math.isfinite(mag_in) or not math.isfinite(mag_r):
            return
        if mag_r > CANCEL_MAGNITUDE_DROP * mag_in:
            return
        ein = ea + eb + self.u * mag_in
        if ein <= 0.0 or not math.isfinite(ein):
            return
        if mag_r == 0.0 or ein >= CANCEL_THRESHOLD * mag_r:
            rel = _INF if mag_r == 0.0 else ein / mag_r
            self._fire(
                "SASA502", node,
                f"operands of '{node.op}' reach magnitude {mag_in:g} but"
                f" cancel to at most {mag_r:g}, leaving accumulated"
                f" rounding error <= {ein:.3g} ({rel:.3g}x of the"
                " surviving magnitude): the result's digits are dominated"
                " by error" + self._note_range(),
            )

    def _check_division(
        self, node, b_iv: Interval, eb: float
    ) -> None:
        min_b = _min_abs(b_iv)
        if min_b - eb <= 0.0:
            # zero-straddling divisor: SASA301 (division safety) owns
            # this finding; suppress the numerics codes downstream.
            self.unsafe_division = True
            return
        m = min_b - eb
        kappa = _mag(b_iv) / m
        if math.isfinite(kappa) and kappa >= DIV_CONDITION_THRESHOLD:
            self._fire(
                "SASA503", node,
                f"divisor envelope [{b_iv.lo:g}, {b_iv.hi:g}] spans a"
                f" {kappa:.3g}x magnitude range: cells dividing by values"
                f" near {m:.3g} amplify incoming absolute error by up to"
                f" {1.0 / m:.3g}x" + self._note_range(),
            )

    # -- propagation -------------------------------------------------------

    def node(
        self,
        e: Expr,
        arrays: Mapping[str, tuple[Interval, float]],
        env: dict,
    ) -> tuple[Interval, float]:
        if isinstance(e, Num):
            v = float(e.value)
            if self._np_dtype is not None and math.isfinite(v):
                rep = abs(v - float(np.asarray(v, dtype=self._np_dtype)))
            else:
                rep = 0.0 if math.isfinite(v) else _INF
            iv = Interval(v, v)
            self._check_overflow(e, iv, rep)
            return iv, rep
        if isinstance(e, Ref):
            return arrays.get(e.name, (TOP, _INF))
        if isinstance(e, Var):
            return env.get(e.name, (TOP, _INF))
        if isinstance(e, Let):
            inner = dict(env)
            for name, bound in e.bindings:
                inner[name] = self.node(bound, arrays, inner)
            return self.node(e.body, arrays, inner)
        if isinstance(e, Neg):
            iv, err = self.node(e.arg, arrays, env)
            return _ineg(iv), err
        if isinstance(e, Call):
            pairs = [self.node(a, arrays, env) for a in e.args]
            ivs = [p[0] for p in pairs]
            err = max(p[1] for p in pairs)
            if e.fn == "abs":
                iv = _iabs(ivs[0])
            elif e.fn == "max":
                iv = Interval(
                    max(v.lo for v in ivs), max(v.hi for v in ivs)
                )
            elif e.fn == "min":
                iv = Interval(
                    min(v.lo for v in ivs), min(v.hi for v in ivs)
                )
            else:  # pragma: no cover - exhaustive over INTRINSICS
                iv, err = TOP, _INF
            return iv, err
        if isinstance(e, BinOp):
            a_iv, ea = self.node(e.lhs, arrays, env)
            b_iv, eb = self.node(e.rhs, arrays, env)
            if e.op in ("+", "-"):
                iv = _iadd(a_iv, b_iv) if e.op == "+" else _isub(a_iv, b_iv)
                err = err_add(ea, eb, _mag(iv), self.u)
                self._check_cancel(e, ea, eb, a_iv, b_iv, iv)
            elif e.op == "*":
                iv = _imul(a_iv, b_iv)
                err = err_mul(ea, eb, _mag(a_iv), _mag(b_iv), self.u)
            else:  # "/"
                self._check_division(e, b_iv, eb)
                iv = _idiv(a_iv, b_iv)
                err = err_div(
                    ea, eb, _mag(a_iv), _min_abs(b_iv),
                    DIV_ROUNDOFF_FACTOR * self.u,
                )
            self._check_overflow(e, iv, err if math.isfinite(err) else 0.0)
            return iv, err
        raise TypeError(type(e))  # pragma: no cover - exhaustive over Expr


def _input_envelopes(
    spec: StencilSpec, input_range
) -> tuple[dict[str, tuple[Interval, float]], float | None]:
    """Initial (interval, error) state for every input + the noted range."""
    if isinstance(input_range, Mapping):
        state = {}
        for n in spec.inputs:
            iv = input_range.get(n, TOP)
            if not isinstance(iv, Interval):
                r = abs(float(iv))
                iv = Interval(-r, r)
            state[n] = (iv, 0.0)
        noted = None
    else:
        r = abs(float(input_range))
        state = {n: (Interval(-r, r), 0.0) for n in spec.inputs}
        noted = r
    if spec.boundary.kind in ("zero", "constant"):
        # out-of-grid taps read the fill: widen every input's envelope
        v = spec.boundary.value if spec.boundary.kind == "constant" else 0.0
        fill = Interval(v, v)
        state = {n: (iv.hull(fill), err) for n, (iv, err) in state.items()}
    return state, noted


def analyze(
    spec: StencilSpec,
    iterations: int | None = None,
    input_range=1.0,
    bucketed: bool = True,
    optimize: bool = True,
) -> ErrorReport:
    """Static interval-mode analysis: certified bound + SASA5xx findings.

    ``input_range`` is the documented unit-range assumption: every input
    is taken to lie in ``[-input_range, input_range]`` (pass a mapping of
    per-input :class:`Interval` s for real data ranges).  ``bucketed``
    widens stage envelopes by the mask-weave fill, mirroring
    ``division_diagnostics``.  ``optimize`` lowers through the IR
    pipeline first — executors run the lowered trees; pass ``False``
    when the caller (``analysis.verify``) already lowered.
    """
    if optimize:
        from repro_torch.core.ir import lower

        spec = lower(spec).spec
    it = spec.iterations if iterations is None else int(iterations)
    analyzer = _StaticAnalyzer(spec, None)
    state, noted = _input_envelopes(spec, input_range)
    analyzer.assumed_range = noted

    fill: Interval | None = None
    if bucketed and spec.boundary.kind in ("zero", "constant"):
        v = spec.boundary.value if spec.boundary.kind == "constant" else 0.0
        fill = Interval(v, v)

    rounds = min(it, ROUND_CAP)
    budgets: list[StageBudget] = []
    out_iv, out_err = TOP, _INF
    done = 0
    for _ in range(rounds):
        budgets = []
        for st in spec.stages:
            analyzer.set_stage(st)
            iv, err = analyzer.node(st.expr, state, {})
            err = cast_err(err, _mag(iv), analyzer.u)
            stored = iv.hull(fill) if fill is not None else iv
            state[st.name] = (stored, err)
            mag = _mag(iv)
            budgets.append(StageBudget(
                st.name, iv.lo, iv.hi, err,
                err / (analyzer.u * max(mag, 1.0))
                if math.isfinite(err) else _INF,
            ))
        out_iv, out_err = state[spec.output_name]
        state[spec.iterate_input] = (out_iv, out_err)
        done += 1
        if not math.isfinite(out_err):
            break
    bound = out_err if done == it else _INF
    scale = _mag(out_iv)

    if not analyzer.unsafe_division:
        rel = (
            0.0 if bound == 0.0
            else _INF if not math.isfinite(bound) or scale == 0.0
            else bound / scale
        )
        if rel >= MEANINGFUL_RELATIVE:
            rng = (
                f" assuming inputs in [-{noted:g}, {noted:g}]"
                if noted is not None else ""
            )
            analyzer.stage = spec.output_stage
            analyzer._fire(
                "SASA510", spec.output_stage,
                f"accumulated rounding-error bound {bound:.3g} is "
                f"{rel:.3g} of the output envelope {scale:g} after "
                f"{it} iteration(s){rng}: beyond {spec.dtype}-meaningful "
                f"precision (threshold {MEANINGFUL_RELATIVE:g})",
                key=("SASA510", spec.output_name),
            )

    return ErrorReport(
        spec_name=spec.name,
        dtype=spec.dtype,
        iterations=it,
        rounds_analyzed=done,
        bound=bound,
        scale=scale,
        budgets=tuple(budgets),
        diagnostics=tuple(sort_diagnostics(analyzer.diags)),
        assumed_range=noted,
    )


# --------------------------------------------------------------------------
# Envelope (measured) mode
# --------------------------------------------------------------------------


def _amag(x) -> float:
    a = np.abs(np.asarray(x, dtype=np.float64))
    m = float(np.max(a)) if a.size else 0.0
    if not math.isfinite(m):
        return _INF
    return m * _ENVELOPE_WIDEN


def _wabs(x):
    """Per-cell widened magnitude of a float64-measured envelope."""
    return np.abs(x) * _ENVELOPE_WIDEN


def _pad_nd(a: np.ndarray, r: int, boundary, ndim: int) -> np.ndarray:
    """Pad the trailing ``ndim`` dims by ``r`` with the boundary rule
    (leading dims — a batch axis — are left alone)."""
    if r == 0:
        return a
    pads = [(0, 0)] * (a.ndim - ndim) + [(r, r)] * ndim
    k = boundary.kind
    if k == "zero":
        return np.pad(a, pads)
    if k == "constant":
        return np.pad(a, pads, constant_values=boundary.value)
    if k == "replicate":
        return np.pad(a, pads, mode="edge")
    return np.pad(a, pads, mode="wrap")


def _pad_err(e, r: int, boundary, ndim: int):
    """Boundary rule for error-bound arrays: zero/constant fills are
    exact (error 0 in the apron); replicate/periodic carry the edge
    cell's error along with its value.  Scalars broadcast unchanged."""
    if r == 0 or np.ndim(e) == 0:
        return e
    pads = [(0, 0)] * (e.ndim - ndim) + [(r, r)] * ndim
    k = boundary.kind
    if k in ("zero", "constant"):
        return np.pad(e, pads)
    if k == "replicate":
        return np.pad(e, pads, mode="edge")
    return np.pad(e, pads, mode="wrap")


class _EnvelopeAnalyzer:
    """Float64 evaluation with a per-cell error bound riding along.

    Every node returns ``(value, err)`` — float64 arrays (or scalars
    that broadcast).  Errors are propagated **cell-by-cell**: the error
    at a cell is amplified only by the magnitudes that cell actually
    multiplies or divides by, not by the array-wide max.  (A scalar
    max-magnitude envelope over-charges deep multiplicative chains by
    orders of magnitude — the large-magnitude cells and the
    large-error cells are generally *different* cells.)
    """

    def __init__(self):
        self.u = unit_roundoff("float32")
        self.u_div = DIV_ROUNDOFF_FACTOR * self.u
        self._np_dtype = np.dtype("float32")

    def set_stage(self, st: Stage) -> None:
        self.u = unit_roundoff(st.dtype)
        self.u_div = DIV_ROUNDOFF_FACTOR * self.u
        self._np_dtype = (
            np.dtype(st.dtype)
            if st.dtype in ("float16", "float32", "float64")
            else None
        )

    def node(self, e: Expr, get_ref, env: dict):
        if isinstance(e, Num):
            v = float(e.value)
            if self._np_dtype is not None and math.isfinite(v):
                rep = abs(v - float(np.asarray(v, dtype=self._np_dtype)))
            else:
                rep = 0.0 if math.isfinite(v) else _INF
            return v, rep
        if isinstance(e, Ref):
            return get_ref(e.name, e.offsets)
        if isinstance(e, Var):
            return env[e.name]
        if isinstance(e, Let):
            inner = dict(env)
            for name, bound in e.bindings:
                inner[name] = self.node(bound, get_ref, inner)
            return self.node(e.body, get_ref, inner)
        if isinstance(e, Neg):
            v, err = self.node(e.arg, get_ref, env)
            return -np.asarray(v, dtype=np.float64), err
        if isinstance(e, Call):
            pairs = [self.node(a, get_ref, env) for a in e.args]
            err = pairs[0][1]
            for _, e2 in pairs[1:]:
                err = np.maximum(err, e2)
            if e.fn == "abs":
                return np.abs(np.asarray(pairs[0][0], np.float64)), err
            acc = np.asarray(pairs[0][0], np.float64)
            for v, _ in pairs[1:]:
                acc = (
                    np.maximum(acc, v) if e.fn == "max"
                    else np.minimum(acc, v)
                )
            return acc, err
        if isinstance(e, BinOp):
            a, ea = self.node(e.lhs, get_ref, env)
            b, eb = self.node(e.rhs, get_ref, env)
            a = np.asarray(a, np.float64)
            b = np.asarray(b, np.float64)
            if e.op in ("+", "-"):
                r = a + b if e.op == "+" else a - b
                return r, (ea + eb) * (1.0 + self.u) + self.u * _wabs(r)
            if e.op == "*":
                r = a * b
                wa, wb = _wabs(a), _wabs(b)
                return r, (
                    ea * wb + eb * wa + ea * eb
                    + self.u * (wa + ea) * (wb + eb)
                )
            # "/": per cell, guard the computed divisor away from zero
            wa = _wabs(a)
            m = np.abs(b) / _ENVELOPE_WIDEN - eb
            with np.errstate(divide="ignore", invalid="ignore"):
                r = a / b
                core = (
                    ea / m + wa * eb / (m * m)
                    + self.u_div * (wa + ea) / m
                )
            err = np.where(m > 0.0, core, _INF)
            return r, err
        raise TypeError(type(e))  # pragma: no cover - exhaustive over Expr


def measured_report(
    spec: StencilSpec,
    arrays: Mapping[str, "np.ndarray"],
    iterations: int | None = None,
) -> ErrorReport:
    """Envelope-mode analysis over actual input data.

    Evaluates the (given) spec's trees in float64, mirroring the numpy
    oracle's per-stage boundary padding, and runs the error-propagation
    rules over the measured per-node magnitudes.  Arrays may carry one
    leading batch axis (the envelope then covers every batch entry).
    The spec is analyzed **as given** — callers wanting the lowered
    trees pass a lowered spec (see :func:`tolerance_for`).
    """
    it = spec.iterations if iterations is None else int(iterations)
    service = set(spec.halo_index_inputs) | set(spec.wrap_index_inputs)
    vals: dict[str, np.ndarray] = {}
    errs: dict = {}
    for n in spec.inputs:
        if n in service:
            continue  # int coordinate plumbing: never read by stages
        vals[n] = np.asarray(arrays[n], dtype=np.float64)
        errs[n] = 0.0  # executors and oracle read the same exact bits
    gshape = tuple(vals[spec.iterate_input].shape[-spec.ndim:])
    analyzer = _EnvelopeAnalyzer()

    budgets: list[StageBudget] = []
    out = vals[spec.iterate_input]
    out_err = np.zeros_like(out)
    done = 0
    rounds = min(it, ROUND_CAP)
    for _ in range(rounds):
        round_vals = dict(vals)
        round_errs = dict(errs)
        budgets = []
        for st in spec.stages:
            analyzer.set_stage(st)
            r = st.radius
            padded_v = {
                n: _pad_nd(a, r, spec.boundary, spec.ndim)
                for n, a in round_vals.items()
            }
            padded_e = {
                n: _pad_err(round_errs[n], r, spec.boundary, spec.ndim)
                for n in round_vals
            }

            def get_ref(name, offsets, pv=padded_v, pe=padded_e, r=r):
                a = pv[name]
                lead = (slice(None),) * (a.ndim - spec.ndim)
                idx = lead + tuple(
                    slice(r + o, r + o + s)
                    for o, s in zip(offsets, gshape)
                )
                err = pe[name]
                return a[idx], (err if np.ndim(err) == 0 else err[idx])

            res, err = analyzer.node(st.expr, get_ref, {})
            res = np.asarray(res, dtype=np.float64)
            if res.shape != out.shape:
                res = np.broadcast_to(res, out.shape).copy()
            err = np.asarray(err, dtype=np.float64)
            err = err * (1.0 + analyzer.u) + analyzer.u * _wabs(res)
            if err.shape != out.shape:
                err = np.broadcast_to(err, out.shape).copy()
            round_vals[st.name] = res
            round_errs[st.name] = err
            mag = _amag(res)
            emax = float(np.max(err)) if err.size else 0.0
            budgets.append(StageBudget(
                st.name, -mag, mag, emax,
                emax / (analyzer.u * max(mag, 1.0))
                if math.isfinite(emax) else _INF,
            ))
        out = round_vals[spec.output_name]
        out_err = round_errs[spec.output_name]
        vals[spec.iterate_input] = out
        errs[spec.iterate_input] = out_err
        done += 1
        if not np.all(np.isfinite(out_err)):
            break
    finite = done == it and bool(np.all(np.isfinite(out_err)))
    bound = float(np.max(out_err)) if finite and out_err.size else (
        0.0 if finite else _INF
    )
    return ErrorReport(
        spec_name=spec.name,
        dtype=spec.dtype,
        iterations=it,
        rounds_analyzed=done,
        bound=bound,
        scale=_amag(out),
        budgets=tuple(budgets),
        diagnostics=(),
        assumed_range=None,
        cell_err=out_err if finite else None,
    )


# --------------------------------------------------------------------------
# Front-door entry points
# --------------------------------------------------------------------------


def tolerance_for(
    spec: StencilSpec,
    iterations: int | None = None,
    arrays: Mapping[str, "np.ndarray"] | None = None,
    input_range=1.0,
) -> float:
    """Certified executor-vs-oracle differential tolerance for one case.

    With ``arrays`` (the conformance suite's path) the envelope mode
    runs over the actual data, once on the raw trees (covering the
    oracle's evaluation) and once on the IR-lowered trees (covering the
    executors') — the sum bounds their divergence, since lowering is
    exact in real arithmetic and both float evaluations approximate the
    same ideal iteration.  Without ``arrays`` the static interval mode
    runs under ``input_range`` and the symmetric ``2 * bound`` is
    returned.  Floored at one ``unit_roundoff`` so a degenerate case
    never produces a zero-width gate.
    """
    floor = unit_roundoff(spec.dtype)
    if arrays is None:
        rep = analyze(spec, iterations=iterations, input_range=input_range)
        return max(rep.differential, floor)
    from repro_torch.core.ir import lower

    raw = measured_report(spec, arrays, iterations)
    lowered = measured_report(lower(spec).spec, arrays, iterations)
    if raw.cell_err is not None and lowered.cell_err is not None:
        # Both analyses produce aligned per-cell bounds; the divergence
        # at a cell is at most the *sum of that cell's* bounds, which is
        # tighter than max(raw) + max(lowered) when the worst cells
        # differ between the two trees.
        return max(float(np.max(raw.cell_err + lowered.cell_err)), floor)
    return max(raw.bound + lowered.bound, floor)


def numerics_diagnostics(
    spec: StencilSpec,
    iterations: int | None = None,
    input_range=1.0,
    bucketed: bool = True,
    optimize: bool = False,
) -> list[Diagnostic]:
    """The SASA5xx findings alone (what ``analysis.verify`` folds in).

    ``optimize`` defaults to ``False`` because ``verify`` hands over the
    already-lowered spec; spans survive lowering either way.
    """
    rep = analyze(
        spec, iterations=iterations, input_range=input_range,
        bucketed=bucketed, optimize=optimize,
    )
    return list(rep.diagnostics)


def bound_diagnostic(
    spec: StencilSpec,
    iterations: int | None = None,
    input_range=1.0,
) -> Diagnostic:
    """The SASA500 info diagnostic attaching the certified bound to a
    :class:`repro_torch.core.autotune.TunedDesign` (autotune / DesignCache /
    StencilServer registration all ride this)."""
    rep = analyze(spec, iterations=iterations, input_range=input_range)
    rng = (
        f"inputs in [-{rep.assumed_range:g}, {rep.assumed_range:g}]"
        if rep.assumed_range is not None else "measured inputs"
    )
    body = (
        f"certified rounding-error bound: |computed - exact| <= "
        f"{rep.bound:.3g} per output cell over {rep.iterations} "
        f"iteration(s) ({rng}; relative {rep.relative:.3g})"
        if rep.certified else
        f"no finite certified rounding-error bound over "
        f"{rep.iterations} iteration(s) ({rng}); see SASA5xx findings"
    )
    return Diagnostic(
        "SASA500", "info", body,
        span=spec.output_stage.span, stage=spec.output_name,
    )
