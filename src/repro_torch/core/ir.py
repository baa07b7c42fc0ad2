"""Stencil IR lowering: an optimizer pass pipeline between DSL and backends.

PyTorch port: a copy of ``repro.core.ir`` (no JAX), so that the port's
executors and ranker see the same lowered trees as the reference's.

The SASA front end parses DSL text into per-stage expression trees
(:mod:`repro_torch.core.spec`).  This module is the middle layer every consumer
goes through (docs/DESIGN.md §IR pass pipeline): ``lower(spec)`` runs a
pipeline of semantics-preserving expression passes and returns the
optimized spec together with a per-pass op-delta report, so

  * every executor (oracle, dense torch, the CUDA tile kernel) evaluates
    the *optimized* trees — fewer ops per cell reach the device;
  * the analytical model ranks parallelism configurations from
    post-optimization op counts (``ops_per_cell`` of the lowered spec),
    not the raw DSL's.

Passes (all pure ``Expr -> Expr``, applied per stage):

  fold-constants        ``2*3 -> 6``, ``max(1,2) -> 2``, ``-(4) -> -4``
  simplify-algebraic    ``x*1 -> x``, ``x+0 -> x``, ``0*x -> 0``,
                        ``x/1 -> x``, ``--x -> x``
  cse                   repeated ``Ref`` taps and repeated sub-trees within
                        a stage are bound once via :class:`Let`/:class:`Var`

The pipeline is idempotent: ``lower(lower(spec).spec)`` is a fixpoint, so
caches and serving layers may lower defensively.

Note the usual caveat: ``0*x -> 0`` (like any compiler's fast-math
constant folding) does not preserve NaN/Inf propagation from ``x``.
Stencil kernels stream finite grids, so the trade matches the paper's
FPGA datapath, which never materialises the multiply either.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from repro_torch.core.spec import (
    BinOp,
    Call,
    Expr,
    Let,
    Neg,
    Num,
    StencilSpec,
    Var,
    count_ops,
    walk,
)

Pass = Callable[[Expr], Expr]


# --------------------------------------------------------------------------
# Generic tree rebuilding
# --------------------------------------------------------------------------


def _map_children(expr: Expr, fn: Pass) -> Expr:
    """Rebuild one node with ``fn`` applied to each child."""
    if isinstance(expr, BinOp):
        return BinOp(expr.op, fn(expr.lhs), fn(expr.rhs), span=expr.span)
    if isinstance(expr, Call):
        return Call(expr.fn, tuple(fn(a) for a in expr.args), span=expr.span)
    if isinstance(expr, Neg):
        return Neg(fn(expr.arg), span=expr.span)
    if isinstance(expr, Let):
        return Let(
            tuple((n, fn(e)) for n, e in expr.bindings), fn(expr.body),
            span=expr.span,
        )
    return expr  # Num, Ref, Var


def _keep_span(new: Expr, old: Expr) -> Expr:
    """Carry the rewritten node's source span onto its replacement.

    Spans are excluded from structural equality, so passes would silently
    drop them; a folded/simplified node inherits the location of the
    expression it replaced, keeping analyzer diagnostics pointable after
    lowering.
    """
    if new is not old and new.span is None and old.span is not None:
        return dataclasses.replace(new, span=old.span)
    return new


def _bottom_up(expr: Expr, rule: Pass) -> Expr:
    """Apply ``rule`` to every node, children first, to a local fixpoint.

    A rewrite can expose another at the same node (``0-(0-x)`` becomes
    ``--x`` becomes ``x``), so the rule re-applies until the node is
    stable; children of a rewritten node are already simplified.
    """
    e = _map_children(expr, lambda c: _bottom_up(c, rule))
    while True:
        e2 = _keep_span(rule(e), e)
        if e2 == e:
            return e
        e = e2


# --------------------------------------------------------------------------
# Pass: constant folding
# --------------------------------------------------------------------------


def _fold_rule(expr: Expr) -> Expr:
    if isinstance(expr, Neg) and isinstance(expr.arg, Num):
        return Num(-expr.arg.value)
    if (
        isinstance(expr, BinOp)
        and isinstance(expr.lhs, Num)
        and isinstance(expr.rhs, Num)
    ):
        a, b = expr.lhs.value, expr.rhs.value
        if expr.op == "+":
            return Num(a + b)
        if expr.op == "-":
            return Num(a - b)
        if expr.op == "*":
            return Num(a * b)
        if expr.op == "/" and b != 0.0:
            return Num(a / b)
    if isinstance(expr, Call) and all(
        isinstance(a, Num) for a in expr.args
    ):
        vals = [a.value for a in expr.args]
        if expr.fn == "abs":
            return Num(abs(vals[0]))
        if expr.fn == "max":
            return Num(max(vals))
        if expr.fn == "min":
            return Num(min(vals))
    return expr


def fold_constants(expr: Expr) -> Expr:
    """Evaluate every constant sub-tree at lowering time.

    Folding uses Python float (f64) arithmetic — identical to what
    ``eval_expr`` would have computed for the same ``Num`` nodes at run
    time, so results are bit-identical, not merely close.
    """
    return _bottom_up(expr, _fold_rule)


# --------------------------------------------------------------------------
# Pass: algebraic simplification
# --------------------------------------------------------------------------


def _is_num(e: Expr, v: float) -> bool:
    return isinstance(e, Num) and e.value == v


def _simplify_rule(expr: Expr) -> Expr:
    if isinstance(expr, Neg) and isinstance(expr.arg, Neg):
        return expr.arg.arg                      # --x -> x
    if isinstance(expr, BinOp):
        lhs, rhs = expr.lhs, expr.rhs
        if expr.op == "+":
            if _is_num(lhs, 0.0):
                return rhs                       # 0+x -> x
            if _is_num(rhs, 0.0):
                return lhs                       # x+0 -> x
        elif expr.op == "-":
            if _is_num(rhs, 0.0):
                return lhs                       # x-0 -> x
            if _is_num(lhs, 0.0):
                return Neg(rhs)                  # 0-x -> -x
        elif expr.op == "*":
            if _is_num(lhs, 1.0):
                return rhs                       # 1*x -> x
            if _is_num(rhs, 1.0):
                return lhs                       # x*1 -> x
            if _is_num(lhs, 0.0) or _is_num(rhs, 0.0):
                return Num(0.0)                  # 0*x -> 0 (fast-math)
        elif expr.op == "/":
            if _is_num(rhs, 1.0):
                return lhs                       # x/1 -> x
    return expr


def simplify_algebraic(expr: Expr) -> Expr:
    """Strip identity/annihilator ops (``x*1``, ``x+0``, ``0*x``, ``--x``)."""
    return _bottom_up(expr, _simplify_rule)


# --------------------------------------------------------------------------
# Pass: common-subexpression elimination (per stage)
# --------------------------------------------------------------------------


def _count_subtrees(expr: Expr, counts: dict) -> None:
    for node in walk(expr):
        if isinstance(node, (Num, Var)):
            continue            # trivial leaves: binding them saves nothing
        counts[node] = counts.get(node, 0) + 1


def eliminate_common_subexpressions(expr: Expr) -> Expr:
    """Bind every repeated sub-tree (including repeated ``Ref`` taps) once.

    Frozen-dataclass structural equality makes repeated sub-trees hash
    equal, so one dictionary pass finds them; the rewrite is top-down with
    inner repeats bound before the outer tree that contains them, giving a
    well-ordered ``Let``.  Repeated ``Ref``s carry no ops but deduplicate
    taps; repeated operator trees strictly reduce ``ops_per_cell``.
    """
    counts: dict = {}
    _count_subtrees(expr, counts)
    repeated = {t for t, c in counts.items() if c >= 2}
    if not repeated:
        return expr
    bindings: list[tuple[str, Expr]] = []
    assigned: dict = {}

    def rebuild(e: Expr) -> Expr:
        if e in repeated:
            if e not in assigned:
                inner = _map_children(e, rebuild)
                name = f"_t{len(bindings)}"
                assigned[e] = name
                bindings.append((name, inner))
            return Var(assigned[e])
        return _map_children(e, rebuild)

    body = rebuild(expr)
    return Let(tuple(bindings), body)


# --------------------------------------------------------------------------
# Pass manager
# --------------------------------------------------------------------------

DEFAULT_PASSES: tuple[tuple[str, Pass], ...] = (
    ("fold-constants", fold_constants),
    ("simplify-algebraic", simplify_algebraic),
    ("cse", eliminate_common_subexpressions),
)


@dataclasses.dataclass(frozen=True)
class PassReport:
    """Op-count delta of one pass over the whole spec."""

    name: str
    ops_before: int
    ops_after: int

    @property
    def delta(self) -> int:
        return self.ops_before - self.ops_after

    def __str__(self):
        return f"{self.name}: {self.ops_before} -> {self.ops_after} ops"


@dataclasses.dataclass(frozen=True)
class LoweredSpec:
    """Result of :func:`lower`: the optimized spec plus per-pass deltas."""

    spec: StencilSpec
    reports: tuple[PassReport, ...]

    @property
    def ops_per_cell(self) -> int:
        return self.spec.ops_per_cell

    @property
    def ops_removed(self) -> int:
        return sum(r.delta for r in self.reports)

    def summary(self) -> str:
        raw = self.reports[0].ops_before if self.reports else self.ops_per_cell
        lines = [
            f"{self.spec.name}: {raw} -> {self.ops_per_cell} ops/cell"
        ] + [f"  {r}" for r in self.reports]
        return "\n".join(lines)


def lower(
    spec: StencilSpec,
    passes: Sequence[tuple[str, Pass]] = DEFAULT_PASSES,
) -> LoweredSpec:
    """Run the pass pipeline over every stage of ``spec``.

    Returns a :class:`LoweredSpec` whose ``spec`` is semantically identical
    to the input (every executor produces the same grids) but whose
    expression trees are optimized, and whose ``reports`` record the op
    delta each pass achieved.  The optimized spec is what the analytical
    model ranks and what every executor compiles.
    """
    stages = list(spec.stages)
    reports = []
    for name, fn in passes:
        before = sum(count_ops(st.expr) for st in stages)
        stages = [
            dataclasses.replace(st, expr=fn(st.expr)) for st in stages
        ]
        after = sum(count_ops(st.expr) for st in stages)
        reports.append(PassReport(name, before, after))
    out = dataclasses.replace(spec, stages=tuple(stages))
    out.validate()
    return LoweredSpec(spec=out, reports=tuple(reports))


# --------------------------------------------------------------------------
# Error-relevant op metadata (for the certified-numerics analysis)
# --------------------------------------------------------------------------

#: BinOp kinds that round their result (each charges one unit roundoff in
#: the certified-numerics analysis).  Division is charged extra headroom
#: there: backends may rewrite ``x / c`` into ``x * (1/c)``.
ROUNDED_OPS = frozenset({"+", "-", "*", "/"})

#: Ops that are exact in floating point (no new rounding error): negation
#: and compare-select intrinsics propagate their argument's error bound
#: unchanged; ``abs`` only flips a sign bit.
EXACT_OPS = frozenset({"neg", "abs", "max", "min"})


def rounding_profile(expr: Expr) -> dict[str, int]:
    """Count of *rounded* float ops per kind, ``Let`` bindings counted once.

    The per-op census behind the first-order error model: a bound of
    roughly ``sum(counts) * u * magnitude`` per stage application.
    ``walk`` yields each binding's sub-tree a single time, so the counts
    reflect what a CSE'd evaluation actually executes.
    """
    profile: dict[str, int] = {}
    for node in walk(expr):
        if isinstance(node, BinOp) and node.op in ROUNDED_OPS:
            profile[node.op] = profile.get(node.op, 0) + 1
    return profile


# --------------------------------------------------------------------------
# Utilities
# --------------------------------------------------------------------------


def inline_lets(expr: Expr, _env: dict | None = None) -> Expr:
    """Substitute every ``Var`` by its bound sub-tree (undoes CSE).

    Used by the DSL pretty-printer: ``Let`` has no surface syntax, so a
    lowered spec is printed with bindings expanded back in place.
    """
    env = dict(_env) if _env else {}
    if isinstance(expr, Var):
        return env[expr.name]
    if isinstance(expr, Let):
        for name, bound in expr.bindings:
            env[name] = inline_lets(bound, env)
        return inline_lets(expr.body, env)
    return _map_children(expr, lambda e: inline_lets(e, env))
