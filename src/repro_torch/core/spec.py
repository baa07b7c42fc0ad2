"""Stencil specification AST and derived static properties (PyTorch port).

A copy of ``repro.core.spec`` that imports no JAX.  It is produced by
:mod:`repro_torch.core.dsl` and consumed by the torch executors, the CUDA
source generator (:mod:`repro_torch.kernels.cuda_build`) and the
analytical model.  :func:`eval_expr` evaluates intrinsics with
``torch.abs``/``torch.maximum``/``torch.minimum``; a :class:`Num` stays a
Python float, so it takes the tensor's dtype in arithmetic.

Semantics (shared by every executor in the framework):
  * An iteration applies every stage (``local`` stages in declaration order,
    then the ``output`` stage) over the full grid.
  * Reads outside the grid are resolved by the spec's :class:`Boundary`
    rule, at every stage of every iteration (docs/DESIGN.md §Boundary
    semantics).  The default ``zero`` boundary matches a streaming FPGA
    design whose line buffers are zero-initialised and is linear-friendly
    for testing; ``constant``/``replicate``/``periodic`` cover physically
    meaningful edges (fixed temperature, image edge clamping, tori).
  * Between iterations the designated ``iterate`` input is rebound to the
    previous output (ping-pong buffering, Section 2.1 of the SASA paper).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Union

import numpy as np

# --------------------------------------------------------------------------
# Source spans
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SourceSpan:
    """Location of a construct in the DSL text (1-based line / column).

    Attached to AST nodes by the parser and carried into diagnostics
    (static analysis).  For a logical line assembled from
    continuation lines, ``line`` is the first raw line and columns index
    into the joined text.
    """

    line: int
    col: int
    end_col: int

    def __str__(self) -> str:
        return f"{self.line}:{self.col}"


# The span field rides every AST node but is excluded from equality,
# hashing, and repr: structural identity (spec hashing, CSE's repeated-
# subtree table, repr-based cache fingerprints, parse/format round-trip
# equality) must not depend on where a node came from.
def _span_field():
    return dataclasses.field(default=None, compare=False, repr=False)


# --------------------------------------------------------------------------
# Expression AST
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Num:
    value: float
    span: "SourceSpan | None" = _span_field()


@dataclasses.dataclass(frozen=True)
class Ref:
    """Reference to array ``name`` at a constant offset from the output cell."""

    name: str
    offsets: tuple[int, ...]
    span: "SourceSpan | None" = _span_field()


@dataclasses.dataclass(frozen=True)
class BinOp:
    op: str  # '+', '-', '*', '/'
    lhs: "Expr"
    rhs: "Expr"
    span: "SourceSpan | None" = _span_field()


@dataclasses.dataclass(frozen=True)
class Call:
    """Intrinsic function call: max/min/abs over expressions."""

    fn: str
    args: tuple["Expr", ...]
    span: "SourceSpan | None" = _span_field()


@dataclasses.dataclass(frozen=True)
class Neg:
    arg: "Expr"
    span: "SourceSpan | None" = _span_field()


@dataclasses.dataclass(frozen=True)
class Var:
    """Reference to a value bound by an enclosing :class:`Let`."""

    name: str
    span: "SourceSpan | None" = _span_field()


@dataclasses.dataclass(frozen=True)
class Let:
    """Bind sub-expressions once, then evaluate ``body``.

    This is the IR node the CSE pass (:mod:`repro_torch.core.ir`) produces: a
    repeated sub-tree is evaluated a single time and referenced through
    :class:`Var`.  Bindings evaluate in order; later bindings (and the
    body) may reference earlier ones.  ``Var`` names live in a namespace
    separate from array names, so bindings can never shadow an input.
    """

    bindings: tuple[tuple[str, "Expr"], ...]
    body: "Expr"
    span: "SourceSpan | None" = _span_field()


Expr = Union[Num, Ref, BinOp, Call, Neg, Var, Let]

INTRINSICS = ("max", "min", "abs")


def walk(expr: Expr):
    """Yield every node of the expression tree.

    A :class:`Let` binding's sub-tree is yielded once, no matter how many
    ``Var`` references consume it — which is exactly what makes
    :func:`count_ops` report post-CSE op counts.
    """
    yield expr
    if isinstance(expr, BinOp):
        yield from walk(expr.lhs)
        yield from walk(expr.rhs)
    elif isinstance(expr, Call):
        for a in expr.args:
            yield from walk(a)
    elif isinstance(expr, Neg):
        yield from walk(expr.arg)
    elif isinstance(expr, Let):
        for _, bound in expr.bindings:
            yield from walk(bound)
        yield from walk(expr.body)


def refs_in(expr: Expr) -> list[Ref]:
    return [n for n in walk(expr) if isinstance(n, Ref)]


def count_ops(expr: Expr) -> int:
    """Number of algorithmic operations (paper's OPs metric, Fig. 1)."""
    ops = 0
    for node in walk(expr):
        if isinstance(node, BinOp):
            ops += 1
        elif isinstance(node, Call):
            # an n-ary max/min is n-1 compare-select ops
            ops += max(len(node.args) - 1, 1)
        elif isinstance(node, Neg):
            ops += 1
    return ops


# --------------------------------------------------------------------------
# Boundary semantics
# --------------------------------------------------------------------------

BOUNDARY_KINDS = ("zero", "constant", "replicate", "periodic")


@dataclasses.dataclass(frozen=True)
class Boundary:
    """How reads outside the grid resolve (docs/DESIGN.md §Boundary).

      zero        out-of-grid cells read 0 (the seed semantics)
      constant    out-of-grid cells read ``value`` (e.g. fixed-temperature
                  edges in HOTSPOT-style thermal solvers)
      replicate   out-of-grid reads clamp to the nearest edge cell (image
                  filters: BLUR/SOBEL without edge darkening)
      periodic    out-of-grid reads wrap around (torus domains: spectral /
                  molecular-dynamics style HEAT3D)

    The rule applies uniformly to every array — inputs and intermediate
    ``local`` stages alike — at every stage of every iteration.
    """

    kind: str = "zero"
    value: float = 0.0

    def __post_init__(self):
        if self.kind not in BOUNDARY_KINDS:
            raise ValueError(
                f"unknown boundary kind {self.kind!r} "
                f"(expected one of {BOUNDARY_KINDS})"
            )
        if self.kind != "constant" and self.value != 0.0:
            raise ValueError(
                f"boundary value only applies to 'constant', not "
                f"{self.kind!r}"
            )
        if not math.isfinite(self.value):
            # inf/NaN edges poison every neighbouring cell, and the
            # bucketed mask+offset form (v * (1 - m)) would turn them
            # into NaN on IN-grid cells too
            raise ValueError(
                f"boundary constant must be finite, got {self.value!r}"
            )

    @property
    def is_zero(self) -> bool:
        return self.kind == "zero"


ZERO_BOUNDARY = Boundary("zero")


# --------------------------------------------------------------------------
# Dtype float limits (consumed by the certified-numerics analyzer)
# --------------------------------------------------------------------------


def _float_info(dtype: str):
    """``finfo`` for a DSL dtype name (bfloat16 through torch, which numpy
    lacks; the same eps and max as the reference's ``ml_dtypes``)."""
    if str(dtype) == "bfloat16":
        import torch

        return torch.finfo(torch.bfloat16)
    return np.finfo(np.dtype(dtype))


def unit_roundoff(dtype: str) -> float:
    """Per-op relative error budget the numerics analyzer charges ``dtype``.

    This is ``eps`` (the gap from 1.0 to the next float), i.e. **twice**
    the true unit roundoff of a correctly-rounded op (``eps/2``): the
    2x headroom absorbs backends whose ops are faithful rather than
    correctly rounded.
    """
    return float(_float_info(dtype).eps)


def finite_max(dtype: str) -> float:
    """Largest finite value of ``dtype`` (the SASA501 overflow line)."""
    return float(_float_info(dtype).max)


# --------------------------------------------------------------------------
# Stages and the full spec
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Stage:
    """One stencil loop: writes array ``name`` from the expression."""

    name: str
    dtype: str
    expr: Expr
    is_output: bool
    span: "SourceSpan | None" = _span_field()

    @property
    def radius(self) -> int:
        """Chebyshev radius (paper's ``r``): max |offset| over any dim."""
        rad = 0
        for ref in refs_in(self.expr):
            for o in ref.offsets:
                rad = max(rad, abs(int(o)))
        return rad

    @property
    def ops_per_cell(self) -> int:
        return count_ops(self.expr)


@dataclasses.dataclass(frozen=True)
class StencilSpec:
    name: str
    iterations: int
    inputs: Mapping[str, tuple[str, tuple[int, ...]]]  # name -> (dtype, shape)
    stages: tuple[Stage, ...]
    iterate_input: str  # input rebound to the output between iterations
    boundary: Boundary = ZERO_BOUNDARY
    # Streamed halo-index plumbing (docs/DESIGN.md §Boundaries × bucketed
    # serving): when non-empty, one input name per dimension naming an
    # int32 grid-shaped array of *source coordinates*.  After every stage
    # the shared trapezoid helper re-imposes ``out[i, j, ...] =
    # out[idx0[i], idx1[j], ...]`` (per-axis gather), which lets a padded
    # bucket design re-create a smaller real grid's clamped-edge
    # (replicate) exterior from per-request streamed data.  Stages never
    # read these inputs; they ride the executors like any other array.
    halo_index_inputs: tuple[str, ...] = ()
    # Streamed wrap plumbing (narrow periodic bucket margins): when
    # non-empty, one input name per dimension naming an int32 grid-shaped
    # array of *wrap source coordinates* for that axis.  Executors
    # re-impose ``out[i, j, ...] = out[widx0[i], widx1[j], ...]`` on the
    # iterate **between fused rounds** (not per stage), refreshing a
    # ``wrap_round_depth * radius``-deep periodic margin from the real
    # region so the bucket needs only that much margin instead of
    # ``iterations * radius``.  Executors must cap the fused depth they
    # run per round at ``wrap_round_depth``.  Stages never read these
    # inputs.
    wrap_index_inputs: tuple[str, ...] = ()
    wrap_round_depth: int = 0

    def __hash__(self):
        # specs are jit static args; normalise the inputs mapping
        return hash((
            self.name,
            self.iterations,
            tuple((k, v[0], tuple(v[1])) for k, v in self.inputs.items()),
            self.stages,
            self.iterate_input,
            self.boundary,
            self.halo_index_inputs,
            self.wrap_index_inputs,
            self.wrap_round_depth,
        ))

    # ---------------- derived static properties ----------------
    @property
    def ndim(self) -> int:
        return len(next(iter(self.inputs.values()))[1])

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(next(iter(self.inputs.values()))[1])

    @property
    def rows(self) -> int:
        return self.shape[0]

    @property
    def cols_flat(self) -> int:
        """Paper flattens all dims except the first into 'columns' (Sec 4.3)."""
        return int(np.prod(self.shape[1:]))

    @property
    def output_stage(self) -> Stage:
        return self.stages[-1]

    @property
    def output_name(self) -> str:
        return self.output_stage.name

    @property
    def local_stages(self) -> tuple[Stage, ...]:
        return tuple(s for s in self.stages if not s.is_output)

    @property
    def radius(self) -> int:
        """Composite per-iteration radius: stage radii accumulate."""
        return sum(s.radius for s in self.stages)

    @property
    def halo(self) -> int:
        """Paper's halo/delay per iteration: ``halo = d = 2*r`` (Table 2)."""
        return 2 * self.radius

    @property
    def ops_per_cell(self) -> int:
        return sum(s.ops_per_cell for s in self.stages)

    @property
    def points(self) -> int:
        """Number of distinct taps of the composite stencil (for reporting)."""
        return sum(len(set(refs_in(s.expr))) for s in self.stages)

    @property
    def dtype(self) -> str:
        return self.output_stage.dtype

    @property
    def itemsize(self) -> int:
        return 2 if self.dtype == "bfloat16" else np.dtype(self.dtype).itemsize

    @property
    def num_inputs(self) -> int:
        return len(self.inputs)

    @property
    def cells(self) -> int:
        return int(np.prod(self.shape))

    def computation_intensity(self, iterations: int | None = None) -> float:
        """OPs per byte of off-chip traffic assuming optimal reuse (Fig. 1).

        With optimal reuse each input is read once and the output written
        once for the whole iterative run, while compute scales with ``iter``.
        """
        it = self.iterations if iterations is None else iterations
        ops = self.ops_per_cell * self.cells * it
        bytes_moved = (self.num_inputs + 1) * self.cells * self.itemsize
        return ops / bytes_moved

    def validate(self) -> None:
        if self.iterations < 1:
            raise ValueError(
                f"iteration count must be >= 1, got {self.iterations}"
            )
        shapes = {tuple(shape) for _, shape in self.inputs.values()}
        if len(shapes) != 1:
            raise ValueError(f"all inputs must share a shape, got {shapes}")
        if self.iterate_input not in self.inputs:
            raise ValueError(
                f"iterate input {self.iterate_input!r} is not an input"
            )
        known = set(self.inputs)
        for stage in self.stages:
            if stage.name in self.inputs:
                raise ValueError(
                    f"stage {stage.name!r} shadows an input of the same "
                    "name; rename the stage"
                )
            for ref in refs_in(stage.expr):
                if ref.name not in known:
                    raise ValueError(
                        f"stage {stage.name!r} references unknown array "
                        f"{ref.name!r}"
                    )
                if len(ref.offsets) != self.ndim:
                    raise ValueError(
                        f"ref {ref.name}{ref.offsets} has wrong arity for "
                        f"{self.ndim}-D stencil"
                    )
            _check_vars_bound(stage.expr, frozenset(), stage.name)
            known.add(stage.name)
        if not self.stages or not self.stages[-1].is_output:
            raise ValueError("last stage must be the output stage")
        if self.halo_index_inputs:
            if len(self.halo_index_inputs) != self.ndim:
                raise ValueError(
                    f"halo_index_inputs must name one input per dimension "
                    f"({self.ndim}), got {self.halo_index_inputs}"
                )
            for n in self.halo_index_inputs:
                if n not in self.inputs:
                    raise ValueError(
                        f"halo index input {n!r} is not a declared input"
                    )
        if self.wrap_index_inputs:
            if len(self.wrap_index_inputs) != self.ndim:
                raise ValueError(
                    f"wrap_index_inputs must name one input per dimension "
                    f"({self.ndim}), got {self.wrap_index_inputs}"
                )
            for n in self.wrap_index_inputs:
                if n not in self.inputs:
                    raise ValueError(
                        f"wrap index input {n!r} is not a declared input"
                    )
            if self.wrap_round_depth < 1:
                raise ValueError(
                    "wrap_index_inputs requires wrap_round_depth >= 1 "
                    f"(got {self.wrap_round_depth})"
                )
        elif self.wrap_round_depth:
            raise ValueError(
                "wrap_round_depth without wrap_index_inputs has no effect"
            )


def _check_vars_bound(expr: Expr, bound: frozenset, stage: str) -> None:
    """Every Var must be bound by an enclosing Let (in binding order)."""
    if isinstance(expr, Var):
        if expr.name not in bound:
            raise ValueError(
                f"stage {stage!r} has unbound let-variable {expr.name!r}"
            )
    elif isinstance(expr, BinOp):
        _check_vars_bound(expr.lhs, bound, stage)
        _check_vars_bound(expr.rhs, bound, stage)
    elif isinstance(expr, Call):
        for a in expr.args:
            _check_vars_bound(a, bound, stage)
    elif isinstance(expr, Neg):
        _check_vars_bound(expr.arg, bound, stage)
    elif isinstance(expr, Let):
        for name, e in expr.bindings:
            _check_vars_bound(e, bound, stage)
            bound = bound | {name}
        _check_vars_bound(expr.body, bound, stage)


# --------------------------------------------------------------------------
# Expression evaluation (shared by reference executor and kernels)
# --------------------------------------------------------------------------


def eval_expr(
    expr: Expr,
    get_ref: Callable[[str, tuple[int, ...]], "object"],
    _env: Mapping[str, "object"] | None = None,
):
    """Evaluate an expression tree.

    ``get_ref(name, offsets)`` must return a tensor holding
    the referenced array shifted by ``offsets``; all returned arrays must
    share a shape.  Scalars broadcast.  ``_env`` carries :class:`Let`
    bindings — a CSE'd sub-tree is evaluated once per stage application.
    """
    if isinstance(expr, Num):
        return expr.value
    if isinstance(expr, Ref):
        return get_ref(expr.name, expr.offsets)
    if isinstance(expr, Var):
        if _env is None or expr.name not in _env:
            raise ValueError(f"unbound let-variable {expr.name!r}")
        return _env[expr.name]
    if isinstance(expr, Let):
        env = dict(_env) if _env else {}
        for name, bound in expr.bindings:
            env[name] = eval_expr(bound, get_ref, env)
        return eval_expr(expr.body, get_ref, env)
    if isinstance(expr, Neg):
        return -eval_expr(expr.arg, get_ref, _env)
    if isinstance(expr, BinOp):
        lhs = eval_expr(expr.lhs, get_ref, _env)
        rhs = eval_expr(expr.rhs, get_ref, _env)
        if expr.op == "+":
            return lhs + rhs
        if expr.op == "-":
            return lhs - rhs
        if expr.op == "*":
            return lhs * rhs
        if expr.op == "/":
            return lhs / rhs
        raise ValueError(f"unknown op {expr.op!r}")
    if isinstance(expr, Call):
        args = [eval_expr(a, get_ref, _env) for a in expr.args]
        if expr.fn == "abs":
            return _abs(args[0])
        acc = args[0]
        for a in args[1:]:
            acc = _select(acc, a, expr.fn)
        return acc
    raise TypeError(f"unknown expression node {expr!r}")


def _abs(x):
    import torch

    return torch.abs(x) if isinstance(x, torch.Tensor) else abs(x)


def _select(a, b, fn: str):
    """max/min of two operands, either of which may be a Python float."""
    import torch

    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        return max(a, b) if fn == "max" else min(a, b)
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return torch.maximum(a, b) if fn == "max" else torch.minimum(a, b)
