"""The conformance suite's cases in the port's spec classes, without JAX.

A copy of ``tests/test_conformance.py``'s seeded random-spec generator
(``random_spec``), its pure-numpy oracle (``numpy_oracle``), its boundary
matrix and its regression corpus, built on ``repro_torch.core.spec``.  It
imports only numpy and ``repro_torch``, so the CPU suite
(``tests/test_torch_conformance.py``, which holds it bitwise to the
reference's) and ``chip_smoke.py``'s phase ``conformance`` on the card
share it.  The generator draws exactly as the reference's does: the same
seed gives the same spec, arrays and iterations.

``large_case`` puts a seed's spec on a grid large enough for interior
blocks of the tile kernel's default tile, with arrays drawn from the seed;
``batch_of`` stacks a case's arrays with more entries drawn from
``seed + 10000``, as the reference's batch-in-grid check does.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.spec import (
    BinOp,
    Boundary,
    Call,
    Neg,
    Num,
    Ref,
    Stage,
    StencilSpec,
)

# Legacy executor tolerance against the oracle (rtol = atol, scaled by
# max(1, max|want|)), the regression backstop beside the certified bound.
RTOL = ATOL = 2e-4

BOUNDARIES = (
    Boundary("zero"),
    Boundary("constant", 1.5),
    Boundary("replicate"),
    Boundary("periodic"),
)

# Seeds replayed beyond the pinned 0..199 range, each with the trait it
# pins (the reference's REGRESSION_CORPUS).
REGRESSION_CORPUS = [
    (201, "constant 3-D two-input spec iterating the second input"),
    (203, "periodic 3-D with a local stage chain (wrap on 3 dims)"),
    (207, "periodic 2-D iterations=3 (widest wrap margin in suite)"),
    (209, "constant 2-D radius-2 with a local stage"),
    (210, "replicate 2-D radius-2 taps (halo-index gather depth 2)"),
    (212, "zero-boundary two-input local-stage chain, ragged 8x5"),
    (226, "replicate 2-D it=3 with value blow-up (scale-aware tolerance)"),
    (250, "replicate pow2 rows: real/belt edge on a bucket-rung boundary"),
]

# The seeds chip_smoke.py's phase ``conformance`` runs on the card: every
# fifth pinned seed (ten of each boundary kind) and the corpus.
CARD_SEEDS = [*range(0, 200, 5), *(s for s, _ in REGRESSION_CORPUS)]

# Grids with interior blocks on the default tile (kernels/stencil.py
# DEFAULT_TILES: 32x64 in 2-D, 8x8x32 in 3-D) at the largest halo a
# generated spec has at s = 2 (6 in 2-D, 4 in 3-D): an interior block
# needs 2 * tile + halo cells on an axis.
LARGE_2D, LARGE_3D = (256, 192), (48, 40, 72)


# --------------------------------------------------------------------------
# Pure-numpy oracle
# --------------------------------------------------------------------------


def _np_pad(a: np.ndarray, r: int, boundary: Boundary) -> np.ndarray:
    pads = [(r, r)] * a.ndim
    k = boundary.kind
    if k == "zero":
        return np.pad(a, pads)
    if k == "constant":
        return np.pad(a, pads, constant_values=boundary.value)
    if k == "replicate":
        return np.pad(a, pads, mode="edge")
    return np.pad(a, pads, mode="wrap")


def _np_eval(expr, get_ref):
    if isinstance(expr, Num):
        return expr.value
    if isinstance(expr, Ref):
        return get_ref(expr.name, expr.offsets)
    if isinstance(expr, Neg):
        return -_np_eval(expr.arg, get_ref)
    if isinstance(expr, BinOp):
        lhs = _np_eval(expr.lhs, get_ref)
        rhs = _np_eval(expr.rhs, get_ref)
        return {"+": np.add, "-": np.subtract,
                "*": np.multiply, "/": np.divide}[expr.op](lhs, rhs)
    if isinstance(expr, Call):
        args = [_np_eval(a, get_ref) for a in expr.args]
        if expr.fn == "abs":
            return np.abs(args[0])
        acc = args[0]
        for a in args[1:]:
            acc = np.maximum(acc, a) if expr.fn == "max" else np.minimum(acc, a)
        return acc
    raise TypeError(f"oracle cannot evaluate {expr!r}")


def numpy_oracle(
    spec: StencilSpec, arrays: dict, iterations: int
) -> np.ndarray:
    """Iterate ``spec`` entirely in numpy with exact boundary semantics."""
    env = {n: np.asarray(a) for n, a in arrays.items()}
    out = env[spec.iterate_input]
    shape = out.shape
    for _ in range(iterations):
        stage_env = dict(env)
        for stage in spec.stages:
            r = stage.radius
            padded = {
                n: _np_pad(a, r, spec.boundary)
                for n, a in stage_env.items()
            }

            def get_ref(name, offsets, padded=padded, r=r):
                idx = tuple(
                    slice(r + o, r + o + s) for o, s in zip(offsets, shape)
                )
                return padded[name][idx]

            res = _np_eval(stage.expr, get_ref)
            stage_env[stage.name] = np.asarray(
                np.broadcast_to(res, shape), dtype=stage.dtype
            )
        out = stage_env[spec.output_name]
        env[spec.iterate_input] = out
    return out


# --------------------------------------------------------------------------
# Seeded random-spec generator
# --------------------------------------------------------------------------


def _random_expr(rng, readable, ndim, radius, depth):
    """Random expression over the readable arrays, taps within ``radius``."""

    def tap():
        name = readable[rng.integers(len(readable))]
        offs = tuple(int(rng.integers(-radius, radius + 1))
                     for _ in range(ndim))
        return Ref(name, offs)

    def leaf():
        if rng.random() < 0.3:
            return Num(round(float(rng.uniform(-2.0, 2.0)), 3))
        return tap()

    def build(d):
        if d <= 0:
            return leaf()
        roll = rng.random()
        if roll < 0.15:
            return Neg(build(d - 1))
        if roll < 0.30:
            fn = ("max", "min", "abs")[rng.integers(3)]
            n_args = 1 if fn == "abs" else int(rng.integers(2, 4))
            return Call(fn, tuple(build(d - 1) for _ in range(n_args)))
        if roll < 0.40:
            # division only by non-zero constants: division by streamed
            # data is not bucketable (check_bucketable) by design
            return BinOp("/", build(d - 1),
                         Num(round(float(rng.uniform(1.5, 4.0)), 3)))
        op = "+-*"[rng.integers(3)]
        return BinOp(op, build(d - 1), build(d - 1))

    expr = build(depth)
    if not any(isinstance(n, Ref) for n in walk(expr)):
        expr = BinOp("+", expr, tap())   # every stage taps streamed data
    return expr


def walk(expr):
    """Every node of an un-lowered expression tree, root first."""
    yield expr
    if isinstance(expr, BinOp):
        yield from walk(expr.lhs)
        yield from walk(expr.rhs)
    elif isinstance(expr, Call):
        for a in expr.args:
            yield from walk(a)
    elif isinstance(expr, Neg):
        yield from walk(expr.arg)


def random_spec(seed: int):
    """Deterministic ``(spec, arrays, iterations)`` for one seed.

    Small grids (4-9 cells a side) and shallow trees; arity, local
    stages, tap radius, iterate-input choice, boundary mode and grid
    raggedness all vary.  The boundary mode cycles with the seed.
    """
    rng = np.random.default_rng(seed)
    ndim = 2 if rng.random() < 0.75 else 3
    if ndim == 2:
        shape = tuple(int(rng.integers(4, 10)) for _ in range(2))
        radius = int(rng.integers(1, 3))
        depth = int(rng.integers(1, 4))
    else:
        shape = tuple(int(rng.integers(4, 7)) for _ in range(3))
        radius = 1
        depth = int(rng.integers(1, 3))
    iterations = int(rng.integers(1, 4)) if ndim == 2 else int(
        rng.integers(1, 3)
    )
    boundary = BOUNDARIES[seed % len(BOUNDARIES)]

    n_inputs = int(rng.integers(1, 3))
    inputs = {
        f"in_{i}": ("float32", shape) for i in range(n_inputs)
    }
    iterate = f"in_{int(rng.integers(n_inputs))}"
    readable = list(inputs)
    stages = []
    if rng.random() < 0.4:
        stages.append(Stage(
            "tmp", "float32",
            _random_expr(rng, readable, ndim, 1, depth), False,
        ))
        readable.append("tmp")
    stages.append(Stage(
        "out", "float32",
        _random_expr(rng, readable, ndim, radius, depth), True,
    ))
    spec = StencilSpec(
        name=f"CONF-{seed}",
        iterations=iterations,
        inputs=inputs,
        stages=tuple(stages),
        iterate_input=iterate,
        boundary=boundary,
    )
    spec.validate()
    arrays = {
        n: rng.standard_normal(shape).astype(np.float32) for n in inputs
    }
    return spec, arrays, iterations


def with_grid(spec: StencilSpec, shape) -> StencilSpec:
    """``spec`` with every input on a grid of ``shape``."""
    shape = tuple(int(n) for n in shape)
    return dataclasses.replace(spec, inputs={
        n: (dt, shape) for n, (dt, _) in spec.inputs.items()})


def large_case(seed: int):
    """``random_spec(seed)``'s structure on ``LARGE_2D``/``LARGE_3D``, its
    arrays drawn from ``np.random.default_rng(seed)`` at that shape."""
    spec, _, iterations = random_spec(seed)
    shape = LARGE_3D if spec.ndim == 3 else LARGE_2D
    rng = np.random.default_rng(seed)
    arrays = {
        n: rng.standard_normal(shape).astype(np.float32) for n in spec.inputs
    }
    return with_grid(spec, shape), arrays, iterations


def batch_of(seed: int, arrays: dict, batch: int) -> dict:
    """``(batch,) + grid`` arrays: entry 0 is ``arrays``, the others are
    drawn from ``np.random.default_rng(seed + 10000)``."""
    rng = np.random.default_rng(seed + 10_000)
    return {
        n: np.stack([a] + [rng.standard_normal(a.shape).astype(a.dtype)
                           for _ in range(batch - 1)])
        for n, a in arrays.items()
    }
