"""The port's cross-executor conformance suite, held to the reference's.

The counterpart of ``tests/test_conformance.py`` for ``repro_torch``.
The cases come from ``tests/_torch_conformance_cases.py``, the port's
copy of the reference's generator and numpy oracle (no JAX), which the
first layer holds bitwise to the reference's.  Every case then runs
through each executor of the port that the reference's ``check_case``
names, on the CPU:

  * ``kernels/ref`` (the oracle the port tests against elsewhere);
  * the fused trapezoid, ``stencil_run(backend="torch", s=2)``;
  * the tile program of K1, ``stencil_run(backend="cuda", s=2)`` on the
    CPU (the CUDA kernel's plain version), 4 cells a side, every seed;
  * the bucketed runner (``build_bucket_runner``: streamed mask,
    halo-index maps, wrap margins) with ``temporal(s=2)`` and an 8-row
    tile on the bucket ``ShapeBucketer`` picks; periodic specs also
    through the narrow-margin wrap maps the one-device server uses.

Each result is held within the reference's certified bound
(``repro.core.numerics.tolerance_for``) of the numpy oracle and within
``RTOL = ATOL = 2e-4`` x max(1, max|want|), as ``check_case`` does.

Layers: generator parity, the 200 seed-pinned specs (20 blocks of 10),
the regression corpus, a hypothesis fuzz (``ci`` profile capped at 15
examples; ``HYPOTHESIS_PROFILE=nightly`` searches deeper), and a post-hoc
check that the bound is sound and tighter than the legacy backstop.
``chip_smoke.py``'s phase ``conformance`` runs the CUDA kernels on the
same cases on the card.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import math
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_conformance_cases as cases
import test_conformance
from repro.core import dsl as ref_dsl
from repro.core import numerics as ref_numerics
from repro.core import spec as ref_spec_mod

from repro_torch.core import dsl as pt_dsl
from repro_torch.core import spec as pt_spec_mod
from repro_torch.core.ir import lower
from repro_torch.core.model import ParallelismConfig
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
from repro_torch.kernels import ops
from repro_torch.runtime import (
    ShapeBucketer,
    build_bucket_runner,
    padded_request_shape,
)

RTOL, ATOL = cases.RTOL, cases.ATOL
ULP = float(np.finfo(np.float32).eps)
N_BLOCKS, BLOCK = 20, 10          # 200 specs; K1's tile program on every seed
BUCKET_CFG = ParallelismConfig("temporal", k=1, s=2, tile_rows=8)
CORPUS_SEEDS = [s for s, _ in cases.REGRESSION_CORPUS]


def to_ref(obj):
    """A port spec (or expression, stage, boundary) as the reference's
    classes of the same names, field by field (spans dropped)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = getattr(ref_spec_mod, type(obj).__name__)
        assert getattr(pt_spec_mod, type(obj).__name__) is type(obj)
        return cls(**{
            f.name: to_ref(getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.name != "span"
        })
    if isinstance(obj, tuple):
        return tuple(to_ref(x) for x in obj)
    if isinstance(obj, dict):
        return {k: to_ref(v) for k, v in obj.items()}
    return obj


# --------------------------------------------------------------------------
# Generator and oracle parity with the reference
# --------------------------------------------------------------------------


def check_parity(seed: int) -> None:
    spec, arrays, iters = cases.random_spec(seed)
    rspec, rarrays, riters = test_conformance.random_spec(seed)
    assert to_ref(spec) == rspec, f"seed {seed}: spec differs"
    assert pt_dsl.format_spec(spec) == ref_dsl.format_spec(rspec), seed
    assert iters == riters and list(arrays) == list(rarrays), seed
    for n, a in rarrays.items():
        assert arrays[n].dtype == a.dtype, (seed, n)
        np.testing.assert_array_equal(arrays[n], a, err_msg=f"seed {seed} {n}")
    np.testing.assert_array_equal(
        cases.numpy_oracle(spec, arrays, iters),
        test_conformance.numpy_oracle(rspec, rarrays, riters),
        err_msg=f"seed {seed}: oracle differs",
    )


@pytest.mark.parametrize("block", range(N_BLOCKS))
def test_generator_matches_reference_block(block):
    for seed in range(block * BLOCK, (block + 1) * BLOCK):
        check_parity(seed)


def test_generator_matches_reference_corpus():
    """The port's corpus holds the reference's (a seed a port run finds
    is pinned in the port's alone), and every seed of it is generated
    as the reference generates it."""
    assert set(test_conformance.REGRESSION_CORPUS) <= set(
        cases.REGRESSION_CORPUS)
    assert to_ref(cases.BOUNDARIES) == test_conformance.BOUNDARIES
    for seed in CORPUS_SEEDS:
        check_parity(seed)


# --------------------------------------------------------------------------
# Differential check
# --------------------------------------------------------------------------

# Per-case stats of check_case: the certified bound, the legacy backstop,
# the worst divergence of any executor, the output scale.  The post-hoc
# test_certified_bounds_tight_and_not_vacuous reads them.
_CORPUS_STATS: list[dict] = []


def check_case(spec: StencilSpec, arrays: dict, iters: int,
               want: np.ndarray, label: str) -> dict:
    """Run every executor on one case and hold it to the oracle within
    the reference's certified bound; returns the case's stats."""
    msg = (f"{label}: {spec.boundary.kind} {spec.ndim}-D {spec.shape} "
           f"it={iters} r={spec.radius}")
    certified = ref_numerics.tolerance_for(to_ref(spec), iters, arrays)
    assert math.isfinite(certified), f"{msg}: certified bound not finite"
    scale = float(np.abs(want).max())
    legacy = ATOL * max(1.0, scale)
    atol = max(certified, legacy)
    low = lower(spec).spec
    worst = {}

    def gate(got, name):
        got = np.asarray(got)
        diff = float(np.abs(got - want).max())
        worst[name] = diff
        assert diff <= certified, (
            f"{msg} [{name}]: measured divergence {diff:.3g} exceeds "
            f"the certified bound {certified:.3g}")
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol,
                                   err_msg=f"{msg} [{name}]")

    gate(ops.stencil_run(spec, arrays, iters, backend="ref", device="cpu"),
         "ref")
    gate(ops.stencil_run(low, arrays, iters, s=2, backend="torch",
                         device="cpu"), "trapezoid")
    gate(ops.stencil_run(low, arrays, iters, s=2, tile=(4,) * spec.ndim,
                         backend="cuda", device="cpu"), "k1_tile_program")
    batch = {n: a[None] for n, a in arrays.items()}
    wraps = [None, 2] if spec.boundary.kind == "periodic" else [None]
    for wrap in wraps:
        bucket = ShapeBucketer().bucket_for(
            padded_request_shape(spec, spec.shape, iters, wrap))
        run = build_bucket_runner(low, bucket, BUCKET_CFG, iterations=iters,
                                  device="cpu", wrap_rounds=wrap)
        assert run.tile[0] == 8, run.tile
        name = "bucketed" if wrap is None else "bucketed_wrap"
        gate(run(batch)[0], name)
    stats = dict(label=label, certified=certified, legacy=legacy,
                 measured=max(worst.values()), scale=scale, worst=worst)
    _CORPUS_STATS.append(stats)
    return stats


def check_seed(seed: int) -> dict:
    spec, arrays, iters = cases.random_spec(seed)
    want = cases.numpy_oracle(spec, arrays, iters)
    assert np.isfinite(want).all(), f"seed {seed}: oracle not finite"
    return check_case(spec, arrays, iters, want, f"seed {seed}")


# --------------------------------------------------------------------------
# The floor: 200 seed-pinned random specs, and the regression corpus
# --------------------------------------------------------------------------


@pytest.mark.parametrize("block", range(N_BLOCKS))
def test_conformance_random_block(block):
    for seed in range(block * BLOCK, (block + 1) * BLOCK):
        check_seed(seed)


@pytest.mark.parametrize("seed", CORPUS_SEEDS,
                         ids=[f"seed{s}" for s in CORPUS_SEEDS])
def test_conformance_corpus(seed):
    check_seed(seed)


def test_boundary_modes_all_covered():
    """The seed-cycling generator covers all 4 modes in every block."""
    kinds = {cases.random_spec(s)[0].boundary.kind for s in range(8)}
    assert kinds == {"zero", "constant", "replicate", "periodic"}


def test_numpy_oracle_matches_known_jacobi():
    """Anchor the port's oracle against a hand-checkable case."""
    jac = StencilSpec(
        name="J", iterations=1,
        inputs={"a": ("float32", (3, 3))},
        stages=(Stage("o", "float32", BinOp(
            "+", Ref("a", (0, 0)), Ref("a", (0, 1))), True),),
        iterate_input="a",
        boundary=Boundary("periodic"),
    )
    x = np.arange(9, dtype=np.float32).reshape(3, 3)
    got = cases.numpy_oracle(jac, {"a": x}, 1)
    np.testing.assert_array_equal(got, x + np.roll(x, -1, axis=1))


# --------------------------------------------------------------------------
# Hypothesis fuzzing beyond the pinned range (ci-capped; nightly deep)
# --------------------------------------------------------------------------

import hypothesis  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

settings.register_profile(
    "ci", max_examples=15, deadline=None,
    suppress_health_check=list(hypothesis.HealthCheck),
)
settings.register_profile(
    "nightly", max_examples=1000, deadline=None,
    suppress_health_check=list(hypothesis.HealthCheck),
)
settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "ci"))


def _expr_strategy(readable, ndim, radius):
    """Random expression trees over ``readable``, drawn structurally (a
    failing case shrinks to a smaller spec, not to another seed)."""
    offsets = st.tuples(*[st.integers(-radius, radius) for _ in range(ndim)])
    tap = st.builds(Ref, st.sampled_from(readable), offsets)
    const = st.builds(lambda m: Num(m / 1000.0), st.integers(-2000, 2000))
    leaf = st.one_of(tap, const)

    def extend(inner):
        return st.one_of(
            st.builds(Neg, inner),
            st.builds(BinOp, st.sampled_from("+-*"), inner, inner),
            # division only by non-zero constants (bucketable)
            st.builds(lambda l, m: BinOp("/", l, Num(1.5 + m / 1000.0)),
                      inner, st.integers(0, 2500)),
            st.builds(lambda fn, args: Call(fn, tuple(args)),
                      st.sampled_from(["max", "min"]),
                      st.lists(inner, min_size=2, max_size=3)),
            st.builds(lambda a: Call("abs", (a,)), inner),
        )

    expr = st.recursive(leaf, extend, max_leaves=8)
    return expr.map(
        lambda e: e if any(isinstance(n, Ref) for n in cases.walk(e))
        else BinOp("+", e, Ref(readable[0], (0,) * ndim))
    )


@st.composite
def conformance_cases(draw):
    ndim = draw(st.sampled_from([2, 2, 2, 3]))
    hi = 9 if ndim == 2 else 6
    shape = tuple(draw(st.integers(4, hi)) for _ in range(ndim))
    radius = draw(st.integers(1, 2)) if ndim == 2 else 1
    iterations = draw(st.integers(1, 3))
    boundary = draw(st.sampled_from(cases.BOUNDARIES))
    n_inputs = draw(st.integers(1, 2))
    inputs = {f"in_{i}": ("float32", shape) for i in range(n_inputs)}
    iterate = f"in_{draw(st.integers(0, n_inputs - 1))}"
    readable = list(inputs)
    stages = []
    if draw(st.booleans()):
        stages.append(Stage(
            "tmp", "float32", draw(_expr_strategy(readable, ndim, 1)), False))
        readable.append("tmp")
    stages.append(Stage(
        "out", "float32", draw(_expr_strategy(readable, ndim, radius)), True))
    spec = StencilSpec(
        name="CONF-HYP", iterations=iterations, inputs=inputs,
        stages=tuple(stages), iterate_input=iterate, boundary=boundary,
    )
    spec.validate()
    rng = np.random.default_rng(draw(st.integers(0, 2**31 - 1)))
    arrays = {n: rng.standard_normal(shape).astype(np.float32) for n in inputs}
    return spec, arrays, iterations


@given(case=conformance_cases())
def test_conformance_hypothesis_fuzz(case):
    spec, arrays, iters = case
    want = cases.numpy_oracle(spec, arrays, iters)
    # iterated random products can overflow float32: not a conformance
    # question
    hypothesis.assume(np.isfinite(want).all())
    check_case(spec, arrays, iters, want, "hyp")


# --------------------------------------------------------------------------
# Certified-bound quality over the corpus (after the block tests: pytest
# runs a module's tests in definition order)
# --------------------------------------------------------------------------


def test_certified_bounds_tight_and_not_vacuous():
    """Over every seed-pinned case, each executor's divergence is within
    the certified bound, the bound never exceeds the legacy backstop,
    and the corpus-median bound/measured ratio stays within
    ``NONVACUITY_SLACK`` (the reference's claims, for the port's
    executors).  Seeds this session has not checked yet are checked here
    first, so the test never depends on the others having run."""
    seen = {s["label"] for s in _CORPUS_STATS}
    for seed in [*range(N_BLOCKS * BLOCK), *CORPUS_SEEDS]:
        if f"seed {seed}" not in seen:
            check_seed(seed)
    by_label = {s["label"]: s for s in _CORPUS_STATS
                if s["label"].startswith("seed ")}
    stats = list(by_label.values())
    assert len(stats) == N_BLOCKS * BLOCK + len(CORPUS_SEEDS)
    unsound = [(s["label"], name) for s in stats
               for name, d in s["worst"].items() if d > s["certified"]]
    assert not unsound, unsound[:5]
    loose = [s["label"] for s in stats if s["certified"] > s["legacy"]]
    assert not loose, f"certified bound above the legacy one: {loose[:3]}"
    ratios = sorted(
        s["certified"] / max(s["measured"], ULP * max(1.0, s["scale"]))
        for s in stats
    )
    median = ratios[len(ratios) // 2]
    assert median <= ref_numerics.NONVACUITY_SLACK, median


# --------------------------------------------------------------------------
# The card's phase, rehearsed here; the audit of this file
# --------------------------------------------------------------------------

ROOT = Path(__file__).resolve().parents[1]


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_card_phase_rehearsal_on_cpu():
    """``chip_smoke.py``'s phase ``conformance`` on the CPU, where its
    kernel calls run the plain versions: all 48 specs on their own and
    on the large grids, every executor within its certified bound, K2
    bitwise K1; the large grids need no library of their own."""
    from repro_torch.kernels import pipeline, stencil

    smoke = _load(ROOT / "chip_smoke.py", "_chip_smoke_conformance")
    k1, k2 = stencil.stencil_cuda.plain_calls, \
        pipeline.stencil_cuda_batched.plain_calls
    got = smoke.conformance_phase(ROOT, torch.device("cpu"))
    assert (got["specs"], got["runs"], got["kernels"], got["compiles"]) == (
        len(cases.CARD_SEEDS), 2 * len(cases.CARD_SEEDS),
        2 * len(cases.CARD_SEEDS), 0)
    assert set(got["worst_ratio_by_kind"]) == {
        "zero", "constant", "replicate", "periodic"}
    assert set(got["worst_ratio_by_executor"]) == {
        "k1_tile4", "k1_default", "bucketed", "bucketed_wrap"}
    assert max(got["worst_ratio_by_kind"].values()) <= 1.0
    assert got["k1_vs_plain_max_rel"] == 0.0 and got["k2_bitwise"]
    assert stencil.stencil_cuda.plain_calls > k1
    assert pipeline.stencil_cuda_batched.plain_calls > k2


def test_port_audit_holds_and_catches_a_raised_cap(tmp_path, capsys):
    """``scripts/audit_slow_markers_torch.py`` passes on this file and
    fails when the ci profile's cap passes 50 or the floor drops."""
    audit = _load(ROOT / "scripts" / "audit_slow_markers_torch.py",
                  "_port_audit")
    audit.main()
    text = audit.SUITE.read_text()
    for old, new in (('"ci", max_examples=15', '"ci", max_examples=100'),
                     ("N_BLOCKS, BLOCK = 20, 10", "N_BLOCKS, BLOCK = 10, 10")):
        assert old in text
        bad = tmp_path / "suite.py"
        bad.write_text(text.replace(old, new))
        audit.SUITE = bad
        with pytest.raises(SystemExit):
            audit.main()
        assert "FAIL" in capsys.readouterr().out
