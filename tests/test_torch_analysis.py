"""The port's static analysis and certified numerics against the reference.

``repro_torch.core.analysis`` and ``repro_torch.core.numerics`` are ports
of the reference's pure-Python/numpy modules.  On the mutation corpus of
``tests/test_analysis.py`` they must report the same diagnostic codes,
severities and source spans; they must refuse the same specs for
bucketing; and ``tolerance_for`` must agree to 1e-12 relative on the
stock kernels under all four boundary modes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import test_analysis
import test_conformance
from repro.configs import stencils as ref_stencils
from repro.core import analysis as ref_analysis
from repro.core.autotune import autotune as ref_autotune
from repro.core import dsl as ref_dsl
from repro.core import numerics as ref_numerics

from repro_torch.core import analysis, dsl, numerics
from repro_torch.core.autotune import autotune
from repro_torch.core.model import ParallelismConfig
from repro_torch.core.platform import DEFAULT_GPU


def _port(ref_spec):
    return dsl.parse(ref_dsl.format_spec(ref_spec))


def _key(diags):
    return [
        (d.code, d.severity, d.stage,
         None if d.span is None else (d.span.line, d.span.col, d.span.end_col))
        for d in diags
    ]


@pytest.mark.parametrize(
    "text,code,severity,loc", test_analysis.MUTATIONS,
    ids=[m[1] for m in test_analysis.MUTATIONS],
)
def test_mutation_corpus_matches_reference(text, code, severity, loc):
    _, want = ref_analysis.lint_text(text)
    _, got = analysis.lint_text(text)
    assert _key(got) == _key(want)
    assert [d.message for d in got] == [d.message for d in want]
    hits = [d for d in got if d.code == code]
    assert hits and hits[0].severity == severity


DIVISIONS = [test_analysis.DIV_BAD, test_analysis.DIV_SHIFTED,
             test_analysis.DIV_SAFE, test_analysis.DIV_CHAINED]


@pytest.mark.parametrize("text", DIVISIONS, ids=["bad", "shifted", "safe", "chained"])
def test_require_bucketable_refuses_same_specs(text):
    def verdict(mod, parse):
        try:
            mod.require_bucketable(parse(text))
        except ValueError as e:
            return str(e)
        return None

    assert verdict(analysis, dsl.parse) == verdict(ref_analysis, ref_dsl.parse)
    for bucketed in (True, False):
        assert _key(analysis.division_diagnostics(dsl.parse(text), bucketed)) \
            == _key(ref_analysis.division_diagnostics(ref_dsl.parse(text), bucketed))


@pytest.mark.parametrize("name", list(ref_stencils.BENCHMARKS))
def test_tolerance_for_matches_reference(name):
    shape = (9, 6, 7) if name in ref_stencils.BENCHMARKS_3D else (18, 13)
    base = ref_stencils.get(name, shape=shape, iterations=3)
    rng = np.random.default_rng(5)
    arrays = {n: rng.standard_normal(shape).astype(np.float32)
              for n in base.inputs}
    for boundary in test_conformance.BOUNDARIES:
        ref_spec = dataclasses.replace(base, boundary=boundary)
        spec = _port(ref_spec)
        for arr in (arrays, None):
            want = ref_numerics.tolerance_for(ref_spec, 3, arr)
            got = numerics.tolerance_for(spec, 3, arr)
            assert got == pytest.approx(want, rel=1e-12, abs=0), boundary
        assert numerics.bound_diagnostic(spec, 3).message == \
            ref_numerics.bound_diagnostic(ref_spec, 3).message
        assert _key(analysis.verify(spec)) == _key(ref_analysis.verify(ref_spec))


def test_preflight_matches_reference_on_one_device():
    """The reference's verdicts for a one-device pool, codes included."""
    from repro.core.model import ParallelismConfig as RefConfig

    ref_spec = ref_stencils.get("jacobi2d", shape=(30, 8), iterations=3)
    wrap = dataclasses.replace(
        ref_spec, inputs={**ref_spec.inputs, "w0": ("int32", (30, 8)),
                          "w1": ("int32", (30, 8))},
        wrap_index_inputs=("w0", "w1"), wrap_round_depth=1,
    )
    for rs in (ref_spec, wrap):
        spec = dataclasses.replace(
            _port(dataclasses.replace(rs, wrap_index_inputs=(),
                                      wrap_round_depth=0)),
            wrap_index_inputs=rs.wrap_index_inputs,
            wrap_round_depth=rs.wrap_round_depth,
        )
        for variant, k, s in (("temporal", 1, 4), ("spatial_r", 2, 1)):
            for batched in (True, False):
                want = ref_analysis.candidate_verdict(
                    rs, RefConfig(variant, k=k, s=s), 1, batched=batched)
                got = analysis.candidate_verdict(
                    spec, ParallelismConfig(variant, k=k, s=s), 1,
                    batched=batched)
                assert (got.feasible, got.k, got.code) == \
                    (want.feasible, want.k, want.code)


def test_sasa401_reports_shared_memory_overflow():
    spec = dsl.parse(ref_dsl.format_spec(
        ref_stencils.get("jacobi2d", shape=(64, 64), iterations=4)))
    assert not any(d.code == "SASA401"
                   for d in analysis.verify(spec, platform=DEFAULT_GPU))
    tiny = dataclasses.replace(DEFAULT_GPU, smem_per_block=1024)
    hits = [d for d in analysis.verify(spec, platform=tiny) if d.code == "SASA401"]
    assert hits and hits[0].severity == "warning"
    assert "shared memory" in hits[0].message


def test_autotune_attaches_bound_and_preflight():
    """SASA500 first, as the reference's autotune attaches it."""
    text = ref_dsl.format_spec(ref_stencils.get("jacobi2d", shape=(20, 12),
                                                iterations=3))
    design = autotune(text, device="cpu", build=False)
    ref_design = ref_autotune(text, build=False)
    assert design.diagnostics[0].code == "SASA500"
    assert design.diagnostics[0].message == ref_design.diagnostics[0].message
    assert all(d.code != "SASA306" for d in design.diagnostics)


def test_autotune_and_parse_strict():
    """``tests/test_analysis.py::test_autotune_and_parse_strict``, ported:
    strict parsing and strict tuning raise on SASA301, as the reference's
    do, and the default stays lenient."""
    with pytest.raises(ref_analysis.VerificationError) as ref_ei:
        ref_dsl.parse(test_analysis.DIV_BAD, strict=True)
    with pytest.raises(analysis.VerificationError):
        autotune(test_analysis.DIV_BAD, platform=DEFAULT_GPU, device="cpu",
                 build=False, strict=True)
    td = autotune(test_analysis.DIV_BAD, platform=DEFAULT_GPU, device="cpu",
                  build=False)
    assert td.ranking
    with pytest.raises(analysis.VerificationError) as ei:
        dsl.parse(test_analysis.DIV_BAD, strict=True)
    assert any(d.code == "SASA301" for d in ei.value.diagnostics)
    assert _key(ei.value.diagnostics) == _key(ref_ei.value.diagnostics)
    assert dsl.parse(test_analysis.DIV_BAD).name == "DIV-BAD"
