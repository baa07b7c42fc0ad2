"""The PyTorch port's front end against the JAX reference's.

Specs cross as DSL text (``repro.core.dsl.format_spec`` ->
``repro_torch.core.dsl.parse``).  For every stock kernel under every
boundary mode and for the 200 seed-pinned random specs of the conformance
suite, the port must print the same DSL text, lower to the same trees
(compared as printed text) and count the same ops per cell.
"""
from __future__ import annotations

import dataclasses

import pytest

import test_conformance
from repro.configs import stencils as ref_stencils
from repro.core import dsl as ref_dsl
from repro.core import ir as ref_ir
from repro.core.spec import Boundary as RefBoundary

from repro_torch.configs import stencils as pt_stencils
from repro_torch.core import dsl as pt_dsl
from repro_torch.core import ir as pt_ir

BOUNDARIES = (
    RefBoundary("zero"),
    RefBoundary("constant", 1.5),
    RefBoundary("replicate"),
    RefBoundary("periodic"),
)


def _check_same(ref_spec, label):
    text = ref_dsl.format_spec(ref_spec)
    spec = pt_dsl.parse(text)
    # compare with the reference's parse of the same text: a negative
    # literal prints as a unary minus, so text and object may differ
    ref_spec = ref_dsl.parse(text)
    assert pt_dsl.format_spec(spec) == ref_dsl.format_spec(ref_spec), label
    ref_low = ref_ir.lower(ref_spec)
    pt_low = pt_ir.lower(spec)
    assert pt_dsl.format_spec(pt_low.spec) == ref_dsl.format_spec(
        ref_low.spec
    ), label
    assert pt_low.ops_per_cell == ref_low.ops_per_cell, label
    assert spec.ops_per_cell == ref_spec.ops_per_cell, label
    assert [(r.name, r.ops_before, r.ops_after) for r in pt_low.reports] == [
        (r.name, r.ops_before, r.ops_after) for r in ref_low.reports
    ], label
    assert (spec.radius, spec.shape, spec.iterate_input) == (
        ref_spec.radius, ref_spec.shape, ref_spec.iterate_input
    ), label


@pytest.mark.parametrize("name", list(ref_stencils.BENCHMARKS))
@pytest.mark.parametrize("boundary", BOUNDARIES, ids=lambda b: b.kind)
def test_stock_kernels_round_trip(name, boundary):
    ref_spec = dataclasses.replace(
        ref_stencils.get(name, iterations=3), boundary=boundary
    )
    _check_same(ref_spec, f"{name}/{boundary.kind}")


@pytest.mark.parametrize("block", range(4))
def test_random_specs_round_trip(block):
    for seed in range(block * 50, (block + 1) * 50):
        ref_spec, _, _ = test_conformance.random_spec(seed)
        _check_same(ref_spec, f"seed {seed}")


def test_stock_suite_matches_reference():
    """The port's own stock kernels and paper sizes are the reference's."""
    assert pt_stencils.SIZES_2D == ref_stencils.SIZES_2D
    assert pt_stencils.SIZES_3D == ref_stencils.SIZES_3D
    assert list(pt_stencils.BENCHMARKS) == list(ref_stencils.BENCHMARKS)
    for name in ref_stencils.BENCHMARKS:
        assert pt_dsl.format_spec(pt_stencils.get(name)) == ref_dsl.format_spec(
            ref_stencils.get(name)
        ), name


def test_parse_errors_match_reference():
    bad = [
        "kernel: K\ninput float: a(4, 4)\noutput float: b(0,0) = a(0,0) +\n",
        "kernel: K\niteration: 0\ninput float: a(4, 4)\n"
        "output float: b(0,0) = a(0,0)\n",
        "kernel: K\nboundary: mirror\ninput float: a(4, 4)\n"
        "output float: b(0,0) = a(0,0)\n",
        "kernel: K\ninput float: a(4, 4)\noutput float: b(0,0) = a(0.5,0)\n",
    ]
    for text in bad:
        with pytest.raises(SyntaxError) as want:
            ref_dsl.parse(text)
        with pytest.raises(SyntaxError) as got:
            pt_dsl.parse(text)
        assert (got.value.code, got.value.lineno, got.value.col) == (
            want.value.code, want.value.lineno, want.value.col
        )
