#!/usr/bin/env python
"""CI gate of the PyTorch/CUDA port: every stock kernel and example DSL
source verifies clean — the counterpart of ``scripts/lint_stencils.py``.

Three sweeps, all through the port's static analyzer
(repro_torch.core.analysis):

  1. every stock kernel in repro_torch.configs.stencils across ALL FOUR
     boundary modes (zero / constant / replicate / periodic), verified
     both as a spec and as DSL text re-emitted by format_spec (which
     also exercises the parser round-trip and source spans);
  2. every DSL string literal embedded in examples_torch/*.py (found by
     an ast scan for literals containing a ``kernel:`` header,
     ``repro_torch.lint.dsl_literals``);
  3. every standalone ``*.dsl`` file under examples_torch/, if any.

Additionally, every stock kernel must carry a *finite* certified
rounding-error bound (repro_torch.core.numerics) at its documented iteration
count across all four boundary modes — a kernel whose bound diverges
could not honestly advertise SASA's provable-equivalence story.

The gate fails on any error-severity diagnostic; warnings and infos are
printed but do not fail (hygiene findings are advisory).  Exit code 0 when
clean, 1 otherwise.

    python scripts/lint_stencils_torch.py
"""
from __future__ import annotations

import dataclasses
import math
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import stencils                # noqa: E402
from repro_torch.core import analysis, dsl, numerics    # noqa: E402
from repro_torch.core.spec import Boundary              # noqa: E402
from repro_torch.lint import dsl_literals               # noqa: E402

BOUNDARIES = (
    Boundary("zero"),
    Boundary("constant", 1.5),
    Boundary("replicate"),
    Boundary("periodic"),
)


def gate(label: str, diags, source=None) -> bool:
    errors = [d for d in diags if d.is_error]
    for d in analysis.sort_diagnostics(diags):
        print(f"{label}: {d.format(source)}")
    if errors:
        print(f"FAIL {label}: {len(errors)} error diagnostic(s)")
        return False
    return True


def main() -> int:
    ok = True
    shapes = {2: (64, 32), 3: (32, 16, 16)}

    for name, fn in stencils.BENCHMARKS.items():
        base = fn(iterations=4)
        spec = fn(shape=shapes[base.ndim], iterations=4)
        for boundary in BOUNDARIES:
            sp = dataclasses.replace(spec, boundary=boundary)
            sp.validate()
            label = f"stock:{name}:{boundary.kind}"
            ok &= gate(label, analysis.verify(sp))
            rep = numerics.analyze(sp, iterations=4)
            if not math.isfinite(rep.bound):
                print(
                    f"FAIL {label}: no finite certified error bound at "
                    f"iterations=4 (rounds analyzed: {rep.rounds_analyzed})"
                )
                ok = False
            # re-emitted DSL text must lint clean too (round-trip + spans)
            text = dsl.format_spec(sp)
            parsed, diags = analysis.lint_text(text)
            ok &= gate(label + ":text", diags, source=text)
            if parsed is not None and parsed != sp:
                print(f"FAIL {label}: format_spec round-trip mismatch")
                ok = False

    examples = ROOT / "examples_torch"
    for py in sorted(examples.glob("*.py")):
        literals = dsl_literals(py.read_text(), filename=str(py))
        for i, text in enumerate(literals):
            _, diags = analysis.lint_text(text)
            ok &= gate(f"{py.name}[{i}]", diags, source=text)
    for f in sorted(examples.glob("*.dsl")):
        _, diags = analysis.lint_text(f.read_text())
        ok &= gate(f.name, diags, source=f.read_text())

    print("lint_stencils_torch:", "OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
