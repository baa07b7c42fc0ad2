"""Command-line DSL linter: ``python -m repro_torch.lint kernel.dsl [...]``.

PyTorch port of ``repro.lint``, over the port's own analysis
(:mod:`repro_torch.core.analysis`, :mod:`repro_torch.core.numerics`): on
the same inputs it prints the same text and the same JSON and SARIF
documents, and exits with the same code, except where a field names the
tool (:data:`TOOL_NAME`).

Runs the static verifier (:mod:`repro_torch.core.analysis`) over DSL files —
or stdin with ``-`` — and prints structured diagnostics with source
spans and caret markers:

    kernel.dsl:5:26 error[SASA301]: stage 'out' divides by streamed ...
      output float: out(0,0) = in(0,0) / in(0,1)
                               ^^^^^^^^^^^^^^^^

Machine-readable output for CI annotation:

  ``--format json``   one stable JSON document (schema below)
  ``--format sarif``  SARIF 2.1.0 (GitHub code-scanning ingestible)

JSON schema (stable; codes/severities are API per
``analysis.DIAGNOSTIC_CODES``)::

    {"version": 1,
     "files": [{"file": "kernel.dsl",
                "diagnostics": [{"code": "SASA301",
                                 "severity": "error",
                                 "message": "...",
                                 "line": 5, "col": 26, "end_col": 42,
                                 "stage": "out"}]}],
     "summary": {"errors": 1, "warnings": 0, "infos": 0}}

``--numerics`` adds the certified-numerics explain mode: for every file
that parses, the per-stage error budget table from
:mod:`repro_torch.core.numerics` (value envelope, accumulated absolute error
bound, and the bound in dtype ULPs) is printed after the diagnostics
(text format) or attached as a ``numerics`` object per file (json).
``--iterations`` / ``--assume-range`` parameterize that analysis.

``--from-py`` treats the given files as Python sources and lints every
embedded DSL string literal (an ast scan for literals with a
``kernel:`` header).

Exit status is 1 if any error-severity diagnostic was produced (or any
warning under ``--werror``), 0 otherwise — findings of lower severity
are printed but never gate.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import math
import sys

from repro_torch.core import analysis

#: The one value that differs from the reference's output: the tool's
#: name, in the SARIF document (``runs[0].tool.driver.name``) and as the
#: argument parser's ``prog``.
TOOL_NAME = "repro_torch.lint"

#: severity -> SARIF level
_SARIF_LEVELS = {"error": "error", "warning": "warning", "info": "note"}


def dsl_literals(text: str, filename: str = "<string>") -> list[str]:
    """DSL kernel texts embedded as string literals in Python source.

    The scan is purely syntactic (``ast`` constants containing both a
    ``kernel:`` header and an ``output`` declaration), so it never
    imports or executes the scanned file.
    """
    tree = ast.parse(text, filename=filename)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            if "kernel:" in node.value and "output" in node.value:
                out.append(node.value)
    return out


def diagnostic_dict(d: analysis.Diagnostic) -> dict:
    """One diagnostic as the stable JSON object (span flattened)."""
    return {
        "code": d.code,
        "severity": d.severity,
        "message": d.message,
        "line": d.span.line if d.span else None,
        "col": d.span.col if d.span else None,
        "end_col": d.span.end_col if d.span else None,
        "stage": d.stage,
    }


@dataclasses.dataclass
class _FileResult:
    label: str
    text: str
    diagnostics: list
    numerics: "object | None" = None  # numerics.ErrorReport


def _analyze_text(
    text: str,
    label: str,
    numerics_mode: bool,
    iterations: int | None,
    assume_range: float,
) -> _FileResult:
    spec, diags = analysis.lint_text(text)
    report = None
    if numerics_mode and spec is not None:
        from repro_torch.core import numerics

        report = numerics.analyze(
            spec, iterations=iterations, input_range=assume_range,
        )
    return _FileResult(label, text, list(diags), report)


# --------------------------------------------------------------------------
# Renderers
# --------------------------------------------------------------------------


def _render_text(results: list[_FileResult], out) -> None:
    for res in results:
        for d in analysis.sort_diagnostics(res.diagnostics):
            rendered = d.format(res.text)
            first, sep, rest = rendered.partition("\n")
            print(f"{res.label}:{first}", file=out)
            if sep:
                print(rest, file=out)
        if res.numerics is not None:
            print(f"{res.label}: certified numerics", file=out)
            for line in res.numerics.table().splitlines():
                print(f"  {line}", file=out)


def _render_json(results: list[_FileResult], out) -> None:
    files = []
    for res in results:
        entry = {
            "file": res.label,
            "diagnostics": [
                diagnostic_dict(d)
                for d in analysis.sort_diagnostics(res.diagnostics)
            ],
        }
        if res.numerics is not None:
            rep = res.numerics
            entry["numerics"] = {
                "spec": rep.spec_name,
                "dtype": rep.dtype,
                "iterations": rep.iterations,
                "certified": rep.certified,
                "bound": rep.bound if math.isfinite(rep.bound) else None,
                "relative": (
                    rep.relative if math.isfinite(rep.relative) else None
                ),
                "assumed_range": rep.assumed_range,
                "stages": [
                    {
                        "stage": b.stage,
                        "lo": b.lo, "hi": b.hi,
                        "err": b.err if math.isfinite(b.err) else None,
                        "ulps": b.ulps if math.isfinite(b.ulps) else None,
                    }
                    for b in rep.budgets
                ],
            }
        files.append(entry)
    all_diags = [d for r in results for d in r.diagnostics]
    doc = {
        "version": 1,
        "files": files,
        "summary": {
            "errors": sum(d.severity == "error" for d in all_diags),
            "warnings": sum(d.severity == "warning" for d in all_diags),
            "infos": sum(d.severity == "info" for d in all_diags),
        },
    }
    json.dump(doc, out, indent=2)
    out.write("\n")


def _render_sarif(results: list[_FileResult], out) -> None:
    rules_seen: dict[str, dict] = {}
    sarif_results = []
    for res in results:
        for d in analysis.sort_diagnostics(res.diagnostics):
            rules_seen.setdefault(d.code, {
                "id": d.code,
                "shortDescription": {
                    "text": analysis.DIAGNOSTIC_CODES[d.code]
                },
            })
            region = {}
            if d.span is not None:
                region = {
                    "startLine": d.span.line,
                    "startColumn": d.span.col,
                    "endColumn": d.span.end_col,
                }
            sarif_results.append({
                "ruleId": d.code,
                "level": _SARIF_LEVELS[d.severity],
                "message": {"text": d.message},
                "locations": [{
                    "physicalLocation": {
                        "artifactLocation": {"uri": res.label},
                        **({"region": region} if region else {}),
                    },
                }],
            })
    doc = {
        "$schema": (
            "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
            "master/Schemata/sarif-schema-2.1.0.json"
        ),
        "version": "2.1.0",
        "runs": [{
            "tool": {
                "driver": {
                    "name": TOOL_NAME,
                    "informationUri": "https://github.com/",
                    "rules": sorted(
                        rules_seen.values(), key=lambda r: r["id"]
                    ),
                },
            },
            "results": sarif_results,
        }],
    }
    json.dump(doc, out, indent=2)
    out.write("\n")


_RENDERERS = {
    "text": _render_text,
    "json": _render_json,
    "sarif": _render_sarif,
}


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


def lint_source(
    text: str, label: str = "<stdin>", werror: bool = False, out=None
) -> bool:
    """Lint one DSL text; print findings; True iff it gates clean."""
    res = _analyze_text(text, label, False, None, 1.0)
    _render_text([res], out if out is not None else sys.stdout)
    failing = [
        d for d in res.diagnostics
        if d.is_error or (werror and d.severity == "warning")
    ]
    return not failing


def run(
    sources: list[tuple[str, str]],
    fmt: str = "text",
    werror: bool = False,
    numerics_mode: bool = False,
    iterations: int | None = None,
    assume_range: float = 1.0,
    out=None,
) -> int:
    """Lint ``(label, text)`` pairs; render in ``fmt``; return exit code."""
    results = [
        _analyze_text(text, label, numerics_mode, iterations, assume_range)
        for label, text in sources
    ]
    # resolve stdout at call time so redirect_stdout / capsys capture it
    _RENDERERS[fmt](results, out if out is not None else sys.stdout)
    failing = [
        d for r in results for d in r.diagnostics
        if d.is_error or (werror and d.severity == "warning")
    ]
    return 1 if failing else 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog=f"python -m {TOOL_NAME}",
        description="statically verify SASA stencil DSL files",
    )
    parser.add_argument(
        "files", nargs="+",
        help="DSL files to lint ('-' reads one kernel from stdin)",
    )
    parser.add_argument(
        "--werror", action="store_true",
        help="treat warnings as gate failures",
    )
    parser.add_argument(
        "--format", choices=sorted(_RENDERERS), default="text",
        help="output format (default: human-readable text)",
    )
    parser.add_argument(
        "--numerics", action="store_true",
        help="print the certified per-stage error budget table",
    )
    parser.add_argument(
        "--iterations", type=int, default=None,
        help="iteration count for --numerics (default: the spec's own)",
    )
    parser.add_argument(
        "--assume-range", type=float, default=1.0, metavar="R",
        help="--numerics input-range assumption [-R, R] (default 1.0)",
    )
    parser.add_argument(
        "--from-py", action="store_true",
        help="treat files as Python sources; lint embedded DSL literals",
    )
    args = parser.parse_args(argv)
    sources: list[tuple[str, str]] = []
    for path in args.files:
        if path == "-":
            text = sys.stdin.read()
            label = "<stdin>"
        else:
            with open(path, "r", encoding="utf-8") as f:
                text = f.read()
            label = path
        if args.from_py:
            sources += [
                (f"{label}[{i}]", lit)
                for i, lit in enumerate(dsl_literals(text, filename=label))
            ]
        else:
            sources.append((label, text))
    return run(
        sources,
        fmt=args.format,
        werror=args.werror,
        numerics_mode=args.numerics,
        iterations=args.iterations,
        assume_range=args.assume_range,
    )


if __name__ == "__main__":
    sys.exit(main())
