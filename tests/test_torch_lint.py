"""The port's DSL linter (``python -m repro_torch.lint``) against ``repro.lint``.

Ports ``tests/test_numerics.py::test_lint_*`` and holds the port's text,
JSON and SARIF output and exit codes equal to the reference's on every
input of those tests and on the mutation corpus of
``tests/test_analysis.py``.  The documents are compared whole, after the
fields named in :data:`TOOL_FIELDS` (the only ones that name the tool)
are set to the port's values.
"""
from __future__ import annotations

import contextlib
import copy
import io
import json
import subprocess
import sys

import pytest

import test_analysis
import test_numerics
from repro import lint as ref_lint

from repro_torch import lint

#: Every field whose value names the tool or its module: path into the
#: SARIF document -> (the reference's value, the port's value).
TOOL_FIELDS = {
    ("runs", 0, "tool", "driver", "name"): ("repro.lint", "repro_torch.lint"),
}

WARN_ONLY = test_numerics.WARN_ONLY
CLEAN = test_numerics.CLEAN
DIV_STRADDLE = test_numerics.DIV_STRADDLE

INPUTS = [("warn.dsl", WARN_ONLY), ("clean.dsl", CLEAN),
          ("bad.dsl", DIV_STRADDLE)] + [
    (f"mut{i}.dsl", m[0]) for i, m in enumerate(test_analysis.MUTATIONS)
]


def _mapped(ref_doc: dict) -> dict:
    """The reference's SARIF document with its tool-naming fields set to
    the port's values (each must hold the reference's value first)."""
    doc = copy.deepcopy(ref_doc)
    for path, (ref_value, port_value) in TOOL_FIELDS.items():
        node = doc
        for key in path[:-1]:
            node = node[key]
        assert node[path[-1]] == ref_value
        node[path[-1]] = port_value
    return doc


def _both(sources, **kwargs):
    """(exit code, output) of the reference and of the port."""
    out = []
    for mod in (ref_lint, lint):
        buf = io.StringIO()
        code = mod.run(sources, out=buf, **kwargs)
        out.append((code, buf.getvalue()))
    return out


@pytest.mark.parametrize("fmt", ["text", "json", "sarif"])
@pytest.mark.parametrize("werror", [False, True])
@pytest.mark.parametrize("numerics_mode", [False, True])
def test_output_and_exit_code_match_reference(fmt, werror, numerics_mode):
    (ref_code, ref_out), (code, out) = _both(
        INPUTS, fmt=fmt, werror=werror, numerics_mode=numerics_mode)
    assert code == ref_code
    if fmt == "sarif":
        assert json.loads(out) == _mapped(json.loads(ref_out))
    else:
        assert out == ref_out
    if fmt == "json":
        assert json.loads(out)["files"]


@pytest.mark.parametrize("label,text", INPUTS[:3], ids=[i[0] for i in INPUTS[:3]])
def test_each_input_alone_matches_reference(label, text):
    for werror in (False, True):
        (ref_code, ref_out), (code, out) = _both(
            [(label, text)], fmt="json", werror=werror, numerics_mode=True,
            iterations=4, assume_range=2.5)
        assert (code, out) == (ref_code, ref_out)
    ref_buf, buf = io.StringIO(), io.StringIO()
    assert lint.lint_source(text, label, out=buf) == ref_lint.lint_source(
        text, label, out=ref_buf)
    assert buf.getvalue() == ref_buf.getvalue()


def test_lint_json_schema_and_exit_codes():
    buf = io.StringIO()
    code = lint.run([("warn.dsl", WARN_ONLY)], fmt="json", out=buf)
    assert code == 0  # warnings never gate without --werror
    doc = json.loads(buf.getvalue())
    assert doc["version"] == 1
    (entry,) = doc["files"]
    assert entry["file"] == "warn.dsl"
    d = next(x for x in entry["diagnostics"] if x["code"] == "SASA502")
    assert d["severity"] == "warning" and d["line"] == 4
    assert doc["summary"]["errors"] == 0
    assert doc["summary"]["warnings"] >= 1
    assert lint.run([("warn.dsl", WARN_ONLY)],
                    fmt="json", werror=True, out=io.StringIO()) == 1
    assert lint.run([("bad.dsl", DIV_STRADDLE)],
                    fmt="json", out=io.StringIO()) == 1


def test_lint_sarif_output():
    buf = io.StringIO()
    lint.run([("warn.dsl", WARN_ONLY)], fmt="sarif", out=buf)
    doc = json.loads(buf.getvalue())
    assert doc["version"] == "2.1.0"
    (run_obj,) = doc["runs"]
    assert run_obj["tool"]["driver"]["name"] == "repro_torch.lint"
    rules = {r["id"] for r in run_obj["tool"]["driver"]["rules"]}
    hits = {r["ruleId"] for r in run_obj["results"]}
    assert "SASA502" in rules and "SASA502" in hits
    loc = run_obj["results"][0]["locations"][0]["physicalLocation"]
    assert loc["artifactLocation"]["uri"] == "warn.dsl"


def test_lint_numerics_json_attachment_and_text_table():
    buf = io.StringIO()
    assert lint.run([("clean.dsl", CLEAN)], fmt="json", numerics_mode=True,
                    out=buf) == 0
    (entry,) = json.loads(buf.getvalue())["files"]
    rep = entry["numerics"]
    assert rep["certified"] is True
    assert rep["bound"] is not None and rep["bound"] > 0
    assert [s["stage"] for s in rep["stages"]] == ["out"]
    buf = io.StringIO()
    lint.run([("clean.dsl", CLEAN)], numerics_mode=True, out=buf)
    assert "certified numerics" in buf.getvalue()
    assert "value envelope" in buf.getvalue()


def test_lint_from_py_literal_scan(tmp_path):
    py = tmp_path / "embedded.py"
    py.write_text(
        "X = 1\n"
        f"KERNEL = '''{CLEAN}'''\n"
        f"BAD = '''{DIV_STRADDLE}'''\n"
        "NOT_A_KERNEL = 'just a string'\n"
    )
    assert lint.dsl_literals(py.read_text()) == [CLEAN, DIV_STRADDLE]
    outs = []
    for mod in (ref_lint, lint):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            code = mod.main(["--from-py", "--format", "json", "--werror",
                             str(py)])
        outs.append((code, buf.getvalue()))
    assert outs[0] == outs[1]
    assert outs[1][0] == 1
    entries = json.loads(outs[1][1])["files"]
    assert [e["file"] for e in entries] == [f"{py}[0]", f"{py}[1]"]


def test_module_entry_point_reads_stdin():
    """``python -m repro_torch.lint -`` exits as ``run`` does."""
    for text, want in ((CLEAN, 0), (DIV_STRADDLE, 1)):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.lint", "--format", "json", "-"],
            input=text, capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode == want, proc.stderr
        buf = io.StringIO()
        assert ref_lint.run([("<stdin>", text)], fmt="json", out=buf) == want
        assert proc.stdout == buf.getvalue()
