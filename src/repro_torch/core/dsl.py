"""SASA stencil DSL parser (Section 4.1 of the paper), PyTorch port.

A copy of ``repro.core.dsl`` kept inside the port so that parsing a spec
imports no JAX.  ``parse`` and ``format_spec`` behave exactly as the
reference's: ``format_spec(parse(text))`` is the same text in both.

Grammar (line oriented, ``#`` comments allowed)::

    kernel: NAME
    iteration: INT                     # >= 1
    iterate: NAME                      # optional; default = last input
    boundary: zero | constant FLOAT | replicate | periodic   # default zero
    input TYPE: NAME(INT, INT[, INT])
    local TYPE: NAME(off, off[, off]) = EXPR
    output TYPE: NAME(off, off[, off]) = EXPR

Expressions support ``+ - * /``, unary minus, parentheses, numeric literals,
array references ``name(o0, o1[, o2])`` with constant integer offsets, and
the intrinsics ``max(...)``, ``min(...)``, ``abs(...)`` (needed for e.g.
DILATE which is pure compare-select logic).

The reference SASA implementation uses textX; we use a small hand-rolled
recursive-descent parser to stay dependency-free.

Every syntax error is a :class:`DSLSyntaxError` carrying a stable
diagnostic code (``SASA1xx``), the 1-based line/column, and the offending
source line; the parser also threads :class:`~repro_torch.core.spec.SourceSpan`
locations onto AST nodes (excluded from structural equality) so
diagnostics can point back into the DSL text.
"""
from __future__ import annotations

import dataclasses
import re

from repro_torch.core.spec import (
    BOUNDARY_KINDS,
    BinOp,
    Boundary,
    Call,
    Expr,
    INTRINSICS,
    Let,
    Neg,
    Num,
    Ref,
    SourceSpan,
    Stage,
    StencilSpec,
    Var,
    walk,
)


class DSLSyntaxError(SyntaxError):
    """A located DSL parse error with a stable diagnostic code.

    ``code`` is the ``SASA1xx`` diagnostic code, ``lineno``/``col`` the
    1-based position, and ``text`` the offending source line — so callers
    (and the lint CLI) can render a caret pointing at the problem.  The
    plain :class:`SyntaxError` message is preserved as the first line of
    ``str(e)`` followed by the location, keeping existing ``except
    SyntaxError`` / message-matching callers working.
    """

    def __init__(
        self,
        msg: str,
        code: str = "SASA100",
        lineno: int | None = None,
        col: int | None = None,
        text: str | None = None,
    ):
        loc = ""
        if lineno is not None:
            loc = f" (line {lineno}" + (
                f", col {col})" if col is not None else ")"
            )
        super().__init__(msg + loc)
        self.msg = msg
        self.code = code
        self.lineno = lineno
        self.col = col
        self.text = text
        # SyntaxError's native offset attribute (1-based) for nicer
        # default tracebacks
        self.offset = col

    @property
    def span(self) -> SourceSpan | None:
        if self.lineno is None:
            return None
        col = self.col if self.col is not None else 1
        return SourceSpan(self.lineno, col, col)


_TOKEN_RE = re.compile(
    r"\s*(?:(?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)"
    r"|(?P<name>[A-Za-z_][A-Za-z_0-9]*)"
    r"|(?P<op>[-+*/(),]))"
)


@dataclasses.dataclass(frozen=True)
class _Tok:
    kind: str | None
    val: str | None
    start: int  # 1-based column of the token's first character
    end: int    # 1-based column of the token's last character


class _ExprParser:
    """Recursive-descent expression parser with source positions.

    ``line_no``/``col_base`` locate the expression text within the DSL
    source: token columns are ``col_base + offset-in-text`` (both
    1-based), so spans point at the original line.
    """

    def __init__(self, text: str, line_no: int = 0, col_base: int = 1,
                 source_line: str | None = None):
        self.line_no = line_no
        self.col_base = col_base
        self.source_line = source_line if source_line is not None else text
        self.tokens: list[_Tok] = []
        pos = 0
        while pos < len(text):
            if text[pos:].strip() == "":
                break
            m = _TOKEN_RE.match(text, pos)
            if not m:
                bad_at = pos + len(text[pos:]) - len(text[pos:].lstrip())
                raise DSLSyntaxError(
                    f"bad token at: {text[pos:]!r}", code="SASA101",
                    lineno=line_no, col=col_base + bad_at,
                    text=self.source_line,
                )
            pos = m.end()
            for kind in ("num", "name", "op"):
                if m.group(kind) is not None:
                    self.tokens.append(_Tok(
                        kind, m.group(kind),
                        col_base + m.start(kind), col_base + m.end(kind) - 1,
                    ))
                    break
        self.i = 0
        end = col_base + len(text)
        self._eof = _Tok(None, None, end, end)

    def _err(self, msg: str, tok: _Tok, code: str = "SASA102"):
        raise DSLSyntaxError(
            msg, code=code, lineno=self.line_no, col=tok.start,
            text=self.source_line,
        )

    def _span(self, start_tok: _Tok, end_tok: _Tok | None = None) -> SourceSpan:
        end_tok = end_tok if end_tok is not None else start_tok
        return SourceSpan(self.line_no, start_tok.start, end_tok.end)

    def peek(self) -> _Tok:
        return self.tokens[self.i] if self.i < len(self.tokens) else self._eof

    def next(self) -> _Tok:
        tok = self.peek()
        self.i += 1
        return tok

    def prev(self) -> _Tok:
        """The most recently consumed token (for closing spans)."""
        return self.tokens[self.i - 1] if self.i > 0 else self._eof

    def expect(self, value: str):
        tok = self.next()
        if tok.val != value:
            self._err(f"expected {value!r}, got {tok.val!r}", tok)

    # expr := term (('+'|'-') term)*
    def parse_expr(self) -> Expr:
        first = self.peek()
        node = self.parse_term()
        while self.peek().val in ("+", "-"):
            op = self.next().val
            node = BinOp(op, node, self.parse_term(),
                         span=self._span(first, self.prev()))
        return node

    # term := factor (('*'|'/') factor)*
    def parse_term(self) -> Expr:
        first = self.peek()
        node = self.parse_factor()
        while self.peek().val in ("*", "/"):
            op = self.next().val
            node = BinOp(op, node, self.parse_factor(),
                         span=self._span(first, self.prev()))
        return node

    def parse_factor(self) -> Expr:
        tok = self.next()
        kind, val = tok.kind, tok.val
        if val == "-":
            return Neg(self.parse_factor(), span=self._span(tok, self.prev()))
        if val == "+":
            return self.parse_factor()
        if kind == "num":
            return Num(float(val), span=self._span(tok))
        if val == "(":
            node = self.parse_expr()
            self.expect(")")
            return node
        if kind == "name":
            self.expect("(")
            if val in INTRINSICS:
                args = [self.parse_expr()]
                while self.peek().val == ",":
                    self.next()
                    args.append(self.parse_expr())
                self.expect(")")
                return Call(val, tuple(args),
                            span=self._span(tok, self.prev()))
            # array reference with constant signed-integer offsets
            offsets = [self._parse_offset()]
            while self.peek().val == ",":
                self.next()
                offsets.append(self._parse_offset())
            self.expect(")")
            return Ref(val, tuple(offsets), span=self._span(tok, self.prev()))
        self._err(f"unexpected token {val!r}", tok)

    def _parse_offset(self) -> int:
        sign = 1
        tok = self.next()
        while tok.val in ("-", "+"):
            if tok.val == "-":
                sign = -sign
            tok = self.next()
        kind, val = tok.kind, tok.val
        if kind != "num" or "." in val or "e" in val or "E" in val:
            self._err(
                f"offset must be an integer, got {val!r}", tok, code="SASA103"
            )
        return sign * int(val)

    def finish(self):
        if self.i != len(self.tokens):
            self._err(
                f"trailing tokens: {[t.val for t in self.tokens[self.i:]]}",
                self.peek(),
            )


_HEADER_RE = re.compile(
    r"^(?P<kw>kernel|iteration|iterate|boundary)\s*:\s*(?P<val>.+)$"
)
_DECL_RE = re.compile(
    r"^(?P<kw>input|local|output)\s+(?P<dtype>[A-Za-z_0-9]+)\s*:\s*"
    r"(?P<name>[A-Za-z_][A-Za-z_0-9]*)\s*\((?P<args>[^)]*)\)\s*"
    r"(?:=\s*(?P<expr>.*))?$"
)

_DTYPES = {
    "float": "float32",
    "float32": "float32",
    "double": "float64",
    "float64": "float64",
    "int": "int32",
    "int32": "int32",
    "uint16": "uint16",
    "bfloat16": "bfloat16",
}


def _parse_boundary(val: str, lineno: int, line: str) -> Boundary:
    def err(msg: str) -> DSLSyntaxError:
        return DSLSyntaxError(
            msg, code="SASA105", lineno=lineno,
            col=line.find(val) + 1 if val in line else 1, text=line,
        )

    parts = val.split()
    kind = parts[0]
    if kind not in BOUNDARY_KINDS:
        raise err(
            f"unknown boundary {kind!r} (expected one of "
            f"{', '.join(BOUNDARY_KINDS)})"
        )
    if kind == "constant":
        if len(parts) != 2:
            raise err(
                "'boundary: constant' needs exactly one value, e.g. "
                "'boundary: constant 1.5'"
            )
        try:
            value = float(parts[1])
        except ValueError:
            raise err(
                f"bad boundary constant {parts[1]!r} (must be a number)"
            ) from None
        try:
            return Boundary("constant", value)
        except ValueError as e:   # e.g. non-finite value
            raise err(str(e)) from None
    if len(parts) != 1:
        raise err(f"'boundary: {kind}' takes no value, got {val!r}")
    return Boundary(kind)


def _logical_lines(text: str) -> list[tuple[int, str]]:
    """Comment-stripped logical lines as ``(first_raw_lineno, text)``.

    A line continues the previous one when the previous line has
    unbalanced parens / ends with an operator, or the line starts with
    one.  Joined lines keep the line number of their first raw line;
    columns then index into the joined text.
    """
    out: list[tuple[int, str]] = []
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        if out and (
            out[-1][1].count("(") != out[-1][1].count(")")
            or out[-1][1].rstrip().endswith(("+", "-", "*", "/", "=", "("))
            or line.lstrip().startswith(("+", "-", "*", "/", ")"))
        ):
            out[-1] = (out[-1][0], out[-1][1] + " " + line.strip())
        else:
            out.append((lineno, line.strip()))
    return out


def parse(text: str, strict: bool = False) -> StencilSpec:
    """Parse SASA DSL text into a validated :class:`StencilSpec`.

    With ``strict=True`` the parsed spec is additionally run through the
    static verifier (:func:`repro_torch.core.analysis.verify`) and any
    error-severity diagnostic raises
    :class:`repro_torch.core.analysis.VerificationError`.
    """
    name = None
    iterations = 1
    iterate = None
    boundary = Boundary("zero")
    inputs: dict[str, tuple[str, tuple[int, ...]]] = {}
    stages: list[Stage] = []

    for lineno, line in _logical_lines(text):
        def err(msg: str, code: str, col: int = 1) -> DSLSyntaxError:
            return DSLSyntaxError(
                msg, code=code, lineno=lineno, col=col, text=line
            )

        m = _HEADER_RE.match(line)
        if m:
            kw, val = m.group("kw"), m.group("val").strip()
            if kw == "kernel":
                name = val
            elif kw == "iteration":
                try:
                    iterations = int(val)
                except ValueError:
                    raise err(
                        f"bad iteration count {val!r} (must be an integer)",
                        "SASA105", m.start("val") + 1,
                    ) from None
                if iterations < 1:
                    raise err(
                        f"iteration count must be >= 1, got {iterations}",
                        "SASA105", m.start("val") + 1,
                    )
            elif kw == "boundary":
                boundary = _parse_boundary(val, lineno, line)
            else:
                iterate = val
            continue
        m = _DECL_RE.match(line)
        if not m:
            raise err(f"cannot parse line: {line!r}", "SASA104")
        kw = m.group("kw")
        dtype = _DTYPES.get(m.group("dtype"))
        if dtype is None:
            raise err(
                f"unsupported dtype {m.group('dtype')!r}", "SASA105",
                m.start("dtype") + 1,
            )
        arr = m.group("name")
        name_col = m.start("name") + 1
        args = [a.strip() for a in m.group("args").split(",") if a.strip()]
        if kw == "input":
            if m.group("expr"):
                raise err(
                    "input declarations cannot have an '='", "SASA104",
                    line.find("=") + 1,
                )
            if arr in inputs:
                raise err(
                    f"duplicate input declaration {arr!r} (a second "
                    "declaration would silently overwrite the first)",
                    "SASA107", name_col,
                )
            shape = tuple(int(a) for a in args)
            inputs[arr] = (dtype, shape)
        else:
            if not m.group("expr"):
                raise err(
                    f"{kw} declaration needs an '=' expression", "SASA104"
                )
            if arr in inputs:
                raise err(
                    f"{kw} stage {arr!r} shadows the input of the same "
                    "name; rename the stage", "SASA107", name_col,
                )
            if any(s.name == arr for s in stages):
                raise err(
                    f"duplicate stage declaration {arr!r}", "SASA107",
                    name_col,
                )
            if inputs:
                ndim = len(next(iter(inputs.values()))[1])
                if len(args) != ndim:
                    raise err(
                        f"{kw} {arr!r} declares {len(args)} offsets for a "
                        f"{ndim}-D stencil", "SASA103", name_col,
                    )
            parser = _ExprParser(
                m.group("expr"), line_no=lineno,
                col_base=m.start("expr") + 1, source_line=line,
            )
            expr = parser.parse_expr()
            parser.finish()
            stages.append(Stage(
                arr, dtype, expr, is_output=(kw == "output"),
                span=SourceSpan(lineno, name_col, len(line)),
            ))

    def top_err(msg: str) -> DSLSyntaxError:
        return DSLSyntaxError(msg, code="SASA106", lineno=1, col=1)

    if name is None:
        raise top_err("missing 'kernel:' line")
    if not inputs:
        raise top_err("missing 'input' declaration")
    if not stages:
        raise top_err("missing 'output' declaration")
    # output stage must come last; locals keep declaration order
    outputs = [s for s in stages if s.is_output]
    if len(outputs) != 1:
        raise top_err("exactly one output stage is required")
    stages = [s for s in stages if not s.is_output] + outputs
    if iterate is None:
        iterate = list(inputs)[-1]

    spec = StencilSpec(
        name=name,
        iterations=iterations,
        inputs=inputs,
        stages=tuple(stages),
        iterate_input=iterate,
        boundary=boundary,
    )
    spec.validate()
    if strict:
        # imported here: the analysis module imports this one
        from repro_torch.core.analysis import verify_or_raise

        verify_or_raise(spec, source=text)
    return spec


# --------------------------------------------------------------------------
# Pretty-printer (inverse of parse)
# --------------------------------------------------------------------------

_DTYPE_NAMES = {
    "float32": "float",
    "float64": "double",
    "int32": "int",
    "uint16": "uint16",
    "bfloat16": "bfloat16",
}

_PREC = {"+": 1, "-": 1, "*": 2, "/": 2}


def _format_num(v: float) -> str:
    return repr(float(v))


def _format_expr(expr: Expr, prec: int = 0) -> str:
    if isinstance(expr, Num):
        s = _format_num(expr.value)
        # negative literals only exist after constant folding; print them
        # as the unary-minus form the tokenizer understands
        return f"({s})" if expr.value < 0 and prec > 0 else s
    if isinstance(expr, Ref):
        return f"{expr.name}({', '.join(str(o) for o in expr.offsets)})"
    if isinstance(expr, Call):
        args = ", ".join(_format_expr(a) for a in expr.args)
        return f"{expr.fn}({args})"
    if isinstance(expr, Neg):
        return f"-{_format_expr(expr.arg, prec=3)}"
    if isinstance(expr, BinOp):
        p = _PREC[expr.op]
        # right child parenthesized at equal precedence: the parser is
        # left-associative, so "a - b - c" != "a - (b - c)"
        s = (
            f"{_format_expr(expr.lhs, p)} {expr.op} "
            f"{_format_expr(expr.rhs, p + 1)}"
        )
        return f"({s})" if p < prec else s
    raise TypeError(f"cannot format expression node {expr!r}")


def format_spec(spec: StencilSpec) -> str:
    """Render a spec back to parseable DSL text.

    ``parse(format_spec(spec)) == spec`` for every parser-producible spec
    (round-trip identity, tested over the whole benchmark suite and all
    boundary modes; source spans are excluded from node equality, so the
    identity is unaffected by location info).  Lowered specs print too —
    ``Let`` bindings have no surface syntax, so they are inlined first;
    the round trip is then semantic rather than structural.
    """
    if any(
        isinstance(n, (Let, Var))
        for st in spec.stages
        for n in walk(st.expr)
    ):
        from repro_torch.core.ir import inline_lets

        spec = dataclasses.replace(
            spec,
            stages=tuple(
                dataclasses.replace(st, expr=inline_lets(st.expr))
                for st in spec.stages
            ),
        )
    lines = [f"kernel: {spec.name}", f"iteration: {spec.iterations}"]
    if spec.boundary.kind != "zero":
        if spec.boundary.kind == "constant":
            lines.append(
                f"boundary: constant {_format_num(spec.boundary.value)}"
            )
        else:
            lines.append(f"boundary: {spec.boundary.kind}")
    lines.append(f"iterate: {spec.iterate_input}")
    for n, (dt, shape) in spec.inputs.items():
        dtname = _DTYPE_NAMES[str(dt)]
        lines.append(
            f"input {dtname}: {n}({', '.join(str(s) for s in shape)})"
        )
    zero_off = ", ".join("0" for _ in range(spec.ndim))
    for st in spec.stages:
        kw = "output" if st.is_output else "local"
        dtname = _DTYPE_NAMES[str(st.dtype)]
        lines.append(
            f"{kw} {dtname}: {st.name}({zero_off}) = "
            f"{_format_expr(st.expr)}"
        )
    return "\n".join(lines) + "\n"
