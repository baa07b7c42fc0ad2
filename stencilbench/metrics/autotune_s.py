"""Seconds in ``autotune(...)``: parsing, lowering, ranking and preflight
of the cell's DSL text, up to a built runner (the benchmark's host span
around the call)."""


def read(rec):
    spans = rec.spans.get("autotune")
    return spans[0] if spans else None
