"""Seconds of the first solve, its dispatch and its wait: the library's
lookup and load, or its ``nvcc`` build in a checkout's first run (the
benchmark's host span)."""


def read(rec):
    spans = rec.spans.get("first_solve")
    return spans[0] if spans else None
