"""Mean host microseconds per solve in the runner's ``stage`` and
``dispatch`` over the window (the benchmark's host spans around the two
calls)."""


def read(rec):
    spans = rec.spans.get("dispatch")
    return sum(spans) / len(spans) * 1e6 if spans else None
