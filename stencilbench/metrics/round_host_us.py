"""Mean host microseconds of one round of the port's round loop in the
traced window: the ``sasa.round`` spans of ``repro_torch.trace``, which
record while the profiler records.  Nothing where the port has no such
span or none was recorded."""


def read(rec):
    try:
        from repro_torch import trace
    except ImportError:
        return None
    count, seconds = trace.totals().get("sasa.round", (0, 0.0))
    return seconds / count * 1e6 if count else None
