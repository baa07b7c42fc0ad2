"""Mean host microseconds a solve spends in the runner's ``dispatch``
outside its rounds, in the traced window: the summed ``sasa.dispatch``
spans of ``repro_torch.trace`` less the summed ``sasa.round`` spans, over
the count of ``sasa.dispatch`` spans.  Nothing where the port has no such
span or none was recorded."""


def read(rec):
    try:
        from repro_torch import trace
    except ImportError:
        return None
    totals = trace.totals()
    count, seconds = totals.get("sasa.dispatch", (0, 0.0))
    if not count:
        return None
    return (seconds - totals.get("sasa.round", (0, 0.0))[1]) / count * 1e6
