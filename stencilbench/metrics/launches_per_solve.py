"""Device kernels per solve in the window, of any name, from the
profiler's trace."""


def read(rec):
    if rec.trace is None or not rec.solves:
        return None
    return len(rec.trace.kernels) / rec.solves
