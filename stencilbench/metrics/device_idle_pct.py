"""Share of the traced window, in %, in which no kernel, copy or fill ran
on the device (the union of the profiler's device intervals)."""


def read(rec):
    if rec.trace is None or rec.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
