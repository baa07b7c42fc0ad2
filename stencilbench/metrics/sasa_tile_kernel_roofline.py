"""The tile kernel's share of its roofline, in %: the least time of the
window's work (the configuration's stated bytes and operations at the
data-sheet peaks) over the summed device time of ``sasa_tile_kernel``
launches in the window.  Nothing when no such kernel ran."""

from stencilbench import yardstick

KERNEL = "sasa_tile_kernel"


def read(rec):
    if rec.trace is None:
        return None
    t = sum(d for name, _, d in rec.trace.kernels if name.startswith(KERNEL))
    if t <= 0:
        return None
    return 100.0 * yardstick.least_time_s(rec.work) / t
