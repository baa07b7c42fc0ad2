"""The whole solve's share of the card, in %: the least time of the
window's work (the configuration's stated bytes and operations at the
data-sheet peaks) over the window's wall time on the host clock."""

from stencilbench import yardstick


def read(rec):
    if not rec.solves or rec.window_s <= 0:
        return None
    return 100.0 * yardstick.least_time_s(rec.work) / rec.window_s
