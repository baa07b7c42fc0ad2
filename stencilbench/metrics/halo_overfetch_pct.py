"""Share of the cells the tile kernel stages in its floating-input
windows, over every launch of the run, that lie outside the box the taps
reach (the tile widened by the fused iterations times each side's summed
largest tap offset): the port's counters
``launch_tile_kernel.window_cells`` and ``.reach_cells``, in percent.  0
where the taps reach the whole halo on every side.  Nothing where the
port has no such counters or no kernel was launched (the plain
versions)."""


def read(rec):
    try:
        from repro_torch.kernels.stencil import launch_tile_kernel
    except ImportError:
        return None
    window = getattr(launch_tile_kernel, "window_cells", 0)
    if not window:
        return None
    return 100.0 * (window - launch_tile_kernel.reach_cells) / window
