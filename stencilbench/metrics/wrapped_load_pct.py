"""Share of the cells the tile kernel stages in its floating-input
windows, over every launch of the run, that lie outside the grid and are
wrapped round it under the periodic boundary (each fetched on its own):
the port's counters ``launch_tile_kernel.wrapped_cells`` over
``.window_cells``, in percent.  0 under every other boundary rule.
Nothing where the port has no such counters or no kernel was launched
(the plain versions)."""


def read(rec):
    try:
        from repro_torch.kernels.stencil import launch_tile_kernel
    except ImportError:
        return None
    window = getattr(launch_tile_kernel, "window_cells", 0)
    wrapped = getattr(launch_tile_kernel, "wrapped_cells", None)
    if not window or wrapped is None:
        return None
    return 100.0 * wrapped / window
