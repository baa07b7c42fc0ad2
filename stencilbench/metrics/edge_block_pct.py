"""Share of the tile kernel's thread blocks, over every launch of the run,
whose window leaves the grid on some axis (edge blocks, which load and
update with the boundary rule): the port's counters
``launch_tile_kernel.edge_blocks`` over ``.blocks``, in percent.  Nothing
where the port has no such counters or no kernel was launched (the plain
versions)."""


def read(rec):
    try:
        from repro_torch.kernels.stencil import launch_tile_kernel
    except ImportError:
        return None
    blocks = getattr(launch_tile_kernel, "blocks", 0)
    if not blocks:
        return None
    return 100.0 * launch_tile_kernel.edge_blocks / blocks
