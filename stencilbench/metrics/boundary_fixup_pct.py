"""The cells that the boundary rule's own passes visit in the tile
kernel's edge blocks, after the load and after every stage, as a share
of its issued cell updates over every launch of the run: the port's
counters ``launch_tile_kernel.fixup_cells`` over ``.updates_issued``, in
percent.  0 under the periodic rule.  Nothing where the port has no such
counters or no kernel was launched (the plain versions)."""


def read(rec):
    try:
        from repro_torch.kernels.stencil import launch_tile_kernel
    except ImportError:
        return None
    issued = getattr(launch_tile_kernel, "updates_issued", 0)
    fixup = getattr(launch_tile_kernel, "fixup_cells", None)
    if not issued or fixup is None:
        return None
    return 100.0 * fixup / issued
