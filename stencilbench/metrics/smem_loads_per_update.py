"""Shared-memory loads of taps the tile kernel's stages issue per cell
update, over every launch of the run: the port's counters
``launch_tile_kernel.smem_tap_loads`` and ``.updates_issued``.  A walk
cell by cell loads each tap of a cell (5 for JACOBI2D, 7 for HEAT3D);
the strip walk loads each column of taps once a strip, so it reads
below.  Nothing where the port has no such counter or no kernel was
launched (the plain versions)."""


def read(rec):
    try:
        from repro_torch.kernels.stencil import launch_tile_kernel
    except ImportError:
        return None
    issued = getattr(launch_tile_kernel, "updates_issued", 0)
    loads = getattr(launch_tile_kernel, "smem_tap_loads", 0)
    if not issued or not loads:
        return None
    return loads / issued
