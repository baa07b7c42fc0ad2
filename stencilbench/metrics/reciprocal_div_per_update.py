"""Divisions the tile kernel's stages compute through a reciprocal of a
constant divisor, per cell update, over every launch of the run: the
port's counters ``launch_tile_kernel.divides_reciprocal`` and
``.updates_issued``.  JACOBI2D divides each update by 5 once, so it reads
1; HEAT3D multiplies and never divides, so it reads 0.  Nothing where the
port has no such counter or no kernel was launched (the plain versions)."""


def read(rec):
    try:
        from repro_torch.kernels.stencil import launch_tile_kernel
    except ImportError:
        return None
    issued = getattr(launch_tile_kernel, "updates_issued", 0)
    divides = getattr(launch_tile_kernel, "divides_reciprocal", None)
    if not issued or divides is None:
        return None
    return divides / issued
