"""Cell updates the tile kernel's thread blocks evaluate in ``local``
stages over the useful ones (grid cells x fused iterations x local
stages), over every launch of the run: the port's counters
``launch_tile_kernel.local_updates_issued`` and ``.local_updates_useful``.
1 means no halo work in the local stages; the trapezoid of deep fusion
reads above.  Nothing where the port has no such counters or no local
stage was launched (a spec without one, or the plain versions)."""


def read(rec):
    try:
        from repro_torch.kernels.stencil import launch_tile_kernel
    except ImportError:
        return None
    useful = getattr(launch_tile_kernel, "local_updates_useful", 0)
    if not useful:
        return None
    return launch_tile_kernel.local_updates_issued / useful
