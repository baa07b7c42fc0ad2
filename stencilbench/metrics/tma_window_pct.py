"""Share of the floating-input windows the tile kernel staged, over every
launch of the run, that were loaded by one tensor copy each (the Tensor
Memory Accelerator): the port's counters ``launch_tile_kernel.windows_tma``
over ``.windows``, in percent.  100 where every block of a float32 launch
takes the copy, 0 where none does (a periodic edge block wraps its halo
cell by cell).  Nothing where the port has no such counters or no kernel
was launched (the plain versions)."""


def read(rec):
    try:
        from repro_torch.kernels.stencil import launch_tile_kernel
    except ImportError:
        return None
    windows = getattr(launch_tile_kernel, "windows", 0)
    copied = getattr(launch_tile_kernel, "windows_tma", None)
    if not windows or copied is None:
        return None
    return 100.0 * copied / windows
