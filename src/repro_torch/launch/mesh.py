"""Device meshes, PyTorch port of ``repro.launch.mesh``.

Functions, never module-level constants: importing this module touches no
process group.  Each mesh is a ``DeviceMesh`` made by ``init_device_mesh``
over the default process group that already exists (``nccl`` on the
cards, ``gloo`` on the CPU, the ``fake`` backend for the dry-run's 256
and 512 ranks in one process); its device type is the group's.

:class:`AbstractMesh` is the counterpart of
``jax.sharding.AbstractMesh``: axis names and sizes with no devices, all
that the sharding plan (``launch/sharding.py``) needs to price a
production mesh on any host.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape without devices: ``shape`` and ``axis_names`` in
    order (major to minor)."""

    shape: tuple
    axis_names: tuple

    @property
    def mesh_dim_names(self) -> tuple:
        return self.axis_names


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _device_type() -> str:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("a mesh needs torch.distributed's default "
                           "process group: init_process_group first")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape: tuple, axes: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 ranks per pod; multi-pod adds a leading 2-pod axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_host_mesh(data: int = 2, model: int = 4):
    """A small (data, model) mesh over the ranks of the process group."""
    return _mesh((data, model), ("data", "model"))


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)
