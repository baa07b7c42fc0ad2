"""Checkpoint / restore with atomic commits and asynchronous writes,
PyTorch port of ``repro.checkpoint.checkpoint``.

Layout: ``<dir>/step_<N>/``, one ``.npy`` per leaf of the tree (its
``/``-joined path, ``params/layers/3/attn/wq``, made a file name) and
``manifest.json`` (step; each leaf's path, file, dtype and shape).
Writes go to ``step_<N>.tmp``, which is renamed only after the manifest
is fsynced, so a preempted writer never corrupts the latest checkpoint.
Arrays are stored whole and on the host, so a checkpoint does not depend
on the device or the mesh that wrote it: a DTensor leaf is gathered whole
(every rank of its mesh takes part in the gather, rank 0 alone keeps the
copy and writes it) and restored into the layout of the tree it is
restored into.  On a process group every rank calls the save and the
wait, and returns from them only once rank 0's write is on disk.

numpy has no bfloat16: a bf16 leaf is stored as its 16-bit pattern
(``uint16``) with ``bfloat16`` in the manifest, and restored bit for bit,
never widened.

``AsyncCheckpointer`` overlaps the disk write with the next train steps:
the snapshot to the host is synchronous, the write runs on a thread, and
a writer's error is raised by the next ``wait()`` (or ``save()``).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch

from repro_torch.models.layers import named_leaves


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A copy of a leaf as a host array, and its dtype's name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _writes() -> bool:
    """Rank 0 of a process group writes."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier():
    """Every rank of a process group waits until rank 0's write is on
    disk, so a rank that reads the directory next sees it."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()


def _snapshot(tree) -> dict | None:
    """The writer's host copy of ``tree``; None on the other ranks, which
    only take part in gathering each DTensor leaf."""
    writes = _writes()
    host = {}
    for k, v in named_leaves(tree).items():
        if _is_dtensor(v):
            v = v.full_tensor()     # a collective: every rank takes part
        if writes:
            host[k] = _to_host(v)
    return host if writes else None


def _write(directory: str, step: int, host: dict) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": []}
    for key, (arr, dtype) in host.items():
        fname = re.sub(r"[^A-Za-z0-9_.-]", "_", key) + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"key": key, "file": fname, "dtype": dtype,
             "shape": list(arr.shape)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def save_checkpoint(directory: str, step: int, tree) -> str:
    """Write ``tree`` (tensors on any device, arrays, numbers) as
    ``<directory>/step_<step>``; returns that path."""
    host = _snapshot(tree)
    path = os.path.join(directory, f"step_{step:08d}")
    try:
        if host is not None:
            _write(directory, step, host)
    finally:
        _barrier()
    return path


def _steps(directory: str) -> list[int]:
    return sorted(int(m.group(1)) for d in os.listdir(directory)
                  if (m := re.fullmatch(r"step_(\d+)", d)))


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None


@torch.no_grad()
def restore_checkpoint(directory: str, step: int, like_tree):
    """Restore into ``like_tree``: every tensor leaf is overwritten in
    place (on its own device) by the stored leaf of the same path, whose
    dtype and shape must match; returns ``like_tree``.  In place, so a
    restore needs no second copy of the state on the device."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {leaf["key"]: leaf for leaf in manifest["leaves"]}
    for key, like in named_leaves(like_tree).items():
        entry = by_key[key]
        arr = np.load(os.path.join(path, entry["file"]))
        got = torch.from_numpy(arr)
        if entry["dtype"] == "bfloat16":
            got = got.view(torch.bfloat16)
        if got.dtype != like.dtype or tuple(got.shape) != tuple(like.shape):
            raise ValueError(
                f"{key}: stored {entry['dtype']}{list(got.shape)}, "
                f"expected {like.dtype}{list(like.shape)}")
        if _is_dtensor(like):
            from torch.distributed.tensor import distribute_tensor

            got = distribute_tensor(got.to(like.device), like.device_mesh,
                                    like.placements, src_data_rank=None)
        like.copy_(got)
    return like_tree


class AsyncCheckpointer:
    """Snapshot synchronously, write on a background thread, keep last K."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._pending = False        # a save() not yet waited for

    def wait(self):
        """Until the pending write is on disk; on a process group, every
        rank waits for rank 0's."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending:
            self._pending = False
            _barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree):
        self.wait()
        host = _snapshot(tree)
        self._pending = True
        if host is None:
            return

        def work():
            try:
                _write(self.directory, step, host)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        for s in _steps(self.directory)[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
