"""The port's CUDA tile kernels against their plain versions, on the card.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode).  They import only the port, so they also run where JAX is not
installed::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import stencils
from repro_torch.core.ir import lower
from repro_torch.core.spec import Boundary
from repro_torch.kernels import ops, pipeline, stencil

RTOL = {"float32": 2e-4, "bfloat16": 2e-2}   # tests/test_kernels.py::tol


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tile kernel has no CPU mode")
    return torch.device("cuda")


def _check(spec, device, seed):
    rng = np.random.default_rng(seed)
    arrays = {
        n: rng.standard_normal((2,) + tuple(spec.shape)).astype(np.float32)
        for n in spec.inputs
    }
    t = ops.to_device(spec, arrays, device)
    for s in (1, 2, 4):
        both = pipeline.stencil_cuda_batched(spec, t, s)
        for b in range(2):
            one = {n: a[b] for n, a in t.items()}
            got = stencil.stencil_cuda(spec, one, s)
            want = stencil.stencil_torch_tiled(spec, one, s)
            scale = max(1.0, float(want.float().abs().max()))
            err = float((got.float() - want.float()).abs().max())
            assert err <= RTOL[spec.dtype] * scale, (spec.name, s, err)
            assert torch.equal(both[b], got), (spec.name, s, b)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(stencils.BENCHMARKS))
def test_kernel_matches_plain_on_card(cuda_device, name):
    shape = (37, 6, 41) if name in stencils.BENCHMARKS_3D else (70, 45)
    _check(lower(stencils.get(name, shape=shape, iterations=4)).spec,
           cuda_device, 11)


@pytest.mark.gpu
def test_constant_boundary_and_bf16_on_card(cuda_device):
    spec = lower(stencils.jacobi2d(shape=(50, 66))).spec
    _check(dataclasses.replace(spec, boundary=Boundary("constant", 1.5)),
           cuda_device, 12)
    bf16 = dataclasses.replace(
        spec,
        inputs={"in_1": ("bfloat16", (50, 66))},
        stages=tuple(dataclasses.replace(st, dtype="bfloat16")
                     for st in spec.stages),
    )
    _check(bf16, cuda_device, 13)


@pytest.mark.gpu
def test_kernel_refuses_streamed_specs_on_card(cuda_device):
    spec = lower(stencils.jacobi2d(shape=(8, 8))).spec
    spec = dataclasses.replace(
        spec, inputs={**spec.inputs, "w": ("int32", (8, 8))},
        wrap_index_inputs=("w", "w"), wrap_round_depth=1,
    )
    t = {"in_1": torch.zeros(8, 8, device=cuda_device),
         "w": torch.zeros(8, 8, dtype=torch.int32, device=cuda_device)}
    with pytest.raises(NotImplementedError):
        stencil.stencil_cuda(spec, t, 1)
