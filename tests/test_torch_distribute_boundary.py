"""Every shard variant × every non-zero boundary against the reference's
oracle, on the pool ``[torch.device("cpu")] * 8``.

The boundary sweep of ``tests/_multidevice_main.py``: the periodic ring
(shard 0 <-> shard k-1), the constant and replicate fixups in global
coordinates, a two-input spec, a local stage chain and the 3-D HEAT3D with
two wrapped column axes; within rtol = atol = 2e-4.
"""
from __future__ import annotations

import pytest

from _torch_distribute_cases import (
    BOUNDARIES,
    BOUNDARY_CFGS,
    POOL,
    assert_close,
    cfg_id,
    fits,
    inputs,
    oracle,
    port,
    ref_spec,
)

from repro_torch.core import distribute

CASES = [
    ("jacobi2d", (96, 20), 4),
    ("hotspot", (96, 20), 4),        # two inputs, one iterated
    ("blur_jacobi2d", (96, 20), 3),  # local stage chain
    ("heat3d", (64, 6, 6), 4),       # 3-D: two wrapped column axes
]


@pytest.mark.parametrize("cfg", BOUNDARY_CFGS, ids=cfg_id)
@pytest.mark.parametrize("boundary", BOUNDARIES, ids=lambda b: b.kind)
@pytest.mark.parametrize("bench,shape,iters", CASES, ids=[c[0] for c in CASES])
def test_boundary_sweep_matches_oracle(bench, shape, iters, boundary, cfg):
    spec_ref = ref_spec(bench, shape, iters, boundary)
    if not fits(cfg, shape, iters, spec_ref.radius):
        pytest.skip("the reference skips *_r with iter*r > rows/device")
    spec = port(spec_ref)
    arrays = inputs(spec)
    run = distribute.build_runner(
        spec, cfg, iterations=iters, devices=POOL[:cfg.devices_needed],
        tile_rows=16,
    )
    assert_close(run(arrays), oracle(spec_ref, arrays, iters),
                 f"boundary={boundary.kind} {bench}{shape} {cfg}")
