"""The port's expert-parallel MoE dispatch (``mixers.moe_apply_ep``)
against the reference's dense dispatch, on a 2x2 ("data", "model") mesh
of 4 CPU ranks over gloo (``tests/_torch_mesh_main.py ep_moe``, a
subprocess).

The inputs are ``tests/_ep_moe_main.py``'s: B, S, D = 4, 16, 32, 6 real
experts stored as 8, top-2, one shared expert, the reference's init from
``PRNGKey(0)`` and x from ``PRNGKey(1)``.  Bounds: the output within
2e-4 of the reference's ``moe_apply`` (dropless, and at capacity factor
8, where neither drops a token), two runs bitwise; the gradient of
sum(y^2) within 1e-5 x its largest entry of the port's dense gradient;
the padding experts' gradient exactly 0.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import mixers as ref_mixers

HERE = os.path.dirname(__file__)


@pytest.mark.slow
def test_ep_moe_matches_dense_dispatch(tmp_path):
    B, S, D = 4, 16, 32
    E_real, E_pad, k = 6, 8, 2
    p, _ = ref_mixers.moe_init(jax.random.PRNGKey(0), D, n_experts=E_real,
                               d_ff_expert=64, top_k=k, n_shared=1,
                               d_ff_shared=64, n_experts_padded=E_pad)
    x = jax.random.normal(jax.random.PRNGKey(1), (B, S, D), jnp.float32)
    want = {
        "dropless": ref_mixers.moe_apply(x, p, top_k=k, dropless=True,
                                         n_experts_real=E_real),
        "capacity8": ref_mixers.moe_apply(x, p, top_k=k, capacity_factor=8.0,
                                          n_experts_real=E_real),
    }
    np.savez(tmp_path / "in.npz", x=np.array(x), top_k=k,
             n_experts_real=E_real,
             **{n: np.array(p[n]) for n in ("router", "wi", "wg", "wo")},
             **{"shared_" + n: np.array(p["shared"][n])
                for n in ("wi", "wg", "wo")})
    proc = subprocess.run(
        [sys.executable, os.path.join(HERE, "_torch_mesh_main.py"), "ep_moe",
         str(tmp_path / "in.npz"), str(tmp_path / "out.json")],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads((tmp_path / "out.json").read_text())
    for name, w in want.items():
        err = float(np.abs(np.array(got[name]) - np.array(w)).max())
        assert err < 2e-4, (name, err)
        assert got[name + "_bitwise_rerun"], name
        # tokens sharded over data, replicated over model
        assert got[name + "_placements"] == ["S(0)", "R"], name
    assert got["grad_max_abs_err"] <= 1e-5 * got["grad_max_abs"], got
    assert np.isfinite(got["grad_abs_sum"]) and got["grad_abs_sum"] > 0
    assert got["pad_expert_grad_max"] == 0.0


@pytest.fixture
def world_of_one():
    """A gloo process group of one rank for the test, torn down after."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("axes", [("data", "model"), ("model",)])
def test_moe_under_a_mesh_matches_one_device(world_of_one, axes):
    """qwen2-moe-a2.7b's reduced prefill on DTensor parameters: on a
    (data, model) mesh through the EP dispatch, on a mesh without a data
    axis through the replicated dense dispatch; both equal the one-device
    logits bitwise (one rank: the same rows, slots and order)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import base
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import batch_axes
    from repro_torch.models import mixers
    from repro_torch.models import transformer as T
    from repro_torch.models.model_zoo import build_model

    cfg = base.get("qwen2_moe_a2_7b").reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model.prefill(params, {"tokens": tokens})[0]
        mesh = init_device_mesh("cpu", (1,) * len(axes),
                                mesh_dim_names=axes)
        sharding.shard_params(model, params, mesh)
        ep, calls = mixers.moe_apply_ep, []
        mixers.moe_apply_ep = lambda *a, **kw: calls.append(1) or ep(*a, **kw)
        T.set_mesh_rules(mesh, {**sharding.DEFAULT_PLAN.act_rule_map(mesh),
                                "batch": batch_axes(mesh)})
        try:
            with implicit_replication():
                got = model.prefill(params, {"tokens": tokens})[0]
        finally:
            T.clear_mesh_rules()
            mixers.moe_apply_ep = ep
    assert len(calls) == (cfg.n_layers if "data" in axes else 0)
    assert torch.equal(got.full_tensor(), want)
