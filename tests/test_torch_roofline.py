"""The port's roofline (``repro_torch.roofline``) against the reference's
(``repro.roofline``): FLOP counts of the same step, collective tallies of
the reference's synthetic module, and the report's formulas.

FLOPs: the reference's ``analyze_hlo`` reads the jitted step's HLO on the
CPU (trip-count aware), the port's ``analyze_step`` counts the ops the
step runs; both count products (``dot``/``bmm``/``mm``, 2 * out * K),
remat's recompute included.  Tolerances: the attention and MoE families
agree exactly; Mamba-2's training step within 1% (the port's SSD products
are pairwise, the reference's three- and four-operand einsums contract
in XLA's order).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import base as ref_base
from repro.models.model_zoo import build_model as ref_build_model
from repro.roofline.analysis import RooflineReport as RefRooflineReport
from repro.roofline.analysis import analyze_hlo

from repro_torch.configs import base
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build_model
from repro_torch.roofline import analysis
from repro_torch.roofline import analyze_step, roofline_from_step

B, S = 2, 64
CASES = [  # (arch, remat, train-step FLOP tolerance, relative)
    ("granite_3_2b", "none", 0.0),
    ("granite_3_2b", "full", 0.0),
    ("qwen2_moe_a2_7b", "full", 0.0),
    ("recurrentgemma_2b", "full", 0.0),
    ("mamba2_130m", "full", 0.01),
]


@pytest.mark.parametrize("arch,remat,tol", CASES)
def test_flops_match_reference_hlo(arch, remat, tol):
    cfg = dataclasses.replace(base.get(arch).reduced(), remat=remat)
    ref_model = ref_build_model(dataclasses.replace(
        ref_base.get(arch).reduced(), remat=remat))
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)
    ref_batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}

    def hlo_flops(fn, *args):
        return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text())[
            "flops"]

    model = build_model(cfg, device="cpu")
    params = params_from_numpy(cfg, jax.tree.map(np.array, ref_params),
                               device="cpu").requires_grad_()
    batch = {k: torch.from_numpy(toks) for k in ref_batch}

    def train_step():
        loss = model.loss(params, batch)
        return torch.autograd.grad(loss, list(params.parameters()),
                                   allow_unused=True)

    want = hlo_flops(jax.value_and_grad(ref_model.loss), ref_params, ref_batch)
    got = analyze_step(train_step)["flops"]
    assert abs(got - want) <= tol * want, (got, want)

    want = hlo_flops(lambda p, b: ref_model.prefill(p, b)[0], ref_params,
                     {"tokens": ref_batch["tokens"]})
    with torch.no_grad():
        got = analyze_step(lambda: model.prefill(
            params, {"tokens": batch["tokens"]})[0])["flops"]
    assert got == want

    pos = np.full((B,), 3, np.int32)
    want = hlo_flops(ref_model.decode_step, ref_params,
                     ref_batch["tokens"][:, :1], ref_model.init_cache(B, S),
                     jnp.asarray(pos))
    with torch.no_grad():
        got = analyze_step(model.decode_step, params, batch["tokens"][:, :1],
                           model.init_cache(B, S), torch.from_numpy(pos))
    assert got["flops"] == want


@pytest.fixture
def fake_group():
    """A fake process group of 4 ranks for the test, torn down after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_collective_tallies_of_the_synthetic_module(fake_group):
    """``tests/test_roofline.py``'s module: a dot and an all-reduce 10
    times in a loop, then one all-gather (num_partitions=4)."""
    from torch.distributed import _functional_collectives as funcol

    def step(a, w):
        x = a
        for _ in range(10):
            d = x @ w
            x = funcol.wait_tensor(funcol.all_reduce(d, "sum", fake_group))
        ag = funcol.wait_tensor(funcol.all_gather_tensor(x, 0, fake_group))
        return ag[:8] + x

    an = analyze_step(step, torch.zeros(8, 16), torch.zeros(16, 16))
    # dot: 2 * (8*16) * 16 = 4096 flops, x10 trips
    assert an["flops"] == 10 * 2 * 8 * 16 * 16
    # all-reduce inside loop: operand 512B x10; all-gather outside: 512B
    assert an["collectives"]["all-reduce"] == 10 * 512
    assert an["collectives"]["all-gather"] == 512
    assert an["collectives"]["total"] == 11 * 512
    assert an["collective_counts"]["all-reduce"] == 10
    assert an["collective_counts"]["all-gather"] == 1
    assert an["bytes_accessed"] > 10 * 512   # loop body ops dominate


def test_counts_are_per_rank_on_a_sharded_step(fake_group):
    """A DTensor product counts one rank's local work, and the collectives
    DTensor issues; the global shape propagation is not counted."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    with FakeTensorMode():
        x = distribute_tensor(torch.zeros(64, 256), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        w = distribute_tensor(torch.zeros(256, 128), mesh,
                              [Shard(0), Shard(1)], src_data_rank=None)
        an = analyze_step(lambda: (x @ w).sin())
    # w gathered over data (FSDP), then a (32, 256) x (256, 64) product
    assert an["flops"] == 2 * 32 * 256 * 64
    assert an["collective_counts"]["all-gather"] == 1
    assert an["collectives"]["all-gather"] == 128 * 64 * 4


def test_counter_refuses_a_torch_without_the_propagation_hook(monkeypatch):
    """The per-rank skip finds DTensor's shape propagation by a private
    method's name on the stack: where the method is gone, the counter and
    the dry-run's memory tracker raise instead of counting global ops."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    from repro_torch.launch import dryrun

    monkeypatch.delattr(ShardingPropagator,
                        "_propagate_tensor_meta_non_cached")
    with pytest.raises(RuntimeError, match="_propagate_tensor_meta"):
        analyze_step(lambda: torch.ones(4).sin())
    with pytest.raises(RuntimeError, match="_propagate_tensor_meta"):
        dryrun._mem_tracker()


def test_report_formulas_match_reference():
    kw = dict(arch="a", shape="s", mesh="16x16", chips=256, hlo_flops=3e15,
              hlo_bytes=2e13, collective_bytes_per_chip=1e9,
              collective_detail={"total": 1e9}, compute_term=0.2,
              memory_term=0.5, collective_term=0.1, model_flops=1.5e15,
              memory_per_chip={"peak": 1}, fits=True)
    got, want = analysis.RooflineReport(**kw), RefRooflineReport(**kw)
    assert got.to_dict() == want.to_dict()
    assert got.bottleneck == "memory" and got.roofline_fraction == 0.4


def test_report_is_priced_at_the_h100():
    counts = {"flops": 989e12, "bytes_accessed": 3.35e12,
              "collectives": {"total": 450e9, "all-reduce": 450e9},
              "collective_counts": {"all-reduce": 1}}
    rep = roofline_from_step(counts, arch="a", shape="s", mesh_desc="1",
                             chips=4, model_flops=1.0,
                             memory_per_chip={"peak": 81e9}, hbm_limit=80e9)
    assert rep.compute_term == rep.memory_term == rep.collective_term == 1.0
    assert rep.hlo_flops == 4 * 989e12 and not rep.fits
    assert (analysis.H100_PEAK_BF16, analysis.H100_HBM_BW,
            analysis.H100_NVLINK_BW) == (989e12, 3.35e12, 450e9)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError):
            analysis.card_hbm_bytes()
