"""Two dry-run faults of the port against the reference, repaired: each
cell runs in-process on torch's ``fake`` backend (``launch.dryrun``),
cut in depth only.

  * F4: recurrentgemma-2b ``train_4k`` on the 2x16x16 mesh lowers, as the
    reference's does (its rec block's weight gradients used to merge
    (batch, positions) rows sharded behind the batch, which DTensor
    cannot propagate);
  * F5: granite-3-2b ``train_4k`` on 16x16 partitions its projections as
    the reference's rules say, whatever torch's version: q/k/v and the
    MLP's input products column-parallel over ``model``, the output
    projections row-parallel, the unembedding vocabulary-parallel (49155
    over 16 ranks: 3073 a rank).  The op dump holds no product with a
    whole weight of those, and one rank's FLOPs equal the count of that
    layout exactly.
  * F7: on torch 2.11 (the card's host) ``F.pad`` of a DTensor raised an
    ``IndexError`` in DTensor's redistribution, and 16 cells failed: the
    causal conv and SSD pads of mamba2-130m, the RG-LRU chunk pad of
    recurrentgemma-2b, the chunked loss's table of internvl2-1b and
    seamless-m4t-medium; behind them mamba2-130m ``train_4k`` failed in
    the backward of the SSD's ``cumsum`` (no DTensor rule for ``flip``).
    These pads and that sum go through ``spmd.pad`` and ``spmd.cumsum``,
    which run on local tensors with the placements torch 2.13's rules
    give.  This torch has working rules, so the tests hold the helpers to
    them (placements, shape, values, gradient) and lower a cell of each
    site cut in depth; the card's torch runs the cells whole (PERF.md).
"""
from __future__ import annotations

import dataclasses
import gzip
import json
import re

import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs import base
from repro_torch.launch import dryrun
from repro_torch.models import spmd


def test_f4_recurrentgemma_train_4k_multi_pod_lowers(tmp_path):
    res = dryrun.lower_cell("recurrentgemma_2b", "train_4k", multi_pod=True,
                            cfg_overrides={"n_layers": 2}, verbose=False,
                            dump_dir=str(tmp_path))
    assert res.status == "ok", res.reason
    assert res.report["chips"] == 512 and res.report["fits"]
    assert not dist.is_initialized()


def column_sharded_flops(cfg, shape_name="train_4k", data=16, model=16):
    """One rank's FLOPs of a ``train_4k`` step of a dense GQA config with
    remat "full" on a (data, model) mesh, the reference's layout: rows are
    the rank's batch shard times whole positions; q/k/v and the MLP's
    input products column-parallel over ``model``, the attention output
    and the MLP's output products row-parallel (their contraction over
    ``model``), the unembedding over ceil(V / model) vocabulary rows;
    attention per rank with the queries split by position (8 KV heads do
    not divide over 16 ranks).  Each layer's product runs forward, again
    in the recompute and twice backward, but the last (the MLP's output
    product), which the recompute need not redo; the unembedding runs
    forward and twice backward."""
    seq, gbatch, _ = dryrun.SHAPES[shape_name]
    b, D = gbatch // data, cfg.d_model
    rows = b * seq
    cols = {"q": cfg.n_heads * cfg.d_head // model,
            "k": cfg.n_kv_heads * cfg.d_head // model,
            "v": cfg.n_kv_heads * cfg.d_head // model,
            "wo": cfg.n_heads * cfg.d_head // model,
            "wi": cfg.d_ff // model, "wg": cfg.d_ff // model}
    last = cfg.d_ff // model                             # the MLP's wo
    per_layer = 2 * rows * D * (4 * (sum(cols.values()) + last) - last)
    attn = 4 * 2 * (2 * b * cfg.n_heads * (seq // model) * seq * cfg.d_head)
    vocab = -(-cfg.vocab // model)
    return cfg.n_layers * (per_layer + attn) + 3 * 2 * rows * D * vocab


def test_f5_granite_train_4k_projections_column_sharded(tmp_path):
    n_layers = 2
    res = dryrun.lower_cell("granite_3_2b", "train_4k",
                            cfg_overrides={"n_layers": n_layers},
                            verbose=False, dump_dir=str(tmp_path))
    assert res.status == "ok", res.reason
    with gzip.open(res.op_dump, "rt") as f:
        dump = json.load(f)
    cfg = dataclasses.replace(base.get("granite_3_2b"), n_layers=n_layers)
    products = [k for k in dump["flops_or_bytes_by_shape"]
                if re.match(r"aten\.b?mm ", k)]
    whole = [k for k in products
             if re.search(r"\b(49155|8192)\b", k)            # unembedding, MLP
             or re.search(r"\b65536x2048 1?x?2048x2048\b", k)]  # 2048x2048
    assert not whole, whole
    kv = cfg.n_kv_heads * cfg.d_head // 16
    assert any(k.endswith(f"2048x{kv}") for k in products), products
    assert any(k.endswith(f"2048x{-(-cfg.vocab // 16)}") for k in products)
    assert dump["flops"] == column_sharded_flops(cfg)


CUMSUM_CASES = [  # (placements on a 4x4 mesh, dim)
    ("S0 S1", 1),                       # the summed dim sharded: gathered
    ("S0 S2", 1),
    ("R S0", 2),
    ("S0 P", 2),
]
PAD_CASES = [  # (placements on a 4x4 mesh, pad widths, value)
    ("S0 S1", (0, 0, 3, 0), 0.0),       # a sharded dim padded: gathered
    ("S0 S2", (0, 0, 3, 0), 0.0),       # another dim sharded: kept
    ("S0 R", (0, 0, 0, 5), 0.0),
    ("R S0", (0, 0, 0, 3), -1.0),
    ("S0 P", (0, 0, 0, 3), 0.0),        # a partial sum under a zero pad
    ("S1 S0", (1, 2, 0, 0, 0, 4), 0.0),  # three dims, one sharded padded
]


def _placements(text):
    from torch.distributed.tensor import Partial, Replicate, Shard

    return [Partial() if p == "P" else Replicate() if p == "R"
            else Shard(int(p[1])) for p in text.split()]


def test_f7_helpers_take_the_placements_of_torch_2_13s_rules():
    """On a fake 4x4 mesh, ``spmd.pad`` and ``spmd.cumsum`` of a DTensor
    give the shape and placements ``F.pad`` and ``torch.cumsum`` give on
    this torch (whose rules work)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=16)
    try:
        mesh = init_device_mesh("cpu", (4, 4),
                                mesh_dim_names=("data", "model"))
        with FakeTensorMode():
            for text, widths, value in PAD_CASES:
                place = _placements(text)
                x = DTensor.from_local(torch.zeros(2, 4, 8), mesh, place,
                                       run_check=False)
                want = F.pad(x, widths, value=value)
                got = spmd.pad(x, widths, value=value)
                assert got.shape == want.shape, text
                assert tuple(got.placements) == tuple(want.placements), text
                assert got.to_local().shape == want.to_local().shape, text
            for text, dim in CUMSUM_CASES:
                x = DTensor.from_local(torch.zeros(2, 4, 8), mesh,
                                       _placements(text), run_check=False)
                want = torch.cumsum(x, dim)
                got = spmd.cumsum(x, dim)
                assert got.shape == want.shape, text
                assert tuple(got.placements) == tuple(want.placements), text
    finally:
        dist.destroy_process_group()


def test_f7_helpers_values_and_gradients_on_a_mesh(world_of_one):
    """On a 1x1 gloo mesh the padded and summed DTensors, and the
    gradients through them, equal ``F.pad`` and ``torch.cumsum`` of the
    plain tensor bitwise; a plain tensor goes to those ops themselves."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    g = torch.Generator().manual_seed(0)
    for text, widths, value in PAD_CASES:
        if "P" in text:
            continue
        a = torch.randn(2, 4, 8, generator=g)
        w = torch.randn(F.pad(a, widths).shape, generator=g)
        x = distribute_tensor(a, mesh, _placements(text)).requires_grad_()
        got = spmd.pad(x, widths, value=value)
        (got * distribute_tensor(w, mesh, got.placements)).sum().backward()
        want = F.pad(a, widths, value=value)
        assert torch.equal(got.full_tensor(), want), text
        sliced = w[tuple(slice(lo, lo + n) for lo, n in zip(
            [0] * (a.ndim - len(widths) // 2) + [widths[i] for i in range(
                len(widths) - 2, -1, -2)], a.shape))]
        assert torch.equal(x.grad.full_tensor(), sliced), text
    for text, dim in CUMSUM_CASES:
        if "P" in text:
            continue
        a = torch.randn(2, 4, 8, generator=g)
        w = torch.randn(a.shape, generator=g)
        x = distribute_tensor(a, mesh, _placements(text)).requires_grad_()
        got = spmd.cumsum(x, dim)
        (got * distribute_tensor(w, mesh, got.placements)).sum().backward()
        assert torch.equal(got.full_tensor(), torch.cumsum(a, dim)), text
        ref = a.clone().requires_grad_()
        (torch.cumsum(ref, dim) * w).sum().backward()
        assert torch.equal(x.grad.full_tensor(), ref.grad), text
    plain = torch.randn(3, 5, generator=g)
    assert torch.equal(spmd.pad(plain, (1, 2), value=4.0),
                       F.pad(plain, (1, 2), value=4.0))
    assert torch.equal(spmd.cumsum(plain, 1), torch.cumsum(plain, 1))


@pytest.fixture
def world_of_one():
    """A gloo process group of one rank for the test, torn down after."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,shape,layers", [
    ("mamba2_130m", "prefill_32k", 1),        # causal conv, SSD chunk pads
    ("mamba2_130m", "train_4k", 1),           # and the SSD sum's backward
    ("recurrentgemma_2b", "decode_32k", 3),   # the RG-LRU chunk pad
    ("internvl2_1b", "train_4k", 1),          # the chunked loss's table
])
def test_f7_cells_lower(tmp_path, arch, shape, layers):
    res = dryrun.lower_cell(arch, shape, cfg_overrides={"n_layers": layers},
                            verbose=False, dump_dir=str(tmp_path))
    assert res.status == "ok", res.reason
    assert res.report["fits"] and res.report["compute_term"] > 0
    assert not dist.is_initialized()
