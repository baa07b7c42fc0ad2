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
"""
from __future__ import annotations

import dataclasses
import gzip
import json
import re

import torch.distributed as dist

from repro_torch.configs import base
from repro_torch.launch import dryrun


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
