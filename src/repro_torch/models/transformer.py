"""Architecture assembly, PyTorch port of ``repro.models.transformer``:
decoder-only, encoder-decoder and VLM stacks of every block kind of the
reference:

  "attn"     (causal GQA + MLP),     "attn_moe" (causal GQA + MoE),
  "local"    (sliding-window GQA + MLP), "enc" (bidirectional GQA + MLP),
  "xattn"    (decoder self + cross + MLP),
  "rec"      (RG-LRU + MLP),          "ssm" (Mamba-2 SSD, no MLP).

The mixers (MoE, RG-LRU, Mamba-2 SSD) are ``models/mixers.py``.  The
MoE layers dispatch with the config's capacity in prefill and dropless in
decode; under a mesh with a ``model`` axis that divides the stored
experts, and a batch that divides over the data axes, they take the
expert-parallel dispatch (``mixers.moe_apply_ep``), as the reference does.

A stack is a flat list of blocks: layer ``i`` has kind
``pattern[i % len(pattern)]`` (the reference's layer ``g*len(pattern)+j``
of its scanned group ``g``, or of its unscanned tail).  The groups run in
a Python loop.  In training (mode ``"train"`` with gradients on) each
whole group runs under the config's remat policy, as the reference's
scanned body does, and the tail without: ``"full"`` saves nothing inside
a group, ``"dots"`` saves the products without a batch dimension (the
reference's ``checkpoint_dots_with_no_batch_dims``), ``"none"`` saves
everything.  ``block_specs``/``_stack_specs`` give the logical axes of
each block's parameters: the reference's scanned specs without their
leading ``"layers"`` axis, which every plan maps to no mesh axis.

The mesh path: ``set_mesh_rules``, ``clear_mesh_rules`` and
``constrain`` are the reference's names here, and live in
``models/spmd.py`` with every other place the model meets DTensor; each
is the identity without a mesh.  This module decides the layouts:

  * attention runs per rank (``spmd.per_rank``, a ``local_map``):
    queries split by heads where the KV heads divide over the heads' mesh
    axes (the reference's layout), else by position in train and prefill
    (the keys whole, their gradient summed over those axes), else not;
    DTensor cannot split the grouped heads (kv, group) of an unevenly
    sharded head dim, where GSPMD pads;
  * a decode step writes its ring slot with a masked ``torch.where`` (out
    of place; DTensor has no rule for the indexed store);
  * a dispatch that is not expert-parallel (``moe_apply`` under a mesh)
    runs replicated, per rank.

Modes are the reference's: ``"train"`` (a forward without a cache, which
the encoder runs), ``"prefill"`` and ``"decode"``.  Decode writes each
attention row's ring slot ``pos % cache_len`` of k, v and pos *in place*
and returns the same cache dict; a recurrent block (``rec``, ``ssm``)
returns a new state dict.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.models import layers as L
from repro_torch.models import mixers as M
from repro_torch.models import spmd
from repro_torch.models.spmd import (  # noqa: F401  (set/clear re-exported)
    clear_mesh_rules,
    constrain,
    per_rank,
    set_mesh_rules,
)

ATTN_KINDS = ("attn", "attn_moe", "local", "enc", "xattn")
KINDS = ATTN_KINDS + ("rec", "ssm")


def check_kind(kind: str) -> None:
    """Refuse a block kind the reference does not have."""
    if kind not in KINDS:
        raise ValueError(kind)


# --------------------------------------------------------------------------
# Block init / apply
# --------------------------------------------------------------------------


def block_init(generator, cfg, kind: str) -> dict:
    """The parameter tree of one block of the given kind."""
    check_kind(kind)
    dev = generator.device
    params = {}
    if kind in ATTN_KINDS:
        params["ln_attn"] = L.rmsnorm_init(cfg.d_model, dev)
        params["attn"] = L.attention_init(
            generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
            qkv_bias=cfg.qkv_bias)
    if kind == "xattn":
        params["ln_cross"] = L.rmsnorm_init(cfg.d_model, dev)
        params["cross"] = L.attention_init(
            generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
            qkv_bias=cfg.qkv_bias)
    if kind == "rec":
        params["ln_rec"] = L.rmsnorm_init(cfg.d_model, dev)
        params["rec"] = M.rglru_init(generator, cfg.d_model,
                                     lru_width=cfg.lru_width or cfg.d_model)
    if kind == "ssm":
        params["ln_ssm"] = L.rmsnorm_init(cfg.d_model, dev)
        params["ssm"], _ = M.mamba2_init(
            generator, cfg.d_model, d_state=cfg.ssm_state,
            headdim=cfg.ssm_headdim, expand=cfg.ssm_expand)
        return params  # mamba blocks carry no separate MLP
    # feed-forward half
    params["ln_mlp"] = L.rmsnorm_init(cfg.d_model, dev)
    if kind.endswith("_moe"):
        params["moe"] = M.moe_init(
            generator, cfg.d_model, cfg.n_experts, cfg.d_ff_expert,
            cfg.top_k, n_shared=cfg.n_shared_experts,
            d_ff_shared=cfg.d_ff_shared,
            n_experts_padded=cfg.n_experts_padded)
    else:
        params["mlp"] = L.swiglu_init(generator, cfg.d_model, cfg.d_ff)
    return params


def block_specs(cfg, kind: str) -> dict:
    """The logical axes of one block's parameters, the tree of
    :func:`block_init` (no tensor is made)."""
    check_kind(kind)
    specs = {}
    if kind in ATTN_KINDS:
        specs["ln_attn"] = L.RMSNORM_SPEC
        specs["attn"] = L.attention_specs(cfg.qkv_bias)
    if kind == "xattn":
        specs["ln_cross"] = L.RMSNORM_SPEC
        specs["cross"] = L.attention_specs(cfg.qkv_bias)
    if kind == "rec":
        specs["ln_rec"] = L.RMSNORM_SPEC
        specs["rec"] = M.rglru_specs()
    if kind == "ssm":
        specs["ln_ssm"] = L.RMSNORM_SPEC
        specs["ssm"] = M.mamba2_specs()
        return specs
    specs["ln_mlp"] = L.RMSNORM_SPEC
    if kind.endswith("_moe"):
        specs["moe"] = M.moe_specs(cfg.n_shared_experts)
    else:
        specs["mlp"] = L.swiglu_specs()
    return specs


def _ep_axes(mesh, router, x):
    """The batch axes of the expert-parallel dispatch, or None where the
    reference takes the plain one: no ``model`` axis, experts that do not
    divide over it, no data axis, or a batch that does not divide."""
    from repro_torch.launch.mesh import axis_sizes, batch_axes

    if mesh is None:
        return None
    sizes = axis_sizes(mesh)
    if "model" not in sizes or router.shape[1] % sizes["model"]:
        return None
    ba = batch_axes(mesh)
    dp = 1
    for a in ba:
        dp *= sizes[a]
    return ba if ba and x.shape[0] % dp == 0 else None


def _mlp_apply(cfg, p, x, mode="train"):
    h = L.rmsnorm(x, p["ln_mlp"])
    if "moe" in p:
        # decode batches are tiny: dropless dispatch (cap = T*k) is cheap
        # and keeps decode exactly consistent with the full forward
        mesh = spmd.mesh()
        kw = dict(top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                  dropless=(mode == "decode"), n_experts_real=cfg.n_experts)
        ba = _ep_axes(mesh, p["moe"]["router"], x)
        if ba is not None:
            out = M.moe_apply_ep(h, p["moe"], mesh=mesh, batch_axes=ba, **kw)
        else:   # replicated on a mesh, as GSPMD runs a global sort
            names, ws = zip(*L.named_leaves(p["moe"]).items())

            def dense(h, *ws):
                tree = {}
                for name, w in zip(names, ws):
                    *path, leaf = name.split("/")
                    node = tree
                    for key in path:
                        node = node.setdefault(key, {})
                    node[leaf] = w
                return M.moe_apply(h, tree, **kw)

            out = per_rank(dense, (h, *ws), [(None,) * 3] + [
                (None,) * w.dim() for w in ws], (None,) * 3)
    else:
        fn = L.geglu if cfg.mlp == "geglu" else L.swiglu
        out = fn(h, p["mlp"])
    return x + out


def _ssm_meta(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    return dict(d_inner=d_inner, n_heads=d_inner // cfg.ssm_headdim,
                headdim=cfg.ssm_headdim, d_state=cfg.ssm_state,
                d_conv=4, n_groups=1)


def _q_layout(cfg, mode, seq_ok=True) -> tuple:
    """The queries' logical axes: heads over their mesh axes, the
    reference's, where the KV heads split evenly over them too (grouped
    attention views the heads as (kv, group), and DTensor cannot split an
    unevenly sharded dim where GSPMD pads); otherwise the positions in
    train and prefill (the keys whole), and nothing in decode."""
    mesh = spmd.mesh()
    axes = spmd.rule("heads")
    if mesh is None or axes is None:
        return ("batch", None, "heads", None)
    from repro_torch.launch.mesh import axis_sizes

    sizes = axis_sizes(mesh)
    n = 1
    for a in ((axes,) if isinstance(axes, str) else axes):
        n *= sizes[a]
    if cfg.n_kv_heads % n == 0:
        return ("batch", None, "heads", None)
    return ("batch", "seq", None, None) if mode != "decode" and seq_ok \
        else ("batch", None, None, None)


def _chunked(q, k, v, q_positions, kv_positions, **kw):
    return L.attention_chunked(q, k, v, q_positions=q_positions,
                               kv_positions=kv_positions, **kw)


def _attn_apply(cfg, kind, p, x, *, positions, mode, cache, enc_out,
                enc_positions):
    """The attention half of an attention block.  Returns (x, new_cache)."""
    new_cache = cache
    h = L.rmsnorm(x, p["ln_attn"])
    q, k, v = L._project_qkv(
        h, p["attn"], positions, cfg.rope_theta,
        use_rope=(kind != "enc" or cfg.rope_on_encoder))
    q_axes = _q_layout(cfg, mode, seq_ok=not (kind == "local"
                                             and mode == "train"))
    q = constrain(q, q_axes)
    # per-rank attention: keys laid out with the queries' heads, or whole
    # (their gradient summed over the positions' axes) when the queries
    # are split by position
    kv_axes = ("batch", None, q_axes[2], None)
    kv_sum = {1: "seq", 2: "seq"} if q_axes[1] == "seq" else None
    window = cfg.window if kind == "local" else 0
    if mode == "decode":
        kc, vc, cpos = cache["k"], cache["v"], cache["pos"]
        slot = (positions[:, 0] % kc.shape[1]).long()
        if spmd.mesh() is None:
            rows = torch.arange(kc.shape[0], device=kc.device)
            kc[rows, slot] = k[:, 0].to(kc.dtype)
            vc[rows, slot] = v[:, 0].to(vc.dtype)
            cpos[rows, slot] = positions[:, 0].to(cpos.dtype)
        else:
            # a sharded cache: the slot written by a mask (elementwise,
            # local to each shard), a new cache as the reference returns
            hit = torch.arange(kc.shape[1], device=slot.device) \
                == slot[:, None]                             # (B, L)
            kc = torch.where(hit[..., None, None], k.to(kc.dtype), kc)
            vc = torch.where(hit[..., None, None], v.to(vc.dtype), vc)
            cpos = torch.where(hit, positions[:, :1].to(cpos.dtype), cpos)
            new_cache = dict(cache, k=kc, v=vc, pos=cpos)
        ctx = per_rank(
            functools.partial(L.decode_attention, window=window),
            (q, kc, vc, cpos, positions[:, 0]),
            (q_axes, kv_axes, kv_axes, ("batch", None), ("batch",)), q_axes)
    elif kind == "local" and mode == "train":
        ctx = per_rank(functools.partial(L.local_attention_banded,
                                         window=cfg.window),
                       (q, k, v), (q_axes, kv_axes, kv_axes), q_axes, kv_sum)
    else:
        ctx = per_rank(
            functools.partial(_chunked, causal=kind != "enc",
                              kv_block=cfg.kv_block, window=window),
            (q, k, v, positions, positions),
            (q_axes, kv_axes, kv_axes, q_axes[:2], ("batch", None)),
            q_axes, kv_sum)
        if mode == "prefill":
            keep = min(cfg.window, k.shape[1]) if kind == "local" else k.shape[1]
            new_cache = {"k": k[:, -keep:], "v": v[:, -keep:],
                         "pos": positions[:, -keep:]}
    x = x + L.attn_out(ctx, p["attn"])
    if kind == "xattn":
        h = L.rmsnorm(x, p["ln_cross"])
        dt = h.dtype
        # the projections merge (batch, positions): whole positions
        enc_out = constrain(enc_out, ("batch", None, None))
        qx = spmd.project(h, p["cross"]["wq"].to(dt))
        kx = spmd.project(enc_out, p["cross"]["wk"].to(enc_out.dtype))
        vx = spmd.project(enc_out, p["cross"]["wv"].to(enc_out.dtype))
        ctx = per_rank(
            functools.partial(_chunked, causal=False, kv_block=cfg.kv_block),
            (qx, kx, vx, positions, enc_positions),
            (("batch", None, None, None),) * 3 + (("batch", None),) * 2,
            ("batch", None, None, None))
        x = x + L.attn_out(ctx, p["cross"])
    return x, new_cache


def block_apply(cfg, kind, p, x, *, positions, mode, cache=None,
                enc_out=None, enc_positions=None):
    """One block forward.  mode: 'train' | 'prefill' | 'decode'.
    Returns (x, new_cache)."""
    check_kind(kind)
    new_cache = cache
    if kind in ATTN_KINDS:
        x, new_cache = _attn_apply(
            cfg, kind, p, x, positions=positions, mode=mode, cache=cache,
            enc_out=enc_out, enc_positions=enc_positions)
    elif kind == "rec":
        h = L.rmsnorm(x, p["ln_rec"])
        if mode == "decode":
            out, new_cache = M.rglru_step(h, p["rec"], cache)
        elif mode == "prefill":
            out, new_cache = M.rglru_apply(h, p["rec"], return_state=True)
        else:
            out = M.rglru_apply(h, p["rec"])
        x = x + out
    else:  # ssm
        h = L.rmsnorm(x, p["ln_ssm"])
        meta = _ssm_meta(cfg)
        if mode == "decode":
            out, new_cache = M.mamba2_step(h, p["ssm"], meta, cache)
        elif mode == "prefill":
            out, new_cache = M.mamba2_apply(h, p["ssm"], meta,
                                            chunk=cfg.ssm_chunk,
                                            return_state=True)
        else:
            out = M.mamba2_apply(h, p["ssm"], meta, chunk=cfg.ssm_chunk)
        return x + out, new_cache
    return _mlp_apply(cfg, p, x, mode), new_cache


def init_block_cache(cfg, kind, batch, cache_len, dtype=torch.bfloat16,
                     device=None):
    """An empty cache of one block: k/v/pos for attention (a ring of
    ``min(cache_len, window)`` rows for ``local``), the conv state in
    ``dtype`` and the recurrent state in float32 for ``rec`` and ``ssm``."""
    check_kind(kind)
    f32 = dict(dtype=torch.float32, device=device)
    if kind == "rec":
        w = cfg.lru_width or cfg.d_model
        return {"conv": torch.zeros((batch, 3, w), dtype=dtype, device=device),
                "h": torch.zeros((batch, w), **f32)}
    if kind == "ssm":
        meta = _ssm_meta(cfg)
        conv_dim = meta["d_inner"] + 2 * meta["n_groups"] * meta["d_state"]
        return {"conv": torch.zeros((batch, meta["d_conv"] - 1, conv_dim),
                                    dtype=dtype, device=device),
                "ssm": torch.zeros((batch, meta["n_heads"], meta["headdim"],
                                    meta["d_state"]), **f32)}
    L_ = min(cache_len, cfg.window) if kind == "local" else cache_len
    shape = (batch, L_, cfg.n_kv_heads, cfg.d_head)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((batch, L_), -1, dtype=torch.int32, device=device),
    }


# --------------------------------------------------------------------------
# Layer stack
# --------------------------------------------------------------------------


def _stack_init(generator, cfg, pattern, n_layers) -> list[dict]:
    """The parameter trees of ``n_layers`` blocks following ``pattern``
    cyclically, as a flat list."""
    return [block_init(generator, cfg, pattern[i % len(pattern)])
            for i in range(n_layers)]


def _stack_specs(cfg, pattern, n_layers) -> list[dict]:
    """The logical axes of :func:`_stack_init`'s blocks."""
    return [block_specs(cfg, pattern[i % len(pattern)])
            for i in range(n_layers)]


def _save_weight_products(ctx, op, *args, **kwargs):
    """Remat ``"dots"``: keep a product without a batch dimension (a 2-D
    ``mm``, or a ``bmm`` over a batch of one, which is how ``einsum``
    runs a weight product); recompute the rest."""
    if op is torch.ops.aten.mm.default or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def stack_apply(cfg, pattern, blocks, x, *, positions, mode, caches=None,
                enc_out=None, enc_positions=None):
    """Run the full layer stack.  ``caches``: one per block (or None).
    Returns (x, new_caches)."""
    glen = len(pattern)

    def run(i, x):
        return block_apply(
            cfg, pattern[i % glen], blocks[i], x, positions=positions,
            mode=mode, cache=None if caches is None else caches[i],
            enc_out=enc_out, enc_positions=enc_positions)

    new_caches, start = [], 0
    if (cfg.remat in ("full", "dots") and mode == "train"
            and torch.is_grad_enabled()):
        def group(x, first):
            for i in range(first, first + glen):
                x, _ = run(i, x)
            return x

        kw = {} if cfg.remat == "full" else dict(context_fn=functools.partial(
            create_selective_checkpoint_contexts, _save_weight_products))
        start = len(blocks) // glen * glen
        for first in range(0, start, glen):
            x = checkpoint(group, x, first, use_reentrant=False, **kw)
        new_caches = [None] * start     # training keeps no cache
    for i in range(start, len(blocks)):
        x, nc = run(i, x)
        new_caches.append(nc)
    return x, new_caches


def init_stack_caches(cfg, pattern, n_layers, batch, cache_len,
                      dtype=torch.bfloat16, device=None):
    return [init_block_cache(cfg, pattern[i % len(pattern)], batch,
                             cache_len, dtype, device)
            for i in range(n_layers)]
