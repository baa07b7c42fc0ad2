"""Architecture assembly, PyTorch port of ``repro.models.transformer``:
decoder-only, encoder-decoder and VLM stacks of the block kinds

  "attn"  (causal GQA + MLP), "local" (sliding-window GQA + MLP),
  "enc"   (bidirectional GQA + MLP), "xattn" (decoder self + cross + MLP).

The kinds "attn_moe", "rec" and "ssm" need ``models/mixers.py`` (MoE,
RG-LRU, Mamba-2 SSD), which ROADMAP queues as the next slice of the port;
they raise :class:`NotImplementedError`.

A stack is a flat list of blocks: layer ``i`` has kind
``pattern[i % len(pattern)]`` (the reference's layer ``g*len(pattern)+j``
of its scanned group ``g``, or of its unscanned tail).  The groups run in
a Python loop.  The reference's sharding and training machinery
(``set_mesh_rules``/``constrain``, remat policies, ``lax.scan`` over
stacked groups, ``block_specs``) has no counterpart: the port serves on
one device.

Modes are the reference's: ``"train"`` (a forward without a cache, which
the encoder runs), ``"prefill"`` and ``"decode"``.  Decode writes each
row's ring slot ``pos % cache_len`` of k, v and pos *in place* and returns
the same cache dict.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L

ATTN_KINDS = ("attn", "local", "enc", "xattn")
NEXT_SLICE_KINDS = ("attn_moe", "rec", "ssm")


def require_ported(kind: str) -> None:
    """Refuse a block kind this slice of the port does not run."""
    if kind in NEXT_SLICE_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} needs models/mixers.py (MoE, RG-LRU, "
            "Mamba-2 SSD), the next slice of the port in ROADMAP"
        )
    if kind not in ATTN_KINDS:
        raise ValueError(kind)


# --------------------------------------------------------------------------
# Block init / apply
# --------------------------------------------------------------------------


def block_init(generator, cfg, kind: str) -> dict:
    """The parameter tree of one block of the given kind."""
    require_ported(kind)
    dev = generator.device
    params = {
        "ln_attn": L.rmsnorm_init(cfg.d_model, dev),
        "attn": L.attention_init(
            generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
            qkv_bias=cfg.qkv_bias),
    }
    if kind == "xattn":
        params["ln_cross"] = L.rmsnorm_init(cfg.d_model, dev)
        params["cross"] = L.attention_init(
            generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
            qkv_bias=cfg.qkv_bias)
    params["ln_mlp"] = L.rmsnorm_init(cfg.d_model, dev)
    params["mlp"] = L.swiglu_init(generator, cfg.d_model, cfg.d_ff)
    return params


def _mlp_apply(cfg, p, x, mode="train"):
    h = L.rmsnorm(x, p["ln_mlp"])
    fn = L.geglu if cfg.mlp == "geglu" else L.swiglu
    return x + fn(h, p["mlp"])


def block_apply(cfg, kind, p, x, *, positions, mode, cache=None,
                enc_out=None, enc_positions=None):
    """One block forward.  mode: 'train' | 'prefill' | 'decode'.
    Returns (x, new_cache)."""
    require_ported(kind)
    new_cache = cache
    h = L.rmsnorm(x, p["ln_attn"])
    q, k, v = L._project_qkv(
        h, p["attn"], positions, cfg.rope_theta,
        use_rope=(kind != "enc" or cfg.rope_on_encoder))
    window = cfg.window if kind == "local" else 0
    if mode == "decode":
        kc, vc, cpos = cache["k"], cache["v"], cache["pos"]
        rows = torch.arange(kc.shape[0], device=kc.device)
        slot = (positions[:, 0] % kc.shape[1]).long()
        kc[rows, slot] = k[:, 0].to(kc.dtype)
        vc[rows, slot] = v[:, 0].to(vc.dtype)
        cpos[rows, slot] = positions[:, 0].to(cpos.dtype)
        ctx = L.decode_attention(q, kc, vc, cpos, positions[:, 0],
                                 window=window)
    elif kind == "local" and mode == "train":
        ctx = L.local_attention_banded(q, k, v, cfg.window)
    else:
        ctx = L.attention_chunked(
            q, k, v, causal=kind != "enc", kv_block=cfg.kv_block,
            q_positions=positions, kv_positions=positions, window=window)
        if mode == "prefill":
            keep = min(cfg.window, k.shape[1]) if kind == "local" else k.shape[1]
            new_cache = {"k": k[:, -keep:], "v": v[:, -keep:],
                         "pos": positions[:, -keep:]}
    x = x + L.attn_out(ctx, p["attn"])
    if kind == "xattn":
        h = L.rmsnorm(x, p["ln_cross"])
        dt = h.dtype
        qx = torch.einsum("bsd,dhk->bshk", h, p["cross"]["wq"].to(dt))
        kx = torch.einsum("bsd,dhk->bshk", enc_out,
                          p["cross"]["wk"].to(enc_out.dtype))
        vx = torch.einsum("bsd,dhk->bshk", enc_out,
                          p["cross"]["wv"].to(enc_out.dtype))
        ctx = L.attention_chunked(
            qx, kx, vx, causal=False, kv_block=cfg.kv_block,
            q_positions=positions, kv_positions=enc_positions)
        x = x + L.attn_out(ctx, p["cross"])
    return _mlp_apply(cfg, p, x, mode), new_cache


def init_block_cache(cfg, kind, batch, cache_len, dtype=torch.bfloat16,
                     device=None):
    require_ported(kind)
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


def stack_apply(cfg, pattern, blocks, x, *, positions, mode, caches=None,
                enc_out=None, enc_positions=None):
    """Run the full layer stack.  ``caches``: one per block (or None).
    Returns (x, new_caches)."""
    new_caches = []
    for i, p in enumerate(blocks):
        x, nc = block_apply(
            cfg, pattern[i % len(pattern)], p, x, positions=positions,
            mode=mode, cache=None if caches is None else caches[i],
            enc_out=enc_out, enc_positions=enc_positions)
        new_caches.append(nc)
    return x, new_caches


def init_stack_caches(cfg, pattern, n_layers, batch, cache_len,
                      dtype=torch.bfloat16, device=None):
    return [init_block_cache(cfg, pattern[i % len(pattern)], batch,
                             cache_len, dtype, device)
            for i in range(n_layers)]
