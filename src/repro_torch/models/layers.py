"""Core transformer layers of the LM substrate, PyTorch port of
``repro.models.layers``.

Conventions (the reference's):

  * activations are (batch, seq, d_model) in ``cfg.act_dtype``;
  * parameters are fp32 masters; every product casts its weight to the
    activation dtype where it is used;
  * a parameter tree is nested mappings and lists with the reference's
    names, shapes and layouts.  The functions read ``p["wq"]``, ``"bq" in
    p`` and so on, from a dict of tensors or from a :class:`ParamTree`,
    the ``nn.Module`` that holds a model's tree as ``nn.Parameter``\\ s.

The init functions draw from an explicit ``torch.Generator`` and allocate
on that generator's device.  Their shapes, layouts and scales are the
reference's; their values are not, because JAX's PRNG is not torch's
(:func:`repro_torch.models.convert.params_from_numpy` carries the
reference's own values over).  Beside each init function sits its tree of
logical axes (``swiglu_specs``, ``attention_specs``, ``RMSNORM_SPEC``,
``EMBEDDING_SPEC``): the reference's second return value, which
``repro_torch.launch.sharding`` maps onto a device mesh.

Attention's score and PV products accumulate in float32 from
activation-dtype operands, as the reference's ``preferred_element_type=
float32`` does: the operands are upcast to float32 (a bf16 x bf16 product
is exact in float32) and multiplied with TF32 off, which
:func:`repro_torch.models.model_zoo.build_model` sets.
``F.scaled_dot_product_attention`` is not used: the tests hold the
reference's masking and rounding.  :func:`chunked_cross_entropy`'s
vocabulary products are float32 products of upcast operands likewise.
"""
from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import spmd


class ParamTree(nn.Module):
    """A parameter tree (nested dicts and lists of tensors) as modules.

    A dict becomes a :class:`ParamTree`, a list an ``nn.ModuleList``, a
    tensor an ``nn.Parameter``, all under the reference's names, so
    ``state_dict`` keys are the reference's paths (``layers.3.attn.wq``).
    Reads are the reference's: ``p["attn"]["wq"]``, ``"bq" in
    p["attn"]``.  A module given as a value is shared, not copied.  The
    parameters hold no gradient (serving); ``tree.requires_grad_()`` makes
    the tree trainable, as :class:`repro_torch.train.Trainer` does.
    """

    def __init__(self, tree: Mapping):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, nn.Module):
                self.add_module(name, value)
            elif isinstance(value, Mapping):
                self.add_module(name, ParamTree(value))
            elif isinstance(value, (list, tuple)):
                self.add_module(name, nn.ModuleList(
                    v if isinstance(v, nn.Module) else ParamTree(v)
                    for v in value
                ))
            elif isinstance(value, nn.Parameter):
                self.register_parameter(name, value)
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def named_leaves(tree, prefix: str = "") -> dict:
    """The leaves of a tree (mappings, lists, modules such as a
    :class:`ParamTree`, and tensors, arrays or numbers) keyed by their
    ``/``-joined paths, ``layers/3/attn/wq``, in the tree's own order.  A
    mapping already keyed by paths gives itself."""
    if isinstance(tree, nn.Module):
        return {prefix + name.replace(".", "/"): p
                for name, p in tree.named_parameters()}
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for key, value in items:
        out.update(named_leaves(value, f"{prefix}{key}/"))
    return out


def _init_dense(generator, shape, in_axis=0, dtype=torch.float32):
    fan_in = shape[in_axis] if isinstance(in_axis, int) else int(
        np.prod([shape[a] for a in in_axis])
    )
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    return out.normal_(generator=generator).mul_(scale)


def dense_init(generator, shape, logical, in_axis=0):
    return _init_dense(generator, shape, in_axis), logical


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------


RMSNORM_SPEC = ("embed",)
EMBEDDING_SPEC = ("vocab", "embed")


def rmsnorm_init(d, device):
    return torch.ones((d,), dtype=torch.float32, device=device)


def rmsnorm(x, scale, eps=1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale).to(dt)


def layernorm_init(d, device):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm(x, p, eps=1e-6):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * p["scale"]
            + p["bias"]).to(dt)


# --------------------------------------------------------------------------
# Rotary position embedding
# --------------------------------------------------------------------------


def rope(x, positions, theta=10000.0):
    """x: (..., seq, heads, d_head); positions: (..., seq).  The head is
    split in halves (not interleaved); the angles are float32."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    angles = positions[..., None].float() * freqs  # (..., S, half)
    angles = angles[..., None, :]  # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------


def swiglu_init(generator, d, f):
    return {
        "wi": _init_dense(generator, (d, f)),
        "wg": _init_dense(generator, (d, f)),
        "wo": _init_dense(generator, (f, d)),
    }


def swiglu_specs():
    return {"wi": ("embed", "mlp"), "wg": ("embed", "mlp"),
            "wo": ("mlp", "embed")}


def swiglu(x, p):
    dt = x.dtype
    h = x @ p["wi"].to(dt)
    g = x @ p["wg"].to(dt)
    h = F.silu(g) * h
    return h @ p["wo"].to(dt)


def geglu(x, p):
    dt = x.dtype
    h = x @ p["wi"].to(dt)
    g = x @ p["wg"].to(dt)
    h = F.gelu(g, approximate="tanh") * h   # jax.nn.gelu's default
    return h @ p["wo"].to(dt)


# --------------------------------------------------------------------------
# Attention (GQA) — full chunked, local windowed, cross, and decode
# --------------------------------------------------------------------------


def attention_init(generator, d_model, n_heads, n_kv, d_head, qkv_bias=False):
    params = {
        "wq": _init_dense(generator, (d_model, n_heads, d_head)),
        "wk": _init_dense(generator, (d_model, n_kv, d_head)),
        "wv": _init_dense(generator, (d_model, n_kv, d_head)),
        "wo": _init_dense(generator, (n_heads, d_head, d_model),
                          in_axis=(0, 1)),
    }
    if qkv_bias:
        dev = generator.device
        params["bq"] = torch.zeros((n_heads, d_head), device=dev)
        params["bk"] = torch.zeros((n_kv, d_head), device=dev)
        params["bv"] = torch.zeros((n_kv, d_head), device=dev)
    return params


def attention_specs(qkv_bias=False):
    specs = {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv", "head_dim"),
        "wv": ("embed", "kv", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }
    if qkv_bias:
        specs["bq"] = ("heads", "head_dim")
        specs["bk"] = ("kv", "head_dim")
        specs["bv"] = ("kv", "head_dim")
    return specs


def _project_qkv(x, p, positions, theta, use_rope=True):
    dt = x.dtype
    q = spmd.project(x, p["wq"].to(dt))
    k = spmd.project(x, p["wk"].to(dt))
    v = spmd.project(x, p["wv"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if use_rope:
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
    return q, k, v


def _repeat_kv(k, n_heads):
    """(B,S,Hkv,D) -> (B,S,Hq,D) by repeating groups."""
    n_kv = k.shape[2]
    if n_kv == n_heads:
        return k
    return k.repeat_interleave(n_heads // n_kv, dim=2)


def _positions(B, S, device):
    return torch.arange(S, dtype=torch.int32, device=device)[None].repeat(B, 1)


def attention_chunked(q, k, v, *, causal=True, kv_block=1024,
                      q_positions=None, kv_positions=None, window=0):
    """Memory-bounded attention: a loop over KV chunks with an online
    softmax, live memory O(B*H*Sq*kv_block) instead of O(B*H*Sq*Skv).

    GQA is grouped (K/V are never expanded); padded keys get position
    ``-1e9``; masked scores are ``-1e30``; ``window > 0`` also masks keys
    older than ``window`` positions; the sum is normalised by
    ``max(l, 1e-30)``.
    """
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    if q_positions is None:
        q_positions = _positions(B, Sq, q.device)
    if kv_positions is None:
        kv_positions = _positions(B, Skv, q.device)
    scale = 1.0 / math.sqrt(D)
    n_blocks = -(-Skv // kv_block)
    pad = n_blocks * kv_block - Skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = F.pad(kv_positions, (0, pad), value=-(10 ** 9))
    qpb = q_positions[:, None, None, :, None]
    m = torch.full((B, Hkv, G, Sq), -1e30, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, Sq, D), dtype=torch.float32,
                      device=q.device)
    for i in range(n_blocks):
        blk = slice(i * kv_block, (i + 1) * kv_block)
        kc, vc, pc = k[:, blk], v[:, blk], kv_positions[:, blk]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kc.float()) * scale
        pcb = pc[:, None, None, None, :]
        mask = pcb >= 0
        if causal:
            mask = mask & (pcb <= qpb)
        if window:
            mask = mask & (pcb > qpb - window)
        s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(vc.dtype).float(), vc.float())
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]     # (B,Hkv,G,Sq,D)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)
    return out.to(q.dtype)


def local_attention_banded(q, k, v, window, q_positions=None):
    """Sliding-window attention as a 1-D *stencil*: queries in block i
    attend to keys in blocks {i-1, i} only (block size == window), a
    sequence partition plus one halo block.  Memory O(S * 2W)."""
    B, S, H, D = q.shape
    k = _repeat_kv(k, H)
    v = _repeat_kv(v, H)
    W = window
    n = -(-S // W)
    Sp = n * W
    pad = Sp - S
    qp = F.pad(q, (0, 0, 0, 0, 0, pad))
    kp = F.pad(k, (0, 0, 0, 0, 0, pad))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad))
    pos = torch.arange(Sp, device=q.device)
    qb = qp.reshape(B, n, W, H, D)
    # halo: previous key block prepended (zeros for block 0 = exterior-zero)
    kb = kp.reshape(B, n, W, H, D)
    vb = vp.reshape(B, n, W, H, D)
    k_halo = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1)
    v_halo = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1)
    k2 = torch.cat([k_halo, kb], dim=2)  # (B,n,2W,H,D)
    v2 = torch.cat([v_halo, vb], dim=2)
    qpos = pos.reshape(n, W)
    kpos = torch.cat([qpos - W, qpos], dim=1)  # block 0's halo: masked
    s = torch.einsum("bnqhd,bnkhd->bnhqk", qb.float(),
                     k2.float()) / math.sqrt(D)
    mask = (kpos[:, None, :] <= qpos[:, :, None]) & \
           (kpos[:, None, :] > qpos[:, :, None] - W) & \
           (kpos[:, None, :] >= 0) & (qpos[:, :, None] < S)
    s = torch.where(mask[None, :, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bnhqk,bnkhd->bnqhd", p, v2.float())
    return out.reshape(B, Sp, H, D)[:, :S].to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_positions, q_position,
                     window=0):
    """Single-step decode: q (B,1,H,D) against a (B,L,Hkv,D) cache.

    q is cast to the cache dtype; the cache is never expanded across GQA
    groups; keys are masked to ``0 <= pos <= q_pos`` (and the window)."""
    B, _, H, D = q.shape
    Hkv = k_cache.shape[2]
    G = H // Hkv
    qg = q.reshape(B, 1, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(k_cache.dtype).float(),
                     k_cache.float()) / math.sqrt(D)
    cp = cache_positions[:, None, None, None, :]
    qp = q_position[:, None, None, None, None]
    mask = (cp <= qp) & (cp >= 0)
    if window:
        mask = mask & (cp > qp - window)
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


def attn_out(ctx, p):
    return torch.einsum("bshk,hkd->bsd", ctx, p["wo"].to(ctx.dtype))


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------


def embedding_init(generator, vocab, d):
    """The table, with fan-in the vocabulary (the reference's ``in_axis=0``),
    and its logical axes."""
    return _init_dense(generator, (vocab, d)), EMBEDDING_SPEC


def embed(tokens, table, dtype):
    return table[tokens].to(dtype)


def unembed(x, table):
    return torch.einsum("bsd,vd->bsv", x, table.to(x.dtype))


def _chunk_stats(h, tc, tgt, m, l, tlogit, first: int, V: int):
    """One vocabulary chunk (rows ``first:first+len(tc)`` of the padded
    table) folded into the online logsumexp ``(m, l)`` and the target
    logit."""
    Vc = tc.shape[0]
    logits = spmd.rows_by_table(h.float(), tc.to(h.dtype).float())
    vidx = first + torch.arange(Vc, device=h.device)
    logits = torch.where(vidx < V, logits, -1e30)       # vocabulary padding
    m_new = torch.maximum(m, logits.amax(-1))
    l = l * torch.exp(m - m_new) + torch.exp(
        logits - m_new[..., None]).sum(-1)
    local = tgt - first
    in_chunk = (local >= 0) & (local < Vc)
    got = torch.gather(logits, -1, local.clamp(0, Vc - 1)[..., None])[..., 0]
    return m_new, l, torch.where(in_chunk, got, tlogit)


def chunked_cross_entropy(h, table, targets, valid, n_chunks=8):
    """Token cross-entropy WITHOUT materialising (B, S, V) logits.

    Walks the vocabulary in ``n_chunks`` chunks with an online logsumexp
    and a target-logit gather; each chunk is recomputed in the backward
    pass (``torch.utils.checkpoint``, as the reference's
    ``jax.checkpoint``), so live memory is O(B*S*V/n_chunks).  The
    products are float32 over activation-dtype operands (the reference's
    ``preferred_element_type=float32``).

    Returns (sum_nll, n_valid).
    """
    B, S, _ = h.shape
    V = table.shape[0]
    Vc = -(-V // n_chunks)
    pad = n_chunks * Vc - V
    tbl = F.pad(table, (0, 0, 0, pad)) if pad else table
    tgt = torch.where(valid, targets, 0)
    m = torch.full((B, S), -1e30, dtype=torch.float32, device=h.device)
    l = torch.zeros((B, S), dtype=torch.float32, device=h.device)
    tlogit = torch.zeros((B, S), dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        m, l, tlogit = checkpoint(
            _chunk_stats, h, tbl[c * Vc:(c + 1) * Vc], tgt, m, l, tlogit,
            c * Vc, V, use_reentrant=False)
    nll = m + torch.log(torch.clamp_min(l, 1e-30)) - tlogit
    nll = torch.where(valid, nll, 0.0)
    return nll.sum(), valid.sum()
