"""Sequence and channel mixers beyond vanilla attention, PyTorch port of
``repro.models.mixers``: MoE, Mamba-2 SSD and RG-LRU.

Each mixer keeps the reference's names, arguments and parameter layout:

  * ``*_init(generator, ...)`` returns the parameter tree (and, for
    Mamba-2, its ``meta``), drawn from ``generator`` on its device; the
    reference's logical specs have no counterpart (one device);
  * a full-sequence apply (prefill), and
  * a single-token decode step with an explicit recurrent state.

Every op keeps the reference's dtype: products in the activation dtype
from weights cast where they are used; routing, SSD and RG-LRU state
arithmetic in float32.  The reference's expert-parallel dispatch
(``moe_apply_ep``, a ``shard_map`` program over a mesh) has no counterpart:
the port serves on one device, where the reference also takes
:func:`moe_apply`.

Where the reference leans on an XLA primitive, the port writes it out:

  * the MoE combine (``.at[tok].add``, a scatter-add) sums each token's
    ``top_k`` expert rows in a fixed order (the reference's: ascending
    expert), so two runs on a card agree bitwise (no atomics);
  * SSD's three- and four-operand ``einsum``\\ s are pairwise products, so
    no (B, nc, Q, Q, heads, headdim) tensor is formed;
  * ``lax.scan`` over SSD chunks and RG-LRU chunks is a Python loop, and
    RG-LRU's in-chunk ``associative_scan`` is a Hillis-Steele doubling
    scan with the same combine (no cumulative product, which underflows).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers


# ==========================================================================
# Mixture of Experts (top-k routing, optional shared experts)
# ==========================================================================


def moe_init(generator, d_model, n_experts, d_ff_expert, top_k,
             n_shared=0, d_ff_shared=0, n_experts_padded=0):
    """``n_experts_padded``: the stored expert count (qwen's 60 are stored
    as 64).  Padding experts exist in the weights, but their router logits
    are masked, so they never receive a token."""
    E_store = max(n_experts_padded, n_experts)
    params = {
        "router": layers._init_dense(generator, (d_model, E_store)),
        "wi": layers._init_dense(generator, (E_store, d_model, d_ff_expert),
                                 in_axis=1),
        "wg": layers._init_dense(generator, (E_store, d_model, d_ff_expert),
                                 in_axis=1),
        "wo": layers._init_dense(generator, (E_store, d_ff_expert, d_model),
                                 in_axis=1),
    }
    if n_shared:
        params["shared"] = layers.swiglu_init(generator, d_model, d_ff_shared)
    return params


def moe_apply(x, p, *, top_k: int, capacity_factor: float = 1.25,
              return_aux: bool = False, dropless: bool = False,
              n_experts_real: int = 0):
    """Capacity-based sorted dispatch (GShard-style, sort and scatter).

    Tokens are sorted by expert (stable), packed into an (E, capacity, D)
    buffer, run through one batched SwiGLU per matrix and combined back
    weighted by their router probabilities.  A token past its expert's
    capacity is dropped; ``dropless`` sets the capacity to ``T * top_k``.
    """
    B, S, D = x.shape
    T = B * S
    E = p["router"].shape[1]
    n_real = n_experts_real or E
    dev = x.device
    xt = x.reshape(T, D)
    logits = xt.float() @ p["router"].float()
    if n_real < E:  # mask padding experts out of the routing distribution
        logits = torch.where(torch.arange(E, device=dev) < n_real, logits,
                             -1e30)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, top_k, dim=-1)           # (T, k)
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)

    Tk = T * top_k
    e_flat = topi.reshape(-1)                                # (T*k,)
    w_flat = topw.reshape(-1)
    tok_flat = torch.arange(Tk, device=dev) // top_k
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    tok_sorted = tok_flat[order]
    w_sorted = w_flat[order]
    starts = torch.searchsorted(e_sorted, torch.arange(E, device=dev))
    pos_sorted = torch.arange(Tk, device=dev) - starts[e_sorted]
    if dropless:
        cap = Tk  # worst case: every token routed to one expert
    else:
        cap = max(int(math.ceil(Tk / n_real * capacity_factor)), 1)
    keep = pos_sorted < cap

    # pack: a kept row goes to slot e*cap + pos of a flat buffer, a dropped
    # one to the one spare row past the E*cap slots (the reference's
    # mode="drop" scatter), which the experts never read
    dt = x.dtype
    slot = torch.where(keep, e_sorted * cap + pos_sorted, E * cap)
    flat = torch.zeros((E * cap + 1, D), dtype=dt, device=dev)
    flat[slot] = xt[tok_sorted]
    buf = flat[:E * cap].view(E, cap, D)
    h = torch.bmm(buf, p["wi"].to(dt))
    g = torch.bmm(buf, p["wg"].to(dt))
    h = F.silu(g) * h
    out_buf = torch.bmm(h, p["wo"].to(dt)).view(E * cap, D)

    gathered = out_buf[torch.where(keep, slot, 0)]
    gathered = gathered * (w_sorted * keep)[:, None].to(dt)
    # combine: each token's k rows, in the order the sorted dispatch holds
    # them (ascending expert), added one at a time in the activation dtype
    rows = gathered[torch.argsort(tok_sorted, stable=True)].view(T, top_k, D)
    y = rows[:, 0]
    for j in range(1, top_k):
        y = y + rows[:, j]

    if "shared" in p:
        y = y + layers.swiglu(xt, p["shared"])
    y = y.reshape(B, S, D)
    if return_aux:
        # Switch-style load balance loss
        density = F.one_hot(topi[:, 0], E).float().mean(0)
        aux = E * torch.sum(density * probs.mean(0))
        return y, {"load_balance": aux,
                   "dropped_frac": 1.0 - keep.float().mean()}
    return y


# ==========================================================================
# Mamba-2 (SSD, state space duality, chunked scan)  [arXiv:2405.21060]
# ==========================================================================


def mamba2_init(generator, d_model, *, d_state=128, headdim=64, expand=2,
                d_conv=4, n_groups=1):
    """(params, meta).  ``A_log`` and ``dt_bias`` are the reference's
    deterministic values."""
    dev = generator.device
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    conv_dim = d_inner + 2 * n_groups * d_state
    f32 = dict(dtype=torch.float32, device=dev)
    params = {
        "in_proj": layers._init_dense(
            generator, (d_model, 2 * d_inner + 2 * n_groups * d_state
                        + n_heads)),
        "conv_w": layers._init_dense(generator, (d_conv, conv_dim)) * 0.5,
        "conv_b": torch.zeros((conv_dim,), **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_heads, **f32)),
        "D": torch.ones((n_heads,), **f32),
        "dt_bias": torch.log(torch.expm1(torch.linspace(1e-3, 0.1, n_heads,
                                                        **f32))),
        "norm": torch.ones((d_inner,), **f32),
        "out_proj": layers._init_dense(generator, (d_inner, d_model)),
    }
    meta = dict(d_inner=d_inner, n_heads=n_heads, headdim=headdim,
                d_state=d_state, d_conv=d_conv, n_groups=n_groups)
    return params, meta


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv1d; x (B,S,C), w (K,C).  Returns (y, new_state).
    The K products are summed in order i = 0..K-1."""
    K = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xx = torch.cat([state, x], dim=1)
    S = x.shape[1]
    y = xx[:, 0:S] * w[0].to(x.dtype)
    for i in range(1, K):
        y = y + xx[:, i:i + S] * w[i].to(x.dtype)
    new_state = xx[:, -(K - 1):].contiguous() if K > 1 else state
    return y + b.to(x.dtype), new_state


def _split_zxbcdt(z_x_b_c_dt, meta):
    di, ng, ns, nh = (meta["d_inner"], meta["n_groups"], meta["d_state"],
                      meta["n_heads"])
    z = z_x_b_c_dt[..., :di]
    xBC = z_x_b_c_dt[..., di:di + di + 2 * ng * ns]
    dt = z_x_b_c_dt[..., -nh:]
    return z, xBC, dt


def _decay(a):
    """``exp(clip(a, -60, 0))``, the reference's guard on every decay."""
    return torch.exp(torch.clamp(a, -60.0, 0.0))


def mamba2_apply(x, p, meta, *, chunk=64, state=None, return_state=False):
    """Full-sequence SSD forward, chunked; the chunks run in a loop."""
    B, S, _ = x.shape
    di, nh, pd, ns, ng = (meta["d_inner"], meta["n_heads"], meta["headdim"],
                          meta["d_state"], meta["n_groups"])
    dt_act = x.dtype
    zxbcdt = x @ p["in_proj"].to(dt_act)
    z, xBC, dt = _split_zxbcdt(zxbcdt, meta)
    conv_state = None if state is None else state["conv"]
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_state)
    xBC = F.silu(xBC)
    xs = xBC[..., :di].reshape(B, S, nh, pd)
    Bm = xBC[..., di:di + ng * ns].reshape(B, S, ng, ns)
    Cm = xBC[..., di + ng * ns:].reshape(B, S, ng, ns)
    # broadcast groups over heads
    Bm = Bm.repeat_interleave(nh // ng, dim=2)               # (B,S,nh,ns)
    Cm = Cm.repeat_interleave(nh // ng, dim=2)
    dt = F.softplus(dt.float() + p["dt_bias"])                # (B,S,nh)
    A = -torch.exp(p["A_log"])                                # (nh,)
    dA = dt * A                                               # (B,S,nh)

    # pad S to a chunk multiple
    nc = -(-S // chunk)
    Sp = nc * chunk
    pad = Sp - S
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))

    def rs(a, *shape):
        return a.reshape(B, nc, chunk, *shape)

    xs_c = rs(xs, nh, pd).float()
    B_c = rs(Bm, nh, ns).float()
    C_c = rs(Cm, nh, ns).float()
    dA_c, dt_c = rs(dA, nh), rs(dt, nh)
    Acum = torch.cumsum(dA_c, dim=2)                          # (B,nc,Q,nh)
    # intra-chunk (diagonal) term: L[i,j] = exp(Acum_i - Acum_j) for i >= j
    Lmat = _decay(Acum[:, :, :, None, :] - Acum[:, :, None, :, :])
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    Lmat = torch.where(tri[None, None, :, :, None], Lmat, 0.0)
    # (b,n,h,q,s) x (b,n,h,s,k): scores[q,k] = C_q . B_k
    scores = torch.matmul(C_c.permute(0, 1, 3, 2, 4),
                          B_c.permute(0, 1, 3, 4, 2))         # (B,nc,nh,Q,Q)
    M = scores * Lmat.permute(0, 1, 4, 2, 3) \
        * dt_c.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_diag = torch.matmul(M, xs_c.permute(0, 1, 3, 2, 4))    # (B,nc,nh,Q,pd)
    # per-chunk input -> final-state contribution
    decay_to_end = _decay(Acum[:, :, -1:, :] - Acum)          # (B,nc,Q,nh)
    Bw = B_c * (dt_c * decay_to_end)[..., None]               # (B,nc,Q,nh,ns)
    chunk_states = torch.matmul(xs_c.permute(0, 1, 3, 4, 2),
                                Bw.permute(0, 1, 3, 2, 4))    # (B,nc,nh,pd,ns)
    chunk_decay = _decay(Acum[:, :, -1, :])                   # (B,nc,nh)

    h = (torch.zeros((B, nh, pd, ns), dtype=torch.float32, device=x.device)
         if state is None else state["ssm"].float())
    h_prevs = []
    for n in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, n, :, None, None] + chunk_states[:, n]
    h_prevs = torch.stack(h_prevs, dim=1)                     # (B,nc,nh,pd,ns)
    Ce = C_c * _decay(Acum)[..., None]                        # (B,nc,Q,nh,ns)
    y_off = torch.matmul(Ce.permute(0, 1, 3, 2, 4),
                         h_prevs.transpose(-1, -2))           # (B,nc,nh,Q,pd)
    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(B, Sp, nh, pd)[:, :S]
    y = y + xs.reshape(B, Sp, nh, pd)[:, :S].float() \
        * p["D"][None, None, :, None]
    y = y.reshape(B, S, di)
    y = layers.rmsnorm(y.to(dt_act), p["norm"]) * F.silu(z)
    out = y @ p["out_proj"].to(dt_act)
    if return_state:
        return out, {"conv": new_conv, "ssm": h}
    return out


def mamba2_step(x1, p, meta, state):
    """Single-token decode: x1 (B,1,D) with a {'conv', 'ssm'} state."""
    B = x1.shape[0]
    di, nh, pd, ns, ng = (meta["d_inner"], meta["n_heads"], meta["headdim"],
                          meta["d_state"], meta["n_groups"])
    dt_act = x1.dtype
    zxbcdt = x1 @ p["in_proj"].to(dt_act)
    z, xBC, dt = _split_zxbcdt(zxbcdt, meta)
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"], state["conv"])
    xBC = F.silu(xBC)
    xs = xBC[..., :di].reshape(B, nh, pd).float()
    Bm = xBC[..., di:di + ng * ns].reshape(B, ng, ns).repeat_interleave(
        nh // ng, dim=1).float()
    Cm = xBC[..., di + ng * ns:].reshape(B, ng, ns).repeat_interleave(
        nh // ng, dim=1).float()
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])          # (B,nh)
    A = -torch.exp(p["A_log"])
    dec = torch.exp(dt * A)                                   # (B,nh)
    h = state["ssm"].float()
    h = h * dec[:, :, None, None] \
        + (dt[:, :, None] * xs)[..., None] * Bm[:, :, None, :]
    y = torch.matmul(h, Cm[..., None])[..., 0]                # (B,nh,pd)
    y = y + xs * p["D"][None, :, None]
    y = y.reshape(B, 1, di)
    y = layers.rmsnorm(y.to(dt_act), p["norm"]) * F.silu(z)
    out = y @ p["out_proj"].to(dt_act)
    return out, {"conv": new_conv, "ssm": h}


# ==========================================================================
# RG-LRU (Griffin / RecurrentGemma)  [arXiv:2402.19427]
# ==========================================================================


def rglru_init(generator, d_model, *, lru_width=None, d_conv=4):
    dev = generator.device
    w = lru_width or d_model
    # Lambda init so that a = exp(-8*softplus(L)*r) spans useful decays
    lam = torch.empty((w,), dtype=torch.float32, device=dev).uniform_(
        0.38, 0.65, generator=generator)
    zeros = dict(dtype=torch.float32, device=dev)
    return {
        "in_x": layers._init_dense(generator, (d_model, w)),
        "in_gate": layers._init_dense(generator, (d_model, w)),
        "conv_w": layers._init_dense(generator, (d_conv, w)) * 0.5,
        "conv_b": torch.zeros((w,), **zeros),
        "wa": layers._init_dense(generator, (w, w)) * 0.1,
        "wx": layers._init_dense(generator, (w, w)) * 0.1,
        "ba": torch.zeros((w,), **zeros),
        "bx": torch.zeros((w,), **zeros),
        "Lambda": torch.log(torch.exp(-torch.log(lam) * 0.125) - 1.0),
        "out": layers._init_dense(generator, (w, d_model)),
    }


_C_RGLRU = 8.0


def _rglru_gates(xc, p):
    """The recurrence's (a, b), float32: gates in the activation dtype,
    ``log_a``, ``a`` and ``b`` in float32."""
    dt = xc.dtype
    r = torch.sigmoid(xc @ p["wa"].to(dt) + p["ba"].to(dt))
    i = torch.sigmoid(xc @ p["wx"].to(dt) + p["bx"].to(dt))
    log_a = -_C_RGLRU * F.softplus(p["Lambda"]) * r.float()   # (B,S,w) <= 0
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    b = mult * (i.float() * xc.float())
    return a, b


def _linear_scan(a, b):
    """Inclusive scan of h_t = a_t * h_{t-1} + b_t along dim 1 from h = 0,
    as (A, H) with h_t = A_t * h_in + H_t: Hillis-Steele doubling with the
    reference's combine ``(a1, b1), (a2, b2) -> (a1*a2, a2*b1 + b2)``."""
    A, H = a, b
    d = 1
    while d < A.shape[1]:
        H = torch.cat([H[:, :d], A[:, d:] * H[:, :-d] + H[:, d:]], dim=1)
        A = torch.cat([A[:, :d], A[:, :-d] * A[:, d:]], dim=1)
        d *= 2
    return A, H


def rglru_apply(x, p, *, state=None, return_state=False, chunk=256):
    """Griffin recurrent block: linear -> conv1d -> RG-LRU, gated by a GeLU
    branch, then the output projection.

    The linear recurrence runs in chunks of ``chunk`` steps: a scan within
    a chunk (:func:`_linear_scan`), the state carried across chunks by a
    loop.  Padding steps of the last chunk are the identity (1, 0).
    """
    dt = x.dtype
    B, S, _ = x.shape
    xw = x @ p["in_x"].to(dt)
    gate = F.gelu(x @ p["in_gate"].to(dt), approximate="tanh")
    conv_state = None if state is None else state["conv"]
    xc, new_conv = _causal_conv(xw, p["conv_w"], p["conv_b"], conv_state)
    w = xc.shape[-1]
    h_in = (torch.zeros((B, w), dtype=torch.float32, device=x.device)
            if state is None else state["h"].float())

    Q = min(chunk, S)
    nc = -(-S // Q)
    xc_p = F.pad(xc, (0, 0, 0, nc * Q - S))
    valid = (torch.arange(nc * Q, device=x.device) < S)[:, None]
    hs = []
    for c in range(nc):
        blk = slice(c * Q, (c + 1) * Q)
        a_c, b_c = _rglru_gates(xc_p[:, blk], p)    # float32, one chunk
        a_c = torch.where(valid[blk], a_c, 1.0)     # pad steps: identity
        b_c = torch.where(valid[blk], b_c, 0.0)
        A, H = _linear_scan(a_c, b_c)
        h_t = A * h_in[:, None] + H                 # (B,Q,w)
        h_in = h_t[:, -1]
        hs.append(h_t.to(dt))
    h = torch.cat(hs, dim=1)[:, :S]
    y = h * gate
    out = y @ p["out"].to(dt)
    if return_state:
        return out, {"conv": new_conv, "h": h_in}
    return out


def rglru_step(x1, p, state):
    return rglru_apply(x1, p, state=state, return_state=True)
