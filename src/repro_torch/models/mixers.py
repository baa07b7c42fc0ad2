"""Sequence and channel mixers beyond vanilla attention, PyTorch port of
``repro.models.mixers``: MoE, Mamba-2 SSD and RG-LRU.

Each mixer keeps the reference's names, arguments and parameter layout:

  * ``*_init(generator, ...)`` returns the parameter tree (and, for
    Mamba-2, its ``meta``), drawn from ``generator`` on its device; its
    logical axes, the reference's second return value, come from
    ``moe_specs``, ``mamba2_specs`` and ``rglru_specs``;
  * a full-sequence apply (prefill), and
  * a single-token decode step with an explicit recurrent state.

Every op keeps the reference's dtype: products in the activation dtype
from weights cast where they are used; routing, SSD and RG-LRU state
arithmetic in float32.  :func:`moe_apply` pins the dispatch buffers with
``spmd.constrain`` (the reference's ``transformer.constrain``) (the identity without a
mesh).  :func:`moe_apply_ep` is the reference's expert-parallel dispatch
over a device mesh: a ``local_map`` program whose collectives are
autograd-aware (see its docstring); ``transformer._mlp_apply`` takes it
under the reference's conditions.

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

from repro_torch.models import layers, spmd


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


def moe_specs(n_shared=0):
    specs = {
        "router": ("embed", "expert"),
        "wi": ("expert", "embed", "mlp"),
        "wg": ("expert", "embed", "mlp"),
        "wo": ("expert", "mlp", "embed"),
    }
    if n_shared:
        specs["shared"] = layers.swiglu_specs()
    return specs


def _route(xt, router, top_k: int, n_real: int):
    """Top-k routing of the tokens ``xt`` (T, D), sorted (stable) by
    expert: (probs, topi, e_sorted, tok_sorted, w_sorted, pos_sorted),
    ``pos_sorted`` a row's place in its expert's queue."""
    T = xt.shape[0]
    E = router.shape[1]
    dev = xt.device
    logits = xt.float() @ router.float()
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
    starts = torch.searchsorted(e_sorted, torch.arange(E, device=dev))
    pos_sorted = torch.arange(Tk, device=dev) - starts[e_sorted]
    return (probs, topi, e_sorted, tok_flat[order], w_flat[order],
            pos_sorted)


def _capacity(Tk: int, n_real: int, capacity_factor: float,
              dropless: bool) -> int:
    if dropless:
        return Tk  # worst case: every token routed to one expert
    return max(int(math.ceil(Tk / n_real * capacity_factor)), 1)


def _experts(buf, wi, wg, wo):
    """One batched SwiGLU per expert over the (E, cap, D) buffer."""
    dt = buf.dtype
    h = torch.bmm(buf, wi.to(dt))
    g = torch.bmm(buf, wg.to(dt))
    return torch.bmm(F.silu(g) * h, wo.to(dt))


def _combine(gathered, tok_sorted, T: int, top_k: int):
    """Each token's k rows, in the order the sorted dispatch holds them
    (ascending expert), added one at a time in the activation dtype."""
    rows = gathered[torch.argsort(tok_sorted, stable=True)].view(
        T, top_k, gathered.shape[-1])
    y = rows[:, 0]
    for j in range(1, top_k):
        y = y + rows[:, j]
    return y


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
    xt = spmd.constrain(x.reshape(T, D), ("batch", None))
    probs, topi, e_sorted, tok_sorted, w_sorted, pos_sorted = _route(
        xt, p["router"], top_k, n_real)
    cap = _capacity(T * top_k, n_real, capacity_factor, dropless)
    keep = pos_sorted < cap

    # pack: a kept row goes to slot e*cap + pos of a flat buffer, a dropped
    # one to the one spare row past the E*cap slots (the reference's
    # mode="drop" scatter), which the experts never read
    dt = x.dtype
    slot = torch.where(keep, e_sorted * cap + pos_sorted, E * cap)
    flat = torch.zeros((E * cap + 1, D), dtype=dt, device=x.device)
    flat[slot] = xt[tok_sorted]
    # pin the expert-parallel layout of the (E, cap, D) buffers
    buf = spmd.constrain(flat[:E * cap].view(E, cap, D),
                       ("expert", None, None))
    out_buf = spmd.constrain(_experts(buf, p["wi"], p["wg"], p["wo"]),
                           ("expert", None, None)).reshape(E * cap, D)

    gathered = out_buf[torch.where(keep, slot, 0)]
    gathered = gathered * (w_sorted * keep)[:, None].to(dt)
    y = spmd.constrain(_combine(gathered, tok_sorted, T, top_k),
                     ("batch", None))

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


def moe_apply_ep(x, p, *, top_k: int, mesh, batch_axes, ep_axis="model",
                 capacity_factor: float = 1.25, dropless: bool = False,
                 n_experts_real: int = 0):
    """Expert-parallel MoE dispatch over ``mesh`` (a ``DeviceMesh``), the
    reference's ``shard_map`` program as a ``local_map`` one.

    Rank (d, m) holds token shard d (``x`` sharded over ``batch_axes``,
    replicated over ``ep_axis``) and expert shard m (FSDP over ``data``).
    It routes its local tokens, packs only the experts of shard m (the
    capacity is per token shard, the drop order the reference's sorted
    one), all-gathers its expert weights over ``data`` (ZeRO-3), computes,
    combines a partial (T_local, D) in ascending-expert order, and one
    psum over ``ep_axis`` adds the routed and shared-expert partials.

    The reference's dispatch moves no token between ranks (tokens are
    replicated over the EP axis, its combine is one psum), so neither
    does this one: no all-to-all.  Its collectives are autograd-aware as
    ``shard_map``'s transposes are: the weight all-gather's backward is a
    reduce-scatter (``all_gather_tensor_autograd``), the psum's is the
    identity, and the replicated inputs (tokens over ``ep_axis``, the
    router over every axis) sum their gradients over the axes they are
    replicated on.  Arguments that are not DTensors are distributed first
    (every rank passes the same global values).  Requires the expert dim
    padded to a multiple of the EP axis (``n_experts_padded``).
    """
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import local_map

    B, S, D = x.shape
    E_pad = p["router"].shape[1]
    n_real = n_experts_real or E_pad
    names = mesh.mesh_dim_names
    ep = mesh.size(names.index(ep_axis))
    E_l = E_pad // ep
    fsdp_axis = "data" if "data" in names else None
    fsdp_group = mesh.get_group(fsdp_axis) if fsdp_axis else None
    ep_group = mesh.get_group(ep_axis)
    all_groups = [mesh.get_group(a) for a in names]
    has_shared = "shared" in p
    m = mesh.get_local_rank(ep_axis)

    gather_autograd = getattr(funcol, "all_gather_single_autograd",
                              None) or funcol.all_gather_tensor_autograd

    def gather(w, dim):
        if fsdp_group is None:
            return w
        return gather_autograd(w.contiguous(), dim, fsdp_group)

    def local_fn(x_l, router, wi, wg, wo, *shared_ws):
        Bl, Sl, _ = x_l.shape
        T = Bl * Sl
        dt = x_l.dtype
        xt = spmd.sum_grad(x_l.reshape(T, D), [ep_group])
        router = spmd.sum_grad(router, all_groups)
        _, _, e_sorted, tok_sorted, w_sorted, pos_sorted = _route(
            xt, router, top_k, n_real)
        cap = _capacity(T * top_k, n_real, capacity_factor, dropless)
        # pack ONLY this rank's expert shard; other rows go to the spare row
        e_local = e_sorted - m * E_l
        mine = (pos_sorted < cap) & (e_local >= 0) & (e_local < E_l)
        slot = torch.where(mine, e_local * cap + pos_sorted, E_l * cap)
        flat = torch.zeros((E_l * cap + 1, D), dtype=dt, device=x_l.device)
        flat[slot] = xt[tok_sorted]
        buf = flat[:E_l * cap].view(E_l, cap, D)
        out_buf = _experts(buf, gather(wi, 1), gather(wg, 1),
                           gather(wo, 2)).reshape(E_l * cap, D)
        gathered = out_buf[torch.where(mine, slot, 0)]
        gathered = gathered * (w_sorted * mine)[:, None].to(dt)
        y = _combine(gathered, tok_sorted, T, top_k)
        if has_shared:
            swi, swg, swo = shared_ws
            y = y + layers.swiglu(xt, {"wi": gather(swi, 0),
                                       "wg": gather(swg, 0),
                                       "wo": gather(swo, 1)})
        return spmd.psum(y, ep_group).reshape(Bl, Sl, D)

    def placements(dims=None):
        """Per mesh axis: ``Shard(dims[axis])`` or ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        dims = dims or {}
        return tuple(Shard(dims[a]) if dims.get(a) is not None
                     else Replicate() for a in names)

    x_pl = placements({a: 0 for a in batch_axes})
    in_pl = [x_pl, placements(),                            # x, router
             placements({ep_axis: 0, fsdp_axis: 1}),        # wi
             placements({ep_axis: 0, fsdp_axis: 1}),        # wg
             placements({ep_axis: 0, fsdp_axis: 2})]        # wo
    args = [x, p["router"], p["wi"], p["wg"], p["wo"]]
    if has_shared:
        in_pl += [placements({fsdp_axis: 0, ep_axis: 1}),
                  placements({fsdp_axis: 0, ep_axis: 1}),
                  placements({ep_axis: 0, fsdp_axis: 1})]
        args += [p["shared"]["wi"], p["shared"]["wg"], p["shared"]["wo"]]
    args = [a if isinstance(a, DTensor) else
            distribute_tensor(a, mesh, pl, src_data_rank=None)
            for a, pl in zip(args, in_pl)]
    fn = local_map(local_fn, out_placements=list(x_pl), in_placements=in_pl,
                   redistribute_inputs=True, device_mesh=mesh)
    return fn(*args)


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


def mamba2_specs():
    return {
        "in_proj": ("embed", "mlp"), "conv_w": (None, "mlp"),
        "conv_b": ("mlp",), "A_log": ("heads",), "D": ("heads",),
        "dt_bias": ("heads",), "norm": ("mlp",), "out_proj": ("mlp", "embed"),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv1d; x (B,S,C), w (K,C).  Returns (y, new_state).
    The K products are summed in order i = 0..K-1."""
    K = w.shape[0]
    # no state: K-1 zero rows in front (a pad keeps a DTensor's layout)
    xx = spmd.pad(x, (0, 0, K - 1, 0)) if state is None \
        else torch.cat([state, x], dim=1)
    S = x.shape[1]
    y = xx[:, 0:S] * w[0].to(x.dtype)
    for i in range(1, K):
        y = y + xx[:, i:i + S] * w[i].to(x.dtype)
    new_state = xx[:, xx.shape[1] - (K - 1):].contiguous()
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
    # the chunk products batch over (B, chunks, heads): on a mesh the
    # projection is gathered whole, so no merged batch dim is sharded
    # behind another
    zxbcdt = spmd.constrain(x @ p["in_proj"].to(dt_act),
                            ("batch", None, None))
    z, xBC, dt = _split_zxbcdt(zxbcdt, meta)
    conv_state = None if state is None else state["conv"]
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_state)
    xBC = F.silu(xBC)
    xs = spmd.even_split(xBC[..., :di], -1, nh).reshape(B, S, nh, pd)
    Bm = spmd.even_split(xBC[..., di:di + ng * ns], -1, ng).reshape(
        B, S, ng, ns)
    Cm = spmd.even_split(xBC[..., di + ng * ns:], -1, ng).reshape(
        B, S, ng, ns)
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
        xs = spmd.pad(xs, (0, 0, 0, 0, 0, pad))
        Bm = spmd.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = spmd.pad(Cm, (0, 0, 0, 0, 0, pad))
        dA = spmd.pad(dA, (0, 0, 0, pad))
        dt = spmd.pad(dt, (0, 0, 0, pad))

    def rs(a, *shape):
        return spmd.even_split(a, 1, nc).reshape(B, nc, chunk, *shape)

    xs_c = rs(xs, nh, pd).float()
    B_c = rs(Bm, nh, ns).float()
    C_c = rs(Cm, nh, ns).float()
    dA_c, dt_c = rs(dA, nh), rs(dt, nh)
    Acum = spmd.cumsum(dA_c, dim=2)                           # (B,nc,Q,nh)
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
    # whole on a mesh, as the projection: so is the gradient coming back
    y = spmd.constrain(y.reshape(B, S, di), ("batch", None, None))
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
    xs = spmd.even_split(xBC[..., :di], -1, nh).reshape(B, nh, pd).float()
    Bm = spmd.even_split(xBC[..., di:di + ng * ns], -1, ng).reshape(
        B, ng, ns).repeat_interleave(nh // ng, dim=1).float()
    Cm = spmd.even_split(xBC[..., di + ng * ns:], -1, ng).reshape(
        B, ng, ns).repeat_interleave(nh // ng, dim=1).float()
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


def rglru_specs():
    return {
        "in_x": ("embed", "mlp"), "in_gate": ("embed", "mlp"),
        "conv_w": (None, "mlp"), "conv_b": ("mlp",),
        "wa": ("mlp", "mlp2"), "wx": ("mlp", "mlp2"),
        "ba": ("mlp",), "bx": ("mlp",), "Lambda": ("mlp",),
        "out": ("mlp", "embed"),
    }


_C_RGLRU = 8.0


def _rglru_gates(xc, p):
    """The recurrence's (a, b), float32: gates in the activation dtype,
    ``log_a``, ``a`` and ``b`` in float32."""
    dt = xc.dtype
    col = spmd.COLUMN["mlp"]    # on a mesh, the gates by channel as ``xc``
    r = torch.sigmoid(spmd.product(torch.matmul, xc, p["wa"].to(dt), col)
                      + p["ba"].to(dt))
    i = torch.sigmoid(spmd.product(torch.matmul, xc, p["wx"].to(dt), col)
                      + p["bx"].to(dt))
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
    # on a mesh the block is channel-parallel over the ``mlp`` axes, as an
    # MLP: the input projections column-parallel, the conv, gates and scan
    # per channel, the output projection row-parallel
    col = spmd.COLUMN["mlp"]
    xw = spmd.product(torch.matmul, x, p["in_x"].to(dt), col)
    gate = F.gelu(spmd.product(torch.matmul, x, p["in_gate"].to(dt), col),
                  approximate="tanh")
    conv_state = None if state is None else state["conv"]
    xc, new_conv = _causal_conv(xw, p["conv_w"], p["conv_b"], conv_state)
    w = xc.shape[-1]
    h_in = (torch.zeros((B, w), dtype=torch.float32, device=x.device)
            if state is None else state["h"].float())

    Q = min(chunk, S)
    nc = -(-S // Q)
    xc_p = spmd.pad(xc, (0, 0, 0, nc * Q - S))
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
    out = spmd.product(torch.matmul, h * gate, p["out"].to(dt), spmd.ROW_MLP)
    if return_state:
        return out, {"conv": new_conv, "h": h_in}
    return out


def rglru_step(x1, p, state):
    return rglru_apply(x1, p, state=state, return_state=True)
