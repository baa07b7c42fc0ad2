"""The port's mixers (``repro_torch.models.mixers``: MoE, Mamba-2 SSD,
RG-LRU) against ``repro.models.mixers`` on the same numpy inputs and
parameters, at reduced widths.

Tolerances, stated once (absolute and relative):

  * ``F32``: float32 results; the two sides sum in different orders (the
    SSD contractions, the scans' trees), nothing else differs (the
    bound of ``tests/test_torch_lm_layers.py``);
  * ``BF16``: bfloat16 results, rounded to bf16 at every op on both sides
    in different orders: a few bf16 units in the last place at the O(1)
    magnitudes used here.

Routing seeds: every MoE input here has no tie at the top-k boundary of
its router probabilities (checked), since ``torch.topk`` and
``lax.top_k`` may order ties differently.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mixers as ref

from repro_torch.models import mixers as M

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"float32": (jnp.float32, torch.float32, F32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}


def _pair(a, dtype="float32"):
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.tensor(a).to(tdt)


def _check(got, want, dtype="float32"):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **DTYPES[dtype][2])


def _trees(params):
    """A nested numpy parameter dict as the reference's and as the port's."""
    if isinstance(params, dict):
        pairs = {k: _trees(v) for k, v in params.items()}
        return ({k: v[0] for k, v in pairs.items()},
                {k: v[1] for k, v in pairs.items()})
    return jnp.asarray(params), torch.tensor(params)


def _normal(rng, shape, scale):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------


def _moe_params(rng, d, f, E, shared=0):
    p = {"router": _normal(rng, (d, E), 1.0),
         "wi": _normal(rng, (E, d, f), d ** -0.5),
         "wg": _normal(rng, (E, d, f), d ** -0.5),
         "wo": _normal(rng, (E, f, d), f ** -0.5)}
    if shared:
        p["shared"] = {"wi": _normal(rng, (d, shared), d ** -0.5),
                       "wg": _normal(rng, (d, shared), d ** -0.5),
                       "wo": _normal(rng, (shared, d), shared ** -0.5)}
    return p


def _assert_no_topk_tie(x, router, k, n_real):
    logits = x.reshape(-1, x.shape[-1]).astype(np.float64) @ router
    logits[:, n_real:] = -np.inf
    top = -np.sort(-logits, axis=-1)[:, :k + 1]
    assert np.min(np.abs(np.diff(top, axis=-1))) > 1e-3


MOE_CASES = {  # name: (E stored, real experts, top_k, capacity_factor, dropless, shared)
    "capacity_drops": (8, 8, 2, 0.5, False, 0),
    "dropless": (8, 8, 2, 0.5, True, 0),
    "padding_experts": (8, 6, 2, 1.25, False, 24),
    "top1_shared": (4, 4, 1, 1.0, False, 24),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply(case, dtype):
    E, n_real, k, cf, dropless, shared = MOE_CASES[case]
    rng = np.random.default_rng(10)
    d, f = 16, 32
    p = _moe_params(rng, d, f, E, shared)
    x = _normal(rng, (2, 9, d), 1.0)
    xj, xt = _pair(x, dtype)
    _assert_no_topk_tie(np.asarray(xt.float()), p["router"], k, n_real)
    pj, pt = _trees(p)
    kw = dict(top_k=k, capacity_factor=cf, dropless=dropless,
              n_experts_real=0 if n_real == E else n_real, return_aux=True)
    want, want_aux = ref.moe_apply(xj, pj, **kw)
    got, aux = M.moe_apply(xt, pt, **kw)
    assert got.dtype == DTYPES[dtype][1] and got.shape == x.shape
    _check(got, want, dtype)
    np.testing.assert_allclose(float(aux["load_balance"]),
                               float(want_aux["load_balance"]), rtol=1e-5)
    n_routed = x.shape[0] * x.shape[1] * k      # the same rows dropped
    dropped = round(float(aux["dropped_frac"]) * n_routed)
    assert dropped == round(float(want_aux["dropped_frac"]) * n_routed)
    if case in ("capacity_drops", "padding_experts"):
        assert dropped > 0
    if dropless:
        assert float(aux["dropped_frac"]) == 0
    without = M.moe_apply(xt, pt, **dict(kw, return_aux=False))
    assert torch.equal(without, got)


def test_moe_padding_experts_receive_nothing():
    """A padding expert's weights never reach the output."""
    rng = np.random.default_rng(11)
    p = _moe_params(rng, 16, 32, 8)
    x = torch.tensor(_normal(rng, (2, 9, 16), 1.0))
    pt = _trees(p)[1]
    got = M.moe_apply(x, pt, top_k=2, dropless=True, n_experts_real=6)
    for name in ("wi", "wg", "wo"):
        pt[name][6:] = float("nan")
    assert torch.equal(M.moe_apply(x, pt, top_k=2, dropless=True,
                                   n_experts_real=6), got)


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


def test_moe_init_layout():
    kw = dict(n_shared=1, d_ff_shared=24, n_experts_padded=8)
    p = M.moe_init(torch.Generator().manual_seed(0), 16, 6, 32, 2, **kw)
    want = jax.eval_shape(
        lambda: ref.moe_init(jax.random.PRNGKey(0), 16, 6, 32, 2, **kw)[0])
    assert _shapes(p) == _shapes(want)


# --------------------------------------------------------------------------
# causal conv
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(dtype, with_state):
    rng = np.random.default_rng(12)
    x = _normal(rng, (2, 7, 12), 1.0)
    w = _normal(rng, (4, 12), 0.5)
    b = _normal(rng, (12,), 0.1)
    st = _normal(rng, (2, 3, 12), 1.0)
    xj, xt = _pair(x, dtype)
    sj, stt = _pair(st, dtype) if with_state else (None, None)
    want, want_state = ref._causal_conv(xj, jnp.asarray(w), jnp.asarray(b),
                                        sj)
    got, state = M._causal_conv(xt, torch.tensor(w), torch.tensor(b), stt)
    assert got.dtype == DTYPES[dtype][1] and state.dtype == got.dtype
    _check(got, want, dtype)
    _check(state, want_state, dtype)


def test_split_zxbcdt():
    meta = dict(d_inner=8, n_groups=1, d_state=4, n_heads=2)
    a = np.arange(2 * 3 * 26, dtype=np.float32).reshape(2, 3, 26)
    for g, w in zip(M._split_zxbcdt(torch.tensor(a), meta),
                    ref._split_zxbcdt(jnp.asarray(a), meta)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------------------------------------
# Mamba-2 SSD
# --------------------------------------------------------------------------

SSM = dict(d_model=16, d_state=8, headdim=8, expand=2)


def _mamba_setup(seed):
    rng = np.random.default_rng(seed)
    d, ns, pd = SSM["d_model"], SSM["d_state"], SSM["headdim"]
    di = SSM["expand"] * d
    nh = di // pd
    conv_dim = di + 2 * ns
    p = {"in_proj": _normal(rng, (d, 2 * di + 2 * ns + nh), d ** -0.5),
         "conv_w": _normal(rng, (4, conv_dim), 0.5),
         "conv_b": _normal(rng, (conv_dim,), 0.1),
         "A_log": np.log(np.linspace(1.0, 16.0, nh)).astype(np.float32),
         "D": (1.0 + _normal(rng, (nh,), 0.1)),
         "dt_bias": _normal(rng, (nh,), 0.5),
         "norm": (1.0 + _normal(rng, (di,), 0.1)),
         "out_proj": _normal(rng, (di, d), di ** -0.5)}
    meta = dict(d_inner=di, n_heads=nh, headdim=pd, d_state=ns, d_conv=4,
                n_groups=1)
    state = {"conv": _normal(rng, (2, 3, conv_dim), 1.0),
             "ssm": _normal(rng, (2, nh, pd, ns), 0.5)}
    return rng, p, meta, state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_apply(dtype, with_state):
    """S = 13 over chunks of 4: three full chunks and a padded one."""
    rng, p, meta, state = _mamba_setup(13)
    x = _normal(rng, (2, 13, SSM["d_model"]), 1.0)
    xj, xt = _pair(x, dtype)
    pj, pt = _trees(p)
    sj = st = None
    if with_state:
        sj = {"conv": _pair(state["conv"], dtype)[0],
              "ssm": jnp.asarray(state["ssm"])}
        st = {"conv": _pair(state["conv"], dtype)[1],
              "ssm": torch.tensor(state["ssm"])}
    want, want_state = ref.mamba2_apply(xj, pj, meta, chunk=4, state=sj,
                                        return_state=True)
    got, got_state = M.mamba2_apply(xt, pt, meta, chunk=4, state=st,
                                    return_state=True)
    assert got.dtype == DTYPES[dtype][1]
    assert got_state["ssm"].dtype == torch.float32
    assert got_state["conv"].dtype == DTYPES[dtype][1]
    _check(got, want, dtype)
    _check(got_state["conv"], want_state["conv"], dtype)
    _check(got_state["ssm"], want_state["ssm"], dtype)
    assert torch.equal(M.mamba2_apply(xt, pt, meta, chunk=4, state=st), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_step_matches_apply_token_by_token(dtype):
    """Decode steps from a given state equal the reference's steps, and in
    float32 the chunked forward over the same tokens."""
    rng, p, meta, state = _mamba_setup(14)
    x = _normal(rng, (2, 6, SSM["d_model"]), 1.0)
    xj, xt = _pair(x, dtype)
    pj, pt = _trees(p)
    sj = {"conv": _pair(state["conv"], dtype)[0],
          "ssm": jnp.asarray(state["ssm"])}
    st = {"conv": _pair(state["conv"], dtype)[1],
          "ssm": torch.tensor(state["ssm"])}
    full, full_state = M.mamba2_apply(xt, pt, meta, chunk=4, state=dict(st),
                                      return_state=True)
    outs = []
    for t in range(x.shape[1]):
        want, sj = ref.mamba2_step(xj[:, t:t + 1], pj, meta, sj)
        got, st = M.mamba2_step(xt[:, t:t + 1], pt, meta, st)
        assert st["ssm"].dtype == torch.float32
        _check(got, want, dtype)
        _check(st["ssm"], sj["ssm"], dtype)
        outs.append(got)
    if dtype == "float32":
        _check(torch.cat(outs, 1), full.numpy())
        _check(st["ssm"], full_state["ssm"].numpy())


# --------------------------------------------------------------------------
# RG-LRU
# --------------------------------------------------------------------------


def _rglru_setup(seed, d=16, w=24):
    rng = np.random.default_rng(seed)
    lam = rng.uniform(0.38, 0.65, w)
    p = {"in_x": _normal(rng, (d, w), d ** -0.5),
         "in_gate": _normal(rng, (d, w), d ** -0.5),
         "conv_w": _normal(rng, (4, w), 0.5),
         "conv_b": _normal(rng, (w,), 0.1),
         "wa": _normal(rng, (w, w), 0.1 * w ** -0.5),
         "wx": _normal(rng, (w, w), 0.1 * w ** -0.5),
         "ba": _normal(rng, (w,), 0.1),
         "bx": _normal(rng, (w,), 0.1),
         "Lambda": np.log(np.exp(-np.log(lam) * 0.125) - 1.0).astype(
             np.float32),
         "out": _normal(rng, (w, d), w ** -0.5)}
    state = {"conv": _normal(rng, (2, 3, w), 1.0),
             "h": _normal(rng, (2, w), 0.5)}
    return rng, p, state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_apply_across_chunks(dtype, with_state):
    """S = 11 over chunks of 4 (the last one padded), from a given state."""
    rng, p, state = _rglru_setup(15)
    x = _normal(rng, (2, 11, 16), 1.0)
    xj, xt = _pair(x, dtype)
    pj, pt = _trees(p)
    sj = st = None
    if with_state:
        sj = {"conv": _pair(state["conv"], dtype)[0],
              "h": jnp.asarray(state["h"])}
        st = {"conv": _pair(state["conv"], dtype)[1],
              "h": torch.tensor(state["h"])}
    want, want_state = ref.rglru_apply(xj, pj, state=sj, return_state=True,
                                       chunk=4)
    got, got_state = M.rglru_apply(xt, pt, state=st, return_state=True,
                                   chunk=4)
    assert got.dtype == DTYPES[dtype][1]
    assert got_state["h"].dtype == torch.float32
    _check(got, want, dtype)
    _check(got_state["h"], want_state["h"], dtype)
    _check(got_state["conv"], want_state["conv"], dtype)
    one, _ = M.rglru_apply(xt, pt, state=st, return_state=True, chunk=16)
    _check(one, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_step_matches_reference(dtype):
    rng, p, state = _rglru_setup(16)
    x = _normal(rng, (2, 5, 16), 1.0)
    xj, xt = _pair(x, dtype)
    pj, pt = _trees(p)
    sj = {"conv": _pair(state["conv"], dtype)[0], "h": jnp.asarray(state["h"])}
    st = {"conv": _pair(state["conv"], dtype)[1], "h": torch.tensor(state["h"])}
    full = M.rglru_apply(xt, pt, state=dict(st), chunk=2)
    outs = []
    for t in range(x.shape[1]):
        want, sj = ref.rglru_step(xj[:, t:t + 1], pj, sj)
        got, st = M.rglru_step(xt[:, t:t + 1], pt, st)
        _check(got, want, dtype)
        _check(st["h"], sj["h"], dtype)
        outs.append(got)
    if dtype == "float32":
        _check(torch.cat(outs, 1), full.numpy())


def test_linear_scan_is_the_recurrence():
    """The doubling scan equals h_t = a_t h_{t-1} + b_t step by step, over a
    length that is not a power of two, where products underflow."""
    rng = np.random.default_rng(17)
    a = torch.tensor(rng.uniform(0.3, 0.7, (2, 200, 5)).astype(np.float32))
    b = torch.tensor(_normal(rng, (2, 200, 5), 1.0))
    h0 = torch.tensor(_normal(rng, (2, 5), 1.0))
    A, H = M._linear_scan(a, b)
    h, want = h0, []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got = A * h0[:, None] + H
    np.testing.assert_allclose(got.numpy(), torch.stack(want, 1).numpy(),
                               **F32)
    assert float(A[:, -1].abs().max()) == 0.0   # 0.7**199 underflows


def test_init_layouts_match_reference():
    gen = torch.Generator().manual_seed(0)
    want, _, want_meta = ref.mamba2_init(jax.random.PRNGKey(0), 16,
                                         d_state=8, headdim=8)
    got, meta = M.mamba2_init(gen, 16, d_state=8, headdim=8)
    assert meta == want_meta
    assert _shapes(got) == _shapes(want)
    for name in ("A_log", "D", "dt_bias", "norm", "conv_b"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-6, atol=1e-7)
    want = jax.eval_shape(
        lambda: ref.rglru_init(jax.random.PRNGKey(0), 16, lru_width=24)[0])
    got = M.rglru_init(gen, 16, lru_width=24)
    assert _shapes(got) == _shapes(want)
    a = torch.exp(-8.0 * torch.nn.functional.softplus(got["Lambda"]))
    assert 0.38 <= float(a.min()) and float(a.max()) <= 0.65
