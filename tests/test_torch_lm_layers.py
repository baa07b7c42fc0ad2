"""The port's LM layers (``repro_torch.models.layers``) against
``repro.models.layers`` on the same numpy inputs.

Tolerances, stated once: float32 results agree within ``F32`` (absolute
and relative; the two sides sum in different orders, nothing else
differs), bfloat16 results within ``BF16`` (a few bf16 units in the last
place at the O(1) magnitudes used here).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as ref

from repro_torch.models import layers as L

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
DTYPES = {"float32": (jnp.float32, torch.float32, F32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16)}


def _rng(seed):
    return np.random.default_rng(seed)


def _pair(a, dtype="float32"):
    jdt, tdt, _ = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.tensor(a).to(tdt)


def _check(got, want, dtype="float32"):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **DTYPES[dtype][2])


def _tree(params):
    """A numpy parameter dict as the reference's and as the port's."""
    return ({k: jnp.asarray(v) for k, v in params.items()},
            {k: torch.tensor(v) for k, v in params.items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms(dtype):
    rng = _rng(0)
    x = (3.0 * rng.standard_normal((2, 5, 16))).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    xj, xt = _pair(x, dtype)
    got = L.rmsnorm(xt, torch.tensor(scale))
    assert got.dtype == DTYPES[dtype][1]
    _check(got, ref.rmsnorm(xj, jnp.asarray(scale)), dtype)
    pj, pt = _tree({"scale": scale, "bias": bias})
    _check(L.layernorm(xt, pt), ref.layernorm(xj, pj), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [10000.0, 500.0])
def test_rope(dtype, theta):
    rng = _rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(7) + 1000]).astype(np.int32)
    xj, xt = _pair(x, dtype)
    got = L.rope(xt, torch.tensor(pos), theta)
    _check(got, ref.rope(xj, jnp.asarray(pos), theta), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", ["swiglu", "geglu"])
def test_mlps(dtype, fn):
    rng = _rng(2)
    d, f = 16, 48
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    p = {"wi": rng.standard_normal((d, f)).astype(np.float32) / 4,
         "wg": rng.standard_normal((d, f)).astype(np.float32) / 4,
         "wo": rng.standard_normal((f, d)).astype(np.float32) / 7}
    pj, pt = _tree(p)
    xj, xt = _pair(x, dtype)
    _check(getattr(L, fn)(xt, pt), getattr(ref, fn)(xj, pj), dtype)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("use_rope", [False, True])
def test_project_qkv_and_attn_out(bias, use_rope):
    rng = _rng(3)
    d, H, Hkv, D = 24, 4, 2, 8
    p = {"wq": rng.standard_normal((d, H, D)), "wk": rng.standard_normal((d, Hkv, D)),
         "wv": rng.standard_normal((d, Hkv, D)), "wo": rng.standard_normal((H, D, d))}
    if bias:
        p.update(bq=rng.standard_normal((H, D)), bk=rng.standard_normal((Hkv, D)),
                 bv=rng.standard_normal((Hkv, D)))
    pj, pt = _tree({k: (v / 5).astype(np.float32) for k, v in p.items()})
    x = rng.standard_normal((2, 6, d)).astype(np.float32)
    pos = np.tile(np.arange(6, dtype=np.int32), (2, 1))
    want = ref._project_qkv(jnp.asarray(x), pj, jnp.asarray(pos), 10000.0,
                            use_rope=use_rope)
    got = L._project_qkv(torch.tensor(x), pt, torch.tensor(pos), 10000.0,
                         use_rope=use_rope)
    for g, w in zip(got, want):
        _check(g, w)
    _check(L.attn_out(got[0], pt), ref.attn_out(want[0], pj))
    _check(L._repeat_kv(got[1], H), ref._repeat_kv(want[1], H))


def _qkv(seed, B, Sq, Skv, H, Hkv, D, dtype="float32"):
    rng = _rng(seed)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    return [_pair(a, dtype) for a in (q, k, v)]


# (B, Sq, Skv, H, Hkv, D, kv_block, causal, window)
CHUNKED = {
    "skv_not_multiple": (2, 11, 11, 4, 4, 8, 4, True, 0),
    "gqa": (2, 13, 13, 6, 2, 8, 8, True, 0),
    "mqa_one_block": (1, 9, 9, 4, 1, 16, 32, True, 0),
    "window": (2, 21, 21, 4, 2, 8, 8, True, 5),
    "bidirectional": (2, 10, 10, 4, 2, 8, 4, False, 0),
    "cross_lengths": (2, 7, 12, 4, 2, 8, 5, False, 0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CHUNKED))
def test_attention_chunked(case, dtype):
    B, Sq, Skv, H, Hkv, D, kvb, causal, window = CHUNKED[case]
    (qj, qt), (kj, kt), (vj, vt) = _qkv(4, B, Sq, Skv, H, Hkv, D, dtype)
    want = ref.attention_chunked(qj, kj, vj, causal=causal, kv_block=kvb,
                                 window=window)
    got = L.attention_chunked(qt, kt, vt, causal=causal, kv_block=kvb,
                              window=window)
    assert got.dtype == qt.dtype and got.shape == (B, Sq, H, D)
    _check(got, want, dtype)


def test_attention_chunked_explicit_positions():
    """Prefill-style offsets and masked (negative) key positions."""
    B, S, H, Hkv, D = 2, 10, 4, 2, 8
    (qj, qt), (kj, kt), (vj, vt) = _qkv(5, B, S, S, H, Hkv, D)
    qpos = np.stack([np.arange(S) + 3, np.arange(S)]).astype(np.int32)
    kpos = qpos.copy()
    kpos[1, :4] = -1
    want = ref.attention_chunked(qj, kj, vj, kv_block=4, window=6,
                                 q_positions=jnp.asarray(qpos),
                                 kv_positions=jnp.asarray(kpos))
    got = L.attention_chunked(qt, kt, vt, kv_block=4, window=6,
                              q_positions=torch.tensor(qpos),
                              kv_positions=torch.tensor(kpos))
    _check(got, want)


@pytest.mark.parametrize("S,W,Hkv", [(40, 8, 2), (37, 8, 1), (24, 24, 2)])
def test_local_attention_banded(S, W, Hkv):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(6, 2, S, S, 4, Hkv, 8)
    want = ref.local_attention_banded(qj, kj, vj, window=W)
    got = L.local_attention_banded(qt, kt, vt, window=W)
    _check(got, want)
    # and the port's banded form agrees with its own masked full attention
    full = L.attention_chunked(qt, kt, vt, kv_block=16, window=W)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention_after_ring_wrap(dtype, window):
    """A ring of 8 slots after 13 and 5 decode writes: slot ``p % 8`` holds
    position p, the oldest positions are overwritten, unwritten slots are
    -1, and the cache is in ``dtype`` while q is float32."""
    B, Lc, H, Hkv, D = 2, 8, 6, 2, 8
    rng = _rng(7)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    kc = rng.standard_normal((B, Lc, Hkv, D)).astype(np.float32)
    vc = rng.standard_normal((B, Lc, Hkv, D)).astype(np.float32)
    pos = np.full((B, Lc), -1, np.int32)
    for b, n in enumerate((13, 5)):
        for p in range(n):
            pos[b, p % Lc] = p
    qpos = np.array([12, 4], np.int32)
    jdt, tdt, _ = DTYPES[dtype]
    want = ref.decode_attention(jnp.asarray(q), jnp.asarray(kc, jdt),
                                jnp.asarray(vc, jdt), jnp.asarray(pos),
                                jnp.asarray(qpos), window=window)
    got = L.decode_attention(torch.tensor(q), torch.tensor(kc).to(tdt),
                             torch.tensor(vc).to(tdt), torch.tensor(pos),
                             torch.tensor(qpos), window=window)
    assert got.dtype == torch.float32
    _check(got, want, dtype)


def test_embed_unembed_and_init_scales():
    rng = _rng(8)
    V, d = 50, 16
    table = rng.standard_normal((V, d)).astype(np.float32)
    tok = rng.integers(0, V, (2, 7))
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    for dtype in ("float32", "bfloat16"):
        jdt, tdt, _ = DTYPES[dtype]
        _check(L.embed(torch.tensor(tok), torch.tensor(table), tdt),
               ref.embed(jnp.asarray(tok), jnp.asarray(table), jdt), dtype)
        xj, xt = _pair(x, dtype)
        _check(L.unembed(xt, torch.tensor(table)),
               ref.unembed(xj, jnp.asarray(table)), dtype)
    # the reference's init shapes, layouts and fan-ins (embedding: the
    # vocabulary, in_axis=0); values come from torch's generator
    g = torch.Generator().manual_seed(0)
    emb, logical = L.embedding_init(g, 4096, 8)
    assert emb.shape == (4096, 8) and logical == ("vocab", "embed")
    assert abs(emb.std().item() * 64 - 1) < 0.05
    wo = L._init_dense(g, (16, 32, 64), in_axis=(0, 1))
    assert abs(wo.std().item() * np.sqrt(16 * 32) - 1) < 0.05
    w, logical = L.dense_init(g, (256, 128), ("embed", "mlp"))
    assert logical == ("embed", "mlp")
    assert abs(w.std().item() * 16 - 1) < 0.05
    import jax
    ref_attn, _ = ref.attention_init(jax.random.PRNGKey(0), 24, 4, 2, 8,
                                     qkv_bias=True)
    attn = L.attention_init(g, 24, 4, 2, 8, qkv_bias=True)
    assert {k: v.shape for k, v in attn.items()} == {
        k: tuple(v.shape) for k, v in ref_attn.items()}
    ref_mlp, _ = ref.swiglu_init(jax.random.PRNGKey(0), 24, 40)
    assert {k: v.shape for k, v in L.swiglu_init(g, 24, 40).items()} == {
        k: tuple(v.shape) for k, v in ref_mlp.items()}
