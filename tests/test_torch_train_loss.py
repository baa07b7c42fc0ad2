"""The port's training loss (``Model.loss``, ``layers.chunked_cross_entropy``
and the remat policies of ``transformer.stack_apply``) against the JAX
reference's, on the reduced configs of every family.

The reference initialises the parameters; ``params_from_numpy`` carries
them (and its gradients) over, and the same numpy tokens, labels and
frontend embeddings go through both.  Tolerances, stated once:

  * the loss within ``LOSS_REL`` relative (the two sides sum in different
    orders, nothing else differs);
  * every gradient leaf within ``GRAD_REL`` x the largest |gradient| of
    the reference's whole tree.  A per-leaf scale would hold rounding
    noise to itself: llama4-maverick's router gradient is exactly 0 (with
    ``top_k=1`` the renormalised weight is always 1) and both sides read
    noise of about 5e-9 there;
  * remat ``"full"`` and ``"dots"`` give bitwise the loss and gradients of
    ``"none"`` (they recompute the same operations).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.models import layers as RL
from repro.models.model_zoo import build_model as ref_build_model

from repro_torch.configs import base
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build_model

LOSS_REL = 1e-5
GRAD_REL = 1e-5

ARCHS = ["granite_3_2b", "internlm2_1_8b", "internvl2_1b",
         "seamless_m4t_medium", "qwen2_moe_a2_7b", "mamba2_130m",
         "recurrentgemma_2b", "llama4_maverick_400b_a17b"]


def _setup(arch, seed=0, **overrides):
    """(config, reference model, reference params, port model, port params)."""
    ref_cfg = dataclasses.replace(ref_base.get(arch).reduced(), **overrides)
    cfg = dataclasses.replace(base.get(arch).reduced(), **overrides)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(seed))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, ref_params),
                               device="cpu")
    return cfg, ref_model, ref_params, build_model(cfg, device="cpu"), params


def _batch(cfg, B, S, seed):
    """Tokens, labels (two of them -100: no target) and, for a frontend
    config, frontend embeddings."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[0, 3] = labels[-1, S // 2] = -100
    batch = {"tokens": tokens, "labels": labels}
    if cfg.frontend:
        batch["frontend_embeds"] = (0.1 * rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.frontend_dim))).astype(np.float32)
    return batch


def _loss_and_grads(model, params, batch):
    named = L.named_leaves(params.requires_grad_(True))
    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss.detach(), dict(zip(named, grads))


def _ref_loss_and_grads(cfg, ref_model, ref_params, batch):
    loss, grads = jax.jit(jax.value_and_grad(ref_model.loss))(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    grads = L.named_leaves(params_from_numpy(
        cfg, jax.tree.map(np.asarray, grads), device="cpu"))
    return float(loss), grads


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    cfg, ref_model, ref_params, model, params = _setup(arch, seed=1)
    batch = _batch(cfg, 2, 16, seed=3)
    want_loss, want = _ref_loss_and_grads(cfg, ref_model, ref_params, batch)
    loss, got = _loss_and_grads(model, params, batch)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss) - want_loss) <= LOSS_REL * abs(want_loss)
    assert got.keys() == want.keys()
    scale = max(float(g.abs().max()) for g in want.values())
    assert scale > 0
    for name, g in got.items():
        err = float((g - want[name]).abs().max())
        assert err <= GRAD_REL * scale, (name, err, scale)


@pytest.mark.parametrize("pad", [True, False])
def test_chunked_cross_entropy_matches_reference(pad):
    """Value and gradients with respect to h and the table, at V=1000 (8
    chunks of 125, no padding) and V=1003 (8 chunks of 126, the last 5
    rows padding, masked)."""
    V = 1003 if pad else 1000
    rng = np.random.default_rng(5)
    B, S, D = 2, 7, 24
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    table = (0.3 * rng.standard_normal((V, D))).astype(np.float32)
    targets = rng.integers(0, V, (B, S)).astype(np.int32)
    targets[1, 2] = V - 1                     # the last chunk's last row
    valid = np.ones((B, S), bool)
    valid[0, 4] = False

    def ref_f(h, table):
        s, n = RL.chunked_cross_entropy(h, table, jnp.asarray(targets),
                                        jnp.asarray(valid))
        return s, n

    (want_s, want_n), ref_vjp = jax.vjp(ref_f, jnp.asarray(h),
                                        jnp.asarray(table))
    want_gh, want_gt = ref_vjp((jnp.float32(1.0), jnp.int32(0)))
    th = torch.tensor(h, requires_grad=True)
    tt = torch.tensor(table, requires_grad=True)
    s, n = L.chunked_cross_entropy(th, tt, torch.tensor(targets).long(),
                                   torch.tensor(valid))
    gh, gt = torch.autograd.grad(s, [th, tt])
    assert int(n) == int(want_n) == B * S - 1
    s = s.detach()
    assert abs(float(s) - float(want_s)) <= LOSS_REL * abs(float(want_s))
    for got, want in ((gh, want_gh), (gt, want_gt)):
        want = np.asarray(want)
        assert float(np.abs(got.numpy() - want).max()) <= \
            GRAD_REL * np.abs(want).max()


def test_big_vocab_branch_matches_reference():
    """A vocabulary of 65537 (>= CHUNKED_XENT_MIN_VOCAB, 8 chunks of 8193
    with 7 padded rows) takes the chunked path on both sides."""
    cfg, ref_model, ref_params, model, params = _setup(
        "granite_3_2b", seed=2, vocab=65537)
    assert cfg.vocab >= model.CHUNKED_XENT_MIN_VOCAB
    batch = _batch(cfg, 2, 12, seed=4)
    batch["tokens"][0, 0] = batch["labels"][1, 0] = cfg.vocab - 1
    want_loss, want = _ref_loss_and_grads(cfg, ref_model, ref_params, batch)
    loss, got = _loss_and_grads(model, params, batch)
    assert abs(float(loss) - want_loss) <= LOSS_REL * abs(want_loss)
    scale = max(float(g.abs().max()) for g in want.values())
    for name, g in got.items():
        assert float((g - want[name]).abs().max()) <= GRAD_REL * scale, name


def test_big_vocab_loss_never_holds_the_logits(monkeypatch):
    """The chunked path never calls the unembedding (which would hold the
    (B,S,V) logits)."""
    cfg = dataclasses.replace(base.get("granite_3_2b").reduced(),
                              vocab=65537)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))

    def refuse(*a, **k):
        raise AssertionError("unembed called on the chunked path")

    monkeypatch.setattr(L, "unembed", refuse)
    batch = _batch(cfg, 1, 8, seed=0)
    assert torch.isfinite(model.loss(params, batch))


@pytest.mark.parametrize("arch", ["granite_3_2b", "recurrentgemma_2b",
                                  "qwen2_moe_a2_7b", "seamless_m4t_medium"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_is_bitwise_no_remat(arch, remat):
    """Two pattern groups (and recurrentgemma's tail block) under each
    remat policy: loss and every gradient bitwise those of ``"none"``."""
    cfg = base.get(arch).reduced()
    n_layers = 2 * len(cfg.pattern) + (1 if len(cfg.pattern) > 1 else 0)
    out = {}
    for policy in ("none", remat):
        c = dataclasses.replace(cfg, remat=policy, n_layers=n_layers)
        model = build_model(c, device="cpu")
        params = model.init(torch.Generator().manual_seed(7))
        out[policy] = _loss_and_grads(model, params, _batch(c, 2, 16, 1))
    (l0, g0), (l1, g1) = out["none"], out[remat]
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def test_remat_recomputes_in_backward():
    """``"full"`` really recomputes: the forward of a group runs again in
    the backward pass, and ``"none"`` runs it once."""
    from repro_torch.models import transformer as T

    calls = {"n": 0}
    orig = T.block_apply

    def counting(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    cfg = base.get("granite_3_2b").reduced()
    counts = {}
    for policy in ("none", "full"):
        c = dataclasses.replace(cfg, remat=policy)
        model = build_model(c, device="cpu")
        params = model.init(torch.Generator().manual_seed(0))
        calls["n"] = 0
        T.block_apply = counting
        try:
            _loss_and_grads(model, params, _batch(c, 1, 8, 0))
        finally:
            T.block_apply = orig
        counts[policy] = calls["n"]
    assert counts == {"none": cfg.n_layers, "full": 2 * cfg.n_layers}
