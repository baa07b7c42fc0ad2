"""The port's LM serving path (``repro_torch.models``, ``repro_torch.serve.lm``)
against the JAX reference's, on the reduced configs of every family:
dense, VLM, encoder-decoder, MoE (qwen2-moe, llama4-maverick), SSM
(mamba2) and hybrid (recurrentgemma).

The reference initialises the parameters; ``params_from_numpy`` carries
them over, and the same numpy tokens (and frontend embeddings) go through
both.  Tolerances, stated once:

  * float32 logits agree within ``F32_REL`` x max|logits| (the two sides
    sum in different orders, nothing else differs);
  * bfloat16 logits agree within ``BF16_REL`` x max|logits| (activations
    rounded to bf16 at every layer, on both sides, in different orders);
  * decode against the full forward: the reference's own 2e-2
    (``tests/test_archs_smoke.py``);
  * ``ServeEngine.generate``: identical tokens.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import base as ref_base
from repro.models.model_zoo import build_model as ref_build_model
from repro.serve.lm import Request as RefRequest
from repro.serve.lm import ServeEngine as RefServeEngine

from repro_torch.configs import base
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build_model
from repro_torch.serve import Request, ServeEngine

F32_REL = 1e-5
BF16_REL = 5e-2

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
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend:
        n = cfg.n_frontend_tokens or 8
        batch["frontend_embeds"] = (
            0.1 * rng.standard_normal((B, n, cfg.frontend_dim))
        ).astype(np.float32)
    return batch


def _as_ref(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _ref_graft(ref_model, B, cap_len, caches, dtype):
    cap = ref_model.init_cache(B, cap_len, dtype=dtype)
    return jax.tree.map(
        lambda c, g: g if c.shape == g.shape else jnp.pad(
            g, [(0, cs - gs) for cs, gs in zip(c.shape, g.shape)],
            constant_values=(-1 if g.dtype == jnp.int32 else 0)),
        cap, caches)


def _graft(model, B, cap_len, caches):
    cap = model.init_cache(B, cap_len)
    out = []
    for c, g in zip(cap, caches):
        out.append({})
        for name in c:
            pad = []
            for cs, gs in reversed(list(zip(c[name].shape, g[name].shape))):
                pad += [0, cs - gs]
            out[-1][name] = F.pad(g[name], pad, value=(
                0 if g[name].is_floating_point() else -1))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_reference(arch):
    """Prefill S tokens, then decode 2 (the decoder's own, after its
    prompt; the enc-dec decoder cross-attends to the encoder output)."""
    cfg, ref_model, ref_params, model, params = _setup(arch, seed=1)
    B, S, extra = 2, 12, 2
    batch = _batch(cfg, B, S + extra, seed=3)
    head = dict(batch, tokens=batch["tokens"][:, :S])
    want, ref_caches = ref_model.prefill(ref_params, _as_ref(head))
    got, caches = model.prefill(params, head)
    assert got.shape == (B, cfg.vocab)
    _close(got, want, F32_REL)

    enc_out = enc_pos = ref_enc_out = ref_enc_pos = None
    if cfg.enc_layers:
        _, fe = model._embed_inputs(params, head)
        enc_out, enc_pos = model._encode(params, fe)
        _, ref_fe = ref_model._embed_inputs(ref_params, _as_ref(head))
        ref_enc_out, ref_enc_pos = ref_model._encode(ref_params, ref_fe)
        _close(enc_out, ref_enc_out, F32_REL)
    S0 = S + (cfg.n_frontend_tokens if cfg.frontend and not cfg.enc_layers
              else 0)
    ref_caches = _ref_graft(ref_model, B, S0 + extra, ref_caches,
                            cfg.act_dtype)
    caches = _graft(model, B, S0 + extra, caches)
    for t in range(extra):
        tok = batch["tokens"][:, S + t:S + t + 1]
        pos = np.full((B,), S0 + t, np.int32)
        want, ref_caches = ref_model.decode_step(
            ref_params, jnp.asarray(tok), ref_caches, jnp.asarray(pos),
            enc_out=ref_enc_out, enc_positions=ref_enc_pos)
        got, caches = model.decode_step(params, tok, caches, pos,
                                        enc_out=enc_out,
                                        enc_positions=enc_pos)
        _close(got, want, F32_REL)


@pytest.mark.parametrize("arch", ["granite_3_2b", "internlm2_1_8b",
                                  "recurrentgemma_2b", "mamba2_130m",
                                  "qwen2_moe_a2_7b"])
def test_prefill_decode_matches_full_forward(arch):
    """``tests/test_archs_smoke.py::test_prefill_decode_matches_full_forward``
    on the port: [prefill(S); decode x2] equals the full forward's logits."""
    cfg = base.get(arch).reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    B, S, extra = 2, 16, 2
    tokens = _batch(cfg, B, S + extra, seed=3)["tokens"]
    full, _ = model.prefill(params, {"tokens": tokens})
    _, caches = model.prefill(params, {"tokens": tokens[:, :S]})
    caches = _graft(model, B, S + extra, caches)
    for t in range(extra):
        last, caches = model.decode_step(
            params, tokens[:, S + t:S + t + 1], caches,
            np.full((B,), S + t, np.int32))
    np.testing.assert_allclose(last.numpy(), full.numpy(),
                               rtol=2e-2, atol=2e-2)


def test_bf16_prefill_matches_reference():
    cfg, ref_model, ref_params, model, params = _setup(
        "granite_3_2b", seed=2, act_dtype="bfloat16")
    batch = _batch(cfg, 2, 20, seed=4)
    want, _ = ref_model.prefill(ref_params, _as_ref(batch))
    got, caches = model.prefill(params, batch)
    assert got.dtype == torch.bfloat16
    assert caches[0]["k"].dtype == torch.bfloat16
    _close(got, want, BF16_REL)


@pytest.mark.parametrize("arch", ["qwen2_moe_a2_7b", "mamba2_130m",
                                  "recurrentgemma_2b"])
def test_bf16_prefill_matches_reference_mixers(arch):
    """bf16 prefill logits within ``BF16_REL``; the conv states in bf16, the
    recurrent states in float32, as the reference keeps them."""
    cfg, ref_model, ref_params, model, params = _setup(
        arch, seed=2, act_dtype="bfloat16")
    batch = _batch(cfg, 2, 20, seed=4)
    want, ref_caches = ref_model.prefill(ref_params, _as_ref(batch))
    got, caches = model.prefill(params, batch)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_REL)
    for c in caches:
        for name, leaf in c.items():
            assert leaf.dtype == {"ssm": torch.float32, "h": torch.float32,
                                  "pos": torch.int32}.get(
                name, torch.bfloat16), name


def test_serve_engine_generates_reference_tokens():
    """``tests/test_train_substrate.py``'s two serving tests: the same
    requests give the reference engine's tokens exactly, and greedy decode
    agrees with re-running prefill on the grown prompt."""
    cfg, ref_model, ref_params, model, params = _setup("internlm2_1_8b", 0)
    reqs = [(np.arange(5) + 1, 8), (np.arange(9) + 3, 4)]
    want = RefServeEngine(ref_model, ref_params, batch_size=4,
                          cache_len=64).generate(
        [RefRequest(prompt=p, max_new_tokens=n) for p, n in reqs])
    eng = ServeEngine(model, params, batch_size=4, cache_len=64)
    got = eng.generate([Request(prompt=p, max_new_tokens=n) for p, n in reqs])
    assert [g.shape for g in got] == [(8,), (4,)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert eng.timing["decode_steps"] == 7 and eng.timing["prompt_len"] == 9

    cfg, ref_model, ref_params, model, params = _setup("internlm2_1_8b", 1)
    prompt = np.arange(6, dtype=np.int32) + 2
    want = RefServeEngine(ref_model, ref_params, batch_size=1,
                          cache_len=32).generate(
        [RefRequest(prompt=prompt, max_new_tokens=3)])[0]
    out = ServeEngine(model, params, batch_size=1, cache_len=32).generate(
        [Request(prompt=prompt, max_new_tokens=3)])[0]
    np.testing.assert_array_equal(out, np.asarray(want))
    seq = list(prompt)
    for _ in range(3):
        logits, _ = model.prefill(params, {"tokens": np.asarray([seq])})
        seq.append(int(torch.argmax(logits[0])))
    np.testing.assert_array_equal(out, np.asarray(seq[len(prompt):]))


def test_serve_engine_eos_and_batch_fill():
    cfg = base.get("granite_3_2b").reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(5))
    eng = ServeEngine(model, params, batch_size=3, cache_len=40)
    prompt = np.arange(7, dtype=np.int32) + 1
    free = eng.generate([Request(prompt=prompt, max_new_tokens=6)])[0]
    stop = eng.generate([Request(prompt=prompt, max_new_tokens=6,
                                 eos=int(free[2]))])[0]
    first = int(np.argmax(free == free[2]))
    np.testing.assert_array_equal(stop, free[:first + 1])
    with pytest.raises(ValueError):
        eng.generate([Request(prompt=prompt)] * 4)


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "qwen2_moe_a2_7b"])
def test_serve_engine_generates_reference_tokens_mixers(arch):
    """The engine's tokens equal the reference engine's on a recurrent and
    an MoE config (prompts of unequal length: the shorter is padded)."""
    cfg, ref_model, ref_params, model, params = _setup(arch, 0)
    reqs = [(np.arange(5) + 1, 8), (np.arange(19) + 3, 4)]
    want = RefServeEngine(ref_model, ref_params, batch_size=3,
                          cache_len=32).generate(
        [RefRequest(prompt=p, max_new_tokens=n) for p, n in reqs])
    got = ServeEngine(model, params, batch_size=3, cache_len=32).generate(
        [Request(prompt=p, max_new_tokens=n) for p, n in reqs])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("arch", ["recurrentgemma_2b", "mamba2_130m"])
def test_grow_caches_keeps_states_and_grows_the_local_ring(arch):
    """``_grow_caches`` passes conv/ssm/h states of equal shape through
    unchanged and pads a ``local`` ring (and full attention caches) to
    ``min(cache_len, window)`` rows, as the reference's ``merge`` does."""
    cfg, ref_model, ref_params, model, params = _setup(arch, 0)
    B, S, cache_len = 2, 6, 12
    tokens = _batch(cfg, B, S, seed=5)["tokens"]
    _, caches = model.prefill(params, {"tokens": tokens})
    grown = ServeEngine(model, params, B, cache_len)._grow_caches(caches, S)
    _, ref_caches = ref_model.prefill(ref_params,
                                      {"tokens": jnp.asarray(tokens)})
    want = RefServeEngine(ref_model, ref_params, B, cache_len)._grow_caches(
        ref_caches, S)
    sc, tail = want
    for i, kind in enumerate(cfg.pattern[j % len(cfg.pattern)]
                             for j in range(cfg.n_layers)):
        glen = len(cfg.pattern)
        g, j = divmod(i, glen)
        ref_c = (jax.tree.map(lambda a: a[g], sc[j]) if g < cfg.n_layers // glen
                 else tail[j])
        assert set(grown[i]) == set(ref_c)
        for name, leaf in grown[i].items():
            assert leaf.shape == tuple(ref_c[name].shape), (kind, name)
            if name in ("conv", "ssm", "h"):
                assert leaf is caches[i][name]
            np.testing.assert_allclose(leaf.float().numpy(),
                                       np.asarray(ref_c[name], np.float32),
                                       rtol=2e-5, atol=2e-5)
        if kind == "local":
            assert grown[i]["k"].shape[1] == min(cache_len, cfg.window)
            assert (grown[i]["pos"][:, S:] == -1).all()


def test_recurrentgemma_tail_blocks_carry_over():
    """26 = 8 x (rec, rec, local) + 2: at 8 = 2 x 3 + 2 layers the two tail
    ``rec`` blocks become layers 6 and 7 and the logits still match."""
    cfg, ref_model, ref_params, model, params = _setup(
        "recurrentgemma_2b", seed=4, n_layers=8)
    assert len(params["layers"]) == 8
    tail = ref_params["layers"]["tail"]
    assert len(tail) == 2
    for j in range(2):
        np.testing.assert_array_equal(
            params["layers"][6 + j]["rec"]["wa"].numpy(),
            np.asarray(tail[j]["rec"]["wa"]))
    batch = _batch(cfg, 2, 10, seed=6)
    want, _ = ref_model.prefill(ref_params, _as_ref(batch))
    got, caches = model.prefill(params, batch)
    _close(got, want, F32_REL)
    assert [sorted(c) for c in caches[5:]] == [["k", "pos", "v"],
                                              ["conv", "h"], ["conv", "h"]]


@pytest.mark.parametrize("arch", base.all_archs())
def test_every_registered_config_serves_reduced(arch):
    """Every registered config's reduced form builds on the CPU, prefills
    and takes a decode step, with finite logits of the vocabulary's width."""
    cfg = base.get(arch).reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(3))
    B, S = 2, 8
    batch = _batch(cfg, B, S, seed=7)
    logits, caches = model.prefill(params, batch)
    assert logits.shape == (B, cfg.vocab) and torch.isfinite(logits).all()
    enc_out = enc_pos = None
    if cfg.enc_layers:
        _, fe = model._embed_inputs(params, batch)
        enc_out, enc_pos = model._encode(params, fe)
    S0 = S + (cfg.n_frontend_tokens if cfg.frontend and not cfg.enc_layers
              else 0)
    caches = _graft(model, B, S0 + 1, caches)
    step, _ = model.decode_step(params, batch["tokens"][:, -1:], caches,
                                np.full((B,), S0, np.int32),
                                enc_out=enc_out, enc_positions=enc_pos)
    assert step.shape == (B, cfg.vocab) and torch.isfinite(step).all()


@pytest.mark.parametrize("entry", ["build_model", "block_init", "block_apply",
                                   "init_block_cache"])
def test_unknown_block_kind_raises(entry):
    cfg = base.get("granite_3_2b").reduced()
    with pytest.raises(ValueError, match="mlstm"):
        if entry == "build_model":
            build_model(dataclasses.replace(cfg, pattern=("attn", "mlstm")),
                        device="cpu")
        elif entry == "block_init":
            T.block_init(torch.Generator(), cfg, "mlstm")
        elif entry == "block_apply":
            T.block_apply(cfg, "mlstm", {}, torch.zeros(1, 1, cfg.d_model),
                          positions=torch.zeros(1, 1, dtype=torch.int32),
                          mode="prefill")
        else:
            T.init_block_cache(cfg, "mlstm", 1, 4)


def test_port_init_matches_converted_layout_and_is_seeded():
    """The port's own init has the converted tree's names and shapes, and
    one seed gives one set of weights."""
    for arch in ARCHS:
        cfg, _, _, model, converted = _setup(arch)
        a = model.init(torch.Generator().manual_seed(7)).state_dict()
        b = model.init(torch.Generator().manual_seed(7)).state_dict()
        assert {k: v.shape for k, v in a.items()} == {
            k: v.shape for k, v in converted.state_dict().items()}
        assert all(torch.equal(a[k], b[k]) for k in a)
    cfg = base.get("granite_3_2b").reduced()
    tree = jax.tree.map(np.asarray, ref_build_model(
        ref_base.get("granite_3_2b").reduced()).init(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="needs"):
        params_from_numpy(dataclasses.replace(cfg, tie_embeddings=False),
                          tree, device="cpu")


def test_entry_points_need_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = base.get("granite_3_2b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy(cfg, {}, device=None)
