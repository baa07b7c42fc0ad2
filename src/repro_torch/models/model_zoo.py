"""Model wrapper, PyTorch port of ``repro.models.model_zoo``: init, loss,
prefill and decode over any :class:`~repro_torch.configs.base.ArchConfig`
(the dense, VLM, encoder-decoder, MoE, SSM and hybrid families).

A ``Model`` bundles the stack with the embeddings, the modality-frontend
stub (precomputed frontend embeddings and a projection, as in the
reference), the LM head and the train and serve entry points.  As in the
reference it holds no weights: :meth:`Model.init` returns the parameter
tree, a :class:`~repro_torch.models.layers.ParamTree` on the model's
device, and every entry point takes it.  :meth:`Model.loss` is the
reference's: the mean next-token cross-entropy, through
:func:`~repro_torch.models.layers.chunked_cross_entropy` for a vocabulary
of at least ``CHUNKED_XENT_MIN_VOCAB``; like the reference it adds no
MoE auxiliary loss.  :meth:`Model.param_specs` is the tree of logical
axes the sharding plan maps onto a mesh (``repro_torch.launch``), and the
entry points pin their activations with ``spmd.constrain`` at the
reference's cut points (the identity without a mesh).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.kernels.ops import _indexed, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import spmd
from repro_torch.models import transformer as T


def act_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``act_dtype`` name."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


@dataclasses.dataclass
class Model:
    cfg: Any
    device: torch.device

    # ---------------- parameter init ----------------
    def init(self, generator: torch.Generator) -> L.ParamTree:
        """Random fp32 masters drawn from ``generator``, on its device
        (which must be the model's)."""
        if _indexed(generator.device) != _indexed(self.device):
            raise ValueError(
                f"generator on {generator.device}, model on {self.device}")
        cfg = self.cfg
        params: dict = {}
        params["embed"] = L.embedding_init(generator, cfg.vocab, cfg.d_model)
        params["embed"] = params["embed"][0]
        params["layers"] = T._stack_init(generator, cfg, cfg.pattern,
                                         cfg.n_layers)
        params["ln_f"] = L.rmsnorm_init(cfg.d_model, self.device)
        if not cfg.tie_embeddings:
            params["unembed"] = L._init_dense(
                generator, (cfg.vocab, cfg.d_model), in_axis=1)
        if cfg.enc_layers:
            params["encoder"] = T._stack_init(generator, cfg, cfg.enc_pattern,
                                              cfg.enc_layers)
            params["ln_enc"] = L.rmsnorm_init(cfg.d_model, self.device)
        if cfg.frontend:
            params["frontend_proj"] = L._init_dense(
                generator, (cfg.frontend_dim, cfg.d_model))
        return L.ParamTree(params)

    # ---------------- logical sharding specs ----------------
    def param_specs(self) -> dict:
        """The logical axes of every leaf of :meth:`init`'s tree: the
        reference's, with the stack a flat list of blocks (its scanned
        specs without the leading ``"layers"`` axis)."""
        cfg = self.cfg
        specs: dict = {"embed": L.EMBEDDING_SPEC, "ln_f": L.RMSNORM_SPEC}
        specs["layers"] = T._stack_specs(cfg, cfg.pattern, cfg.n_layers)
        if not cfg.tie_embeddings:
            specs["unembed"] = ("vocab", "embed")
        if cfg.enc_layers:
            specs["encoder"] = T._stack_specs(cfg, cfg.enc_pattern,
                                              cfg.enc_layers)
            specs["ln_enc"] = L.RMSNORM_SPEC
        if cfg.frontend:
            specs["frontend_proj"] = (None, "embed")
        return specs

    def _tensor(self, a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    @staticmethod
    def _embed(tokens, table, dtype):
        """The token rows of ``table``; on a mesh, per rank from the whole
        table (ZeRO-3's gather), its gradient summed over the batch axes."""
        return spmd.per_rank(lambda t, w: L.embed(t, w, dtype),
                             (tokens, table), (("batch", None), (None, None)),
                             ("batch", None, None), sum_grad_over={1: "batch"})

    def _positions(self, B, S):
        """0..S-1 for each of B rows; on a mesh, laid out like the batch."""
        return spmd.replicated(L._positions(B, S, self.device),
                               ("batch", None))

    # ---------------- embedding assembly ----------------
    def _embed_inputs(self, params, batch):
        cfg = self.cfg
        dt = act_dtype(cfg.act_dtype)
        x = self._embed(self._tensor(batch["tokens"], torch.long),
                        params["embed"], dt)
        if cfg.frontend and "frontend_embeds" in batch:
            fe = self._tensor(batch["frontend_embeds"]).to(dt)
            fe = torch.einsum("bnd,de->bne", fe,
                              params["frontend_proj"].to(dt))
            # on a mesh, a layout the product's backward can merge
            fe = spmd.constrain(fe, ("batch", None, None))
            if cfg.enc_layers:
                return x, fe            # enc-dec: frontend feeds the encoder
            x = torch.cat([fe, x], dim=1)  # VLM early fusion
        return x, None

    def _encode(self, params, enc_in):
        cfg = self.cfg
        pos = self._positions(enc_in.shape[0], enc_in.shape[1])
        h, _ = T.stack_apply(cfg, cfg.enc_pattern, params["encoder"], enc_in,
                             positions=pos, mode="train")
        return L.rmsnorm(h, params["ln_enc"]), pos

    def _trunk(self, params, x, positions, mode, caches=None,
               enc_out=None, enc_positions=None):
        h, new_caches = self._hidden(params, x, positions, enc_out,
                                     enc_positions, mode=mode, caches=caches)
        cfg = self.cfg
        table = spmd.grad_as_param(
            params["embed"] if cfg.tie_embeddings else params["unembed"])
        logits = L.unembed(h, table)
        if mode == "train":
            # training loss reduces over vocab pointwise per token: keep
            # logits sequence-sharded so no chip holds (S, V) whole
            logits = spmd.constrain(logits, ("batch", "seq", None))
        else:
            logits = spmd.constrain(logits, ("batch", None, "vocab"))
        return logits, new_caches

    # ---------------- train ----------------
    CHUNKED_XENT_MIN_VOCAB = 65536

    def loss(self, params, batch):
        """The mean next-token cross-entropy of ``batch`` (``tokens`` and
        ``labels`` (B,S), label -100 for no target; for a frontend config
        ``frontend_embeds``), a float32 scalar."""
        cfg = self.cfg
        x, fe = self._embed_inputs(params, batch)
        enc_out = enc_pos = None
        if cfg.enc_layers:
            enc_in = fe if fe is not None else x  # audio enc-dec: frontend
            enc_out, enc_pos = self._encode(params, enc_in)
        B, S = x.shape[0], x.shape[1]
        positions = self._positions(B, S)
        labels = self._tensor(batch["labels"], torch.long)
        if cfg.frontend and not cfg.enc_layers and "frontend_embeds" in batch:
            # VLM: frontend positions carry no next-token target
            n_front = batch["frontend_embeds"].shape[1]
            pad = torch.full((B, n_front), -100, dtype=labels.dtype,
                             device=self.device)
            labels = torch.cat([pad, labels], dim=1)
        # the last position has no next token: its target is masked, not
        # sliced off (on a mesh DTensor would gather the position-sharded
        # hidden states or logits whole to slice them)
        targets = torch.cat([labels[:, 1:], torch.full(
            (B, 1), -100, dtype=labels.dtype, device=self.device)], 1)
        valid = targets >= 0

        table = spmd.grad_as_param(
            params["embed"] if cfg.tie_embeddings else params["unembed"])
        if cfg.vocab >= self.CHUNKED_XENT_MIN_VOCAB:
            # big vocabulary: the unembedding fused into a chunked online
            # softmax, so the (B,S,V) logits are never held
            h, _ = self._hidden(params, x, positions, enc_out, enc_pos)
            h = spmd.constrain(h, ("batch", "seq", None))
            nll_sum, n = L.chunked_cross_entropy(h, table, targets, valid)
            return nll_sum / torch.clamp_min(n, 1)
        logits, _ = self._trunk(params, x, positions, "train",
                                enc_out=enc_out, enc_positions=enc_pos)
        tgt = torch.where(valid, targets, 0)
        logp = torch.log_softmax(logits.float(), dim=-1)
        if spmd.mesh() is None:
            nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
        else:           # DTensor's gather backward makes global zeros
            hit = torch.arange(logp.shape[-1], device=self.device) \
                == tgt[..., None]
            nll = -torch.where(hit, logp, 0.0).sum(-1)
        nll = torch.where(valid, nll, 0.0)
        return nll.sum() / torch.clamp_min(valid.sum(), 1)

    def _hidden(self, params, x, positions, enc_out=None, enc_pos=None,
                mode="train", caches=None):
        """Trunk up to the final norm (no unembedding)."""
        cfg = self.cfg
        x = spmd.constrain(x, ("batch", None, None))
        h, new_caches = T.stack_apply(
            cfg, cfg.pattern, params["layers"], x, positions=positions,
            mode=mode, caches=caches, enc_out=enc_out, enc_positions=enc_pos)
        return L.rmsnorm(h, params["ln_f"]), new_caches

    # ---------------- serve ----------------
    def prefill(self, params, batch):
        """``batch``: ``tokens`` (B,S) and, for a frontend config,
        ``frontend_embeds`` (B,N,frontend_dim).  Returns the last
        position's logits (B,V) and one cache per decoder block."""
        cfg = self.cfg
        x, fe = self._embed_inputs(params, batch)
        enc_out = enc_pos = None
        if cfg.enc_layers:
            enc_in = fe if fe is not None else x
            enc_out, enc_pos = self._encode(params, enc_in)
        positions = self._positions(x.shape[0], x.shape[1])
        logits, caches = self._trunk(params, x, positions, "prefill",
                                     enc_out=enc_out, enc_positions=enc_pos)
        return logits[:, -1], caches

    def init_cache(self, batch_size, cache_len, dtype=None):
        cfg = self.cfg
        dt = act_dtype(dtype or cfg.act_dtype)
        return T.init_stack_caches(cfg, cfg.pattern, cfg.n_layers,
                                   batch_size, cache_len, dt, self.device)

    def decode_step(self, params, tokens, caches, pos,
                    enc_out=None, enc_positions=None):
        """tokens (B,1); pos (B,) current positions.  The caches are
        updated in place and returned."""
        cfg = self.cfg
        x = self._embed(self._tensor(tokens, torch.long), params["embed"],
                        act_dtype(cfg.act_dtype))
        positions = self._tensor(pos, torch.int32)[:, None]
        logits, new_caches = self._trunk(params, x, positions, "decode",
                                         caches=caches, enc_out=enc_out,
                                         enc_positions=enc_positions)
        return logits[:, 0], new_caches


def build_model(cfg, device=None) -> Model:
    """A :class:`Model` of ``cfg`` on ``device`` (default ``cuda``; raises
    without it).  An unknown block kind raises :class:`ValueError`.

    TF32 and bf16 reduced-precision reductions are turned off for CUDA
    matrix products here: the reference's float32 products are full
    float32, and its bf16 products accumulate in float32.  The two flags
    (``torch.backends.cuda.matmul.allow_tf32`` and
    ``allow_bf16_reduced_precision_reduction``) are process-wide: they
    stay off for every later CUDA product of the process and are never
    restored.
    """
    device = resolve_device(device)
    for kind in tuple(cfg.pattern) + (tuple(cfg.enc_pattern)
                                      if cfg.enc_layers else ()):
        T.check_kind(kind)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return Model(cfg, device)
