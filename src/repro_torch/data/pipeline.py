"""Deterministic synthetic LM data, PyTorch port of ``repro.data.pipeline``.

Batches are a pure function of (seed, step), so resuming at step N
reproduces the exact stream and needs no data state in a checkpoint.
Tokens come from an LCG-mixed integer hash over (seed, step, position)
with a square-law fold, so losses are learnable but non-trivial; they
are bitwise the reference's.  The reference's sharding vocabulary
(``mesh``, ``batch_spec``, ``make_batch_specs``) has no counterpart: the
port runs on one device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device


def _hash_tokens(seed: int, step: int, batch: int, seq: int, vocab: int):
    b = np.arange(batch, dtype=np.uint64)[:, None]
    s = np.arange(seq, dtype=np.uint64)[None, :]
    with np.errstate(over="ignore"):  # uint64 wraparound is the hash mix
        x = (np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15)
             + np.uint64(step) * np.uint64(0xBF58476D1CE4E5B9)
             + b * np.uint64(0x94D049BB133111EB) + s * np.uint64(2654435761))
        x ^= x >> np.uint64(31)
        x *= np.uint64(0xD6E8FEB86659FD93)
        x ^= x >> np.uint64(27)
    # fold to a skewed distribution: square-root-ish compaction
    u = (x % np.uint64(1 << 30)).astype(np.float64) / float(1 << 30)
    toks = (u * u * (vocab - 1)).astype(np.int32)
    return toks


@dataclasses.dataclass
class SyntheticLMData:
    """Batches of ``batch`` x ``seq`` tokens over ``vocab`` on ``device``
    (default ``cuda``; raises without it).  ``frontend_tokens`` > 0 adds
    ``frontend_embeds`` (batch, frontend_tokens, frontend_dim), drawn from
    ``np.random.default_rng((seed << 20) ^ step)``."""

    vocab: int
    batch: int
    seq: int
    seed: int = 0
    frontend_tokens: int = 0
    frontend_dim: int = 0
    device: torch.device | str | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def batch_at(self, step: int) -> dict:
        """``tokens`` and ``labels`` (the tokens shifted left by one,
        wrapping), int32 (B,S), and ``frontend_embeds`` where configured."""
        toks = _hash_tokens(self.seed, step, self.batch, self.seq, self.vocab)
        host = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
        if self.frontend_tokens:
            rng = np.random.default_rng((self.seed << 20) ^ step)
            host["frontend_embeds"] = rng.standard_normal(
                (self.batch, self.frontend_tokens, self.frontend_dim)
            ).astype(np.float32) * 0.05
        return {k: torch.from_numpy(v).to(self.device) for k, v in host.items()}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
