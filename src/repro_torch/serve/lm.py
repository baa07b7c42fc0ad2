"""LM serving engine, PyTorch port of ``repro.serve.lm``: batched prefill
then greedy decode with KV caches.

It behaves as the reference's engine does, quirks included:

  * the batch is always ``batch_size`` rows: it is filled with copies of
    the last request;
  * prompts are left-padded with token 0 to the longest, and the padding
    is not masked (a short prompt attends to its padding);
  * the prefill caches are grown to ``cache_len`` (a ``local`` ring to
    ``min(cache_len, window)``) with ``pos = -1`` and zero k/v; recurrent
    states pass through;
  * greedy decoding takes the first maximum on a tie (``torch.argmax``);
  * a request stops at its ``max_new_tokens``, or after its ``eos``.

Prefill and decode run eagerly on the model's device; the reference jits
each.  After each :meth:`ServeEngine.generate`, ``timing`` holds the
prefill and decode times (CUDA events on a card, the host clock on the
CPU), read once the tokens reach the host.  The model comes from
:func:`~repro_torch.models.model_zoo.build_model`, which turns TF32 and
bf16 reduced-precision reductions off for the whole process.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass
class Request:
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 16
    eos: int = -1                 # -1: never stop early


def _mark(device: torch.device):
    if device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event
    return time.perf_counter()


def _ms(start, end) -> float:
    if isinstance(start, torch.cuda.Event):
        return start.elapsed_time(end)
    return (end - start) * 1e3


def _merge(cap: torch.Tensor, got: torch.Tensor) -> torch.Tensor:
    """``got`` padded at the end of each axis to ``cap``'s shape: -1 for
    positions, 0 for k and v.  A leaf of ``cap``'s shape (a recurrent
    block's conv, ssm or h state) is returned as it is."""
    if cap.shape == got.shape:
        return got
    pad = []
    for c, g in reversed(list(zip(cap.shape, got.shape))):
        pad += [0, c - g]
    return F.pad(got, pad, value=0 if got.is_floating_point() else -1)


class ServeEngine:
    def __init__(self, model, params, batch_size: int, cache_len: int):
        self.model = model
        self.params = params
        self.B = batch_size
        self.cache_len = cache_len
        self.timing: dict | None = None

    def _grow_caches(self, caches, S):
        cap = self.model.init_cache(self.B, self.cache_len,
                                    dtype=self.model.cfg.act_dtype)
        return [{name: _merge(c[name], g[name]) for name in c}
                for c, g in zip(cap, caches)]

    def generate(self, requests: list[Request]) -> list[np.ndarray]:
        """Greedy decode a batch of same-length-padded prompts."""
        if not requests or len(requests) > self.B:
            raise ValueError(
                f"{len(requests)} requests for a batch of {self.B}")
        dev = self.model.device
        reqs = list(requests) + [requests[-1]] * (self.B - len(requests))
        S = max(len(r.prompt) for r in reqs)
        prompts = np.stack([
            np.pad(r.prompt, (S - len(r.prompt), 0)) for r in reqs])
        batch = {"tokens": torch.as_tensor(prompts, dtype=torch.long,
                                           device=dev)}
        t0 = _mark(dev)
        logits, caches = self.model.prefill(self.params, batch)
        caches = self._grow_caches(caches, S)
        max_new = max(r.max_new_tokens for r in reqs)
        tok = torch.argmax(logits, -1)[:, None]
        outs = [tok]
        t1 = _mark(dev)
        for t in range(max_new - 1):
            pos = torch.full((self.B,), S + t, dtype=torch.int32, device=dev)
            logits, caches = self.model.decode_step(self.params, tok, caches,
                                                    pos)
            tok = torch.argmax(logits, -1)[:, None]
            outs.append(tok)
        t2 = _mark(dev)
        gen = torch.cat(outs, dim=1).cpu().numpy().astype(np.int32)
        if dev.type == "cuda":
            t2.synchronize()
        self.timing = {"batch": self.B, "prompt_len": S,
                       "prefill_ms": _ms(t0, t1), "decode_ms": _ms(t1, t2),
                       "decode_steps": max_new - 1}
        results = []
        for i, r in enumerate(requests):
            g = gen[i, :r.max_new_tokens]
            if r.eos >= 0 and (g == r.eos).any():
                g = g[:int(np.argmax(g == r.eos)) + 1]
            results.append(g)
        return results
