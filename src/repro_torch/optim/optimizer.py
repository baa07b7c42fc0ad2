"""Optimizers over parameter trees, PyTorch port of
``repro.optim.optimizer``.

AdamW for the standard runs; Adafactor (factored second moments) for the
configs whose full Adam state would not fit.  Both clip to a global norm
and follow a warmup + cosine schedule; AdamW can round its gradients
through bf16 first (``compress_grads``, the reference's halving of
all-reduce bytes; the moments stay float32).

The shape is the reference's ``init``/``update`` pair, with PyTorch's
idiom: ``update`` writes the new parameters and moments *in place* (where
the reference donates its buffers) and returns them.  A tree is anything
:func:`~repro_torch.models.layers.named_leaves` walks (a ``ParamTree``, a
dict of tensors); the state holds one entry per parameter under its
``/``-joined path.  Every formula keeps the reference's order of
operations, so each step rounds as the reference's does; the scalars
(schedule, bias corrections, Adafactor's beta) are computed in float32 as
the reference computes them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.models.layers import named_leaves

f32 = np.float32


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """Linear warmup from 0 over ``warmup`` steps, then a cosine decay to 0
    at ``total``; ``lr(step)`` is a Python float (a float32 value)."""
    def lr(step):
        step = f32(step)
        warm = f32(base_lr) * step / f32(max(warmup, 1))
        frac = np.clip((step - f32(warmup)) / f32(max(total - warmup, 1)),
                       f32(0), f32(1))
        cos = f32(base_lr) * f32(0.5) * (f32(1) + np.cos(f32(np.pi) * frac))
        return float(warm if step < warmup else cos)
    return lr


def _global_norm(grads):
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads.values()))


def _clip_scale(grads, clip_norm):
    """The factor that brings the global norm to at most ``clip_norm``
    (a device scalar: no host sync), or None without clipping."""
    if clip_norm is None:
        return None
    return torch.clamp(clip_norm / torch.clamp(_global_norm(grads), min=1e-9),
                       max=1.0)


def _grads(grads, params):
    """The gradients by path; a parameter without one (unused by the loss)
    gets zeros, as the reference's gradient of an unused leaf."""
    grads = named_leaves(grads)
    return {k: torch.zeros_like(p) if grads.get(k) is None else grads[k]
            for k, p in params.items()}


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable    # (params) -> state
    update: Callable  # (grads, state, params, step) -> (params, state), in place
    name: str = "opt"


def adamw(lr: Callable | float, b1=0.9, b2=0.95, eps=1e-8,
          weight_decay=0.1, clip_norm: float | None = 1.0,
          compress_grads: bool = False) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        params = named_leaves(params)
        return {"m": {k: torch.zeros_like(p) for k, p in params.items()},
                "v": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(grads, state, params, step):
        tree, params = params, named_leaves(params)
        grads = _grads(grads, params)
        if compress_grads:
            grads = {k: g.to(torch.bfloat16).float() for k, g in grads.items()}
        scale = _clip_scale(grads, clip_norm)
        t = f32(step) + f32(1)
        lr_t = lr_fn(step)
        bc1, bc2 = float(f32(1) - f32(b1) ** t), float(f32(1) - f32(b2) ** t)
        for k, p in params.items():
            g = grads[k].float()
            if scale is not None:
                g = g * scale
            m, v = state["m"][k], state["v"][k]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            step_ = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p
            p.sub_(lr_t * step_)
        return tree, state

    return Optimizer(init, update, "adamw")


def adafactor(lr: Callable | float, eps=1e-30, clip_threshold=1.0,
              decay=0.8, weight_decay=0.0, min_dim_factored=128,
              clip_norm: float | None = 1.0) -> Optimizer:
    """Factored second moments for >=2-D params whose trailing dims are both
    >= min_dim_factored; smaller params keep full moments."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def factored(p):
        return p.dim() >= 2 and p.shape[-1] >= min_dim_factored and \
            p.shape[-2] >= min_dim_factored

    def init(params):
        def st(p):
            f = dict(dtype=torch.float32, device=p.device)
            if factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **f),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f)}
            return {"v": torch.zeros(p.shape, **f)}
        return {"v": {k: st(p) for k, p in named_leaves(params).items()}}

    @torch.no_grad()
    def update(grads, state, params, step):
        tree, params = params, named_leaves(params)
        grads = _grads(grads, params)
        scale = _clip_scale(grads, clip_norm)
        t = f32(step) + f32(1)
        beta = float(f32(1) - t ** f32(-decay))
        lr_t = lr_fn(step)
        for k, p in params.items():
            g = grads[k].float()
            if scale is not None:
                g = g * scale
            v = state["v"][k]
            g2 = g * g + eps
            if "vr" in v:
                v["vr"].mul_(beta).add_((1 - beta) * g2.mean(-1))
                v["vc"].mul_(beta).add_((1 - beta) * g2.mean(-2))
                vr, vc = v["vr"], v["vc"]
                denom = (vr[..., None] / torch.clamp(
                    vr.mean(-1, keepdim=True)[..., None], min=eps)) \
                    * vc[..., None, :]
                u = g / torch.sqrt(torch.clamp(denom, min=eps))
            else:
                v["v"].mul_(beta).add_((1 - beta) * g2)
                u = g / torch.sqrt(torch.clamp(v["v"], min=eps))
            rms_u = torch.sqrt(torch.mean(u * u) + 1e-12)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            p.sub_(lr_t * (u + weight_decay * p))
        return tree, state

    return Optimizer(init, update, "adafactor")


def make_optimizer(name: str, lr=3e-4, total_steps=10_000, warmup=200,
                   **kw) -> Optimizer:
    sched = cosine_schedule(lr, warmup, total_steps)
    if name == "adamw":
        return adamw(sched, **kw)
    if name == "adafactor":
        return adafactor(sched, **kw)
    raise ValueError(name)
