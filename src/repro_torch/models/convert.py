"""Weight carry-over from the JAX reference's parameter tree.

:func:`params_from_numpy` turns the reference's ``Model.init`` output, as
numpy arrays (``jax.tree.map(np.asarray, params)``), into the port's
:class:`~repro_torch.models.layers.ParamTree`.  The reference stacks each
pattern position's blocks along a leading group axis
(``layers.scanned[j]``) and keeps the remainder unstacked (``tail``); the
port's stack is flat, so ``scanned[j][g]`` becomes layer
``g*len(pattern)+j`` and ``tail[j]`` layer ``n_groups*len(pattern)+j``
(RecurrentGemma's 26 layers: 8 groups of ``(rec, rec, local)``, then its
two tail ``rec`` blocks as layers 24 and 25).  Every block's subtree
(attention, MLP, experts with router and shared expert, SSD, RG-LRU)
keeps its names and layouts.

:func:`state_from_numpy` carries a whole reference Trainer state over the
same way: the parameters, the optimizer's moments (AdamW's ``m``/``v``,
Adafactor's per-parameter ``{vr, vc}`` or ``{v}``, each in the
parameters' tree) and the step.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def _map(tree, fn):
    if isinstance(tree, Mapping):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _unstack(stack: Mapping, pattern, n_layers: int) -> list:
    """The reference's ``{"scanned", "tail"}`` stack as a flat block list."""
    for kind in pattern:
        T.check_kind(kind)
    glen = len(pattern)
    n_groups = n_layers // glen
    scanned, tail = list(stack["scanned"]), list(stack["tail"])
    if len(scanned) != (glen if n_groups else 0) or len(tail) != n_layers % glen:
        raise ValueError(
            f"stack of {len(scanned)} scanned + {len(tail)} tail blocks "
            f"does not hold {n_layers} layers of pattern {pattern}")
    blocks = [_map(scanned[j], lambda a, g=g: a[g])
              for g in range(n_groups) for j in range(glen)]
    return blocks + tail


def _unstack_model(cfg, tree: Mapping) -> dict:
    """A tree of the reference's model layout (parameters, or anything in
    their tree) with its stacks flattened as the port's."""
    want = {"embed", "layers", "ln_f"}
    if not cfg.tie_embeddings:
        want.add("unembed")
    if cfg.enc_layers:
        want |= {"encoder", "ln_enc"}
    if cfg.frontend:
        want.add("frontend_proj")
    if set(tree) != want:
        raise ValueError(
            f"parameter tree has {sorted(tree)}, config {cfg.name!r} "
            f"needs {sorted(want)}")
    out = dict(tree)
    out["layers"] = _unstack(tree["layers"], cfg.pattern, cfg.n_layers)
    if cfg.enc_layers:
        out["encoder"] = _unstack(tree["encoder"], cfg.enc_pattern,
                                  cfg.enc_layers)
    return out


def _tensor(a, device):
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


def params_from_numpy(cfg, tree: Mapping, device=None) -> L.ParamTree:
    """The reference's parameter tree (numpy leaves) as the port's, on
    ``device`` (default ``cuda``; raises without it)."""
    device = resolve_device(device)
    return L.ParamTree(_map(_unstack_model(cfg, tree),
                            lambda a: _tensor(a, device)))


def state_from_numpy(cfg, state: Mapping, device=None) -> dict:
    """A reference Trainer state with numpy leaves (``jax.tree.map(
    np.asarray, state)``) as the port's ``{"params", "opt", "step"}``, on
    ``device`` (default ``cuda``; raises without it).  The optimizer state
    is keyed by parameter path, as ``repro_torch.optim`` keeps it."""
    device = resolve_device(device)
    params = params_from_numpy(cfg, state["params"], device)
    paths = list(L.named_leaves(params))

    def by_path(tree):
        flat = L.named_leaves(_unstack_model(cfg, tree))
        return {k: _tensor(a, device) for k, a in flat.items()}

    opt = state["opt"]
    if set(opt) == {"m", "v"}:                          # AdamW
        out = {"m": by_path(opt["m"]), "v": by_path(opt["v"])}
    elif set(opt) == {"v"}:                             # Adafactor
        flat = by_path(opt["v"])
        out = {"v": {p: {n: flat[f"{p}/{n}"] for n in ("vr", "vc", "v")
                         if f"{p}/{n}" in flat} for p in paths}}
    else:
        raise ValueError(f"optimizer state with {sorted(opt)}")
    for moments in out.values():
        if set(moments) != set(paths):
            raise ValueError("optimizer state does not match the parameters")
    return {"params": params, "opt": out,
            "step": torch.tensor(int(state["step"]), dtype=torch.int32)}
