"""Fault-tolerant training loop, PyTorch port of ``repro.train.trainer``.

  * checkpoint/restart is the recovery primitive: atomic-commit
    checkpoints (``repro_torch.checkpoint``) written asynchronously every
    ``ckpt_every`` steps and at the end, auto-resume from the latest on
    (re)start.  The data pipeline is a pure function of step, so a resumed
    run sees the exact batches of an uninterrupted one;
  * straggler detection: a per-step wall-time z-score (steps >= 3, over
    the last 50, once 20 are in) calls the pluggable ``on_straggler``;
  * failure injection for tests: ``fail_at_step`` waits for the pending
    checkpoint, then raises, and the next :meth:`Trainer.run` must resume
    losslessly.

A step is ``Model.loss``, its gradients (``torch.autograd.grad``) and the
optimizer's in-place update, on the model's device (``cuda`` unless the
model was built for the CPU).  ``train_step`` is an attribute, so a
caller can wrap it.

The mesh half: ``Trainer(model, cfg, mesh=..., batch_spec=...)`` lays the
parameters out by the sharding plan (``launch.sharding.shard_params``)
and the optimizer state by ``mirror_opt_shardings``, feeds batches
sharded over ``batch_spec``, and runs the same step SPMD on DTensors
(under ``implicit_replication``); every rank of the mesh runs
:meth:`Trainer.run`.  The activation rules are the caller's
(``transformer.set_mesh_rules``, as ``launch/train.py`` installs them).
With no mesh it runs exactly as on one device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
)
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.models.layers import named_leaves
from repro_torch.optim import make_optimizer


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    batch: int = 8
    seq: int = 64
    lr: float = 3e-4
    warmup: int = 10
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_keep: int = 3
    log_every: int = 10
    seed: int = 0
    fail_at_step: Optional[int] = None     # failure injection (tests)
    straggler_zscore: float = 4.0
    compress_grads: bool = False


class Trainer:
    def __init__(self, model, cfg: TrainConfig, mesh=None, batch_spec=None,
                 on_straggler: Optional[Callable] = None):
        self.model = model
        self.cfg = cfg
        self.mesh = mesh
        arch = model.cfg
        self.optimizer = make_optimizer(
            arch.optimizer, lr=cfg.lr, total_steps=cfg.steps,
            warmup=cfg.warmup,
            **({"compress_grads": True} if cfg.compress_grads
               and arch.optimizer == "adamw" else {}),
        )
        self.data = SyntheticLMData(
            vocab=arch.vocab, batch=cfg.batch, seq=cfg.seq, seed=cfg.seed,
            frontend_tokens=arch.n_frontend_tokens if arch.frontend else 0,
            frontend_dim=arch.frontend_dim, device=model.device,
            mesh=mesh, batch_spec=batch_spec if batch_spec else (),
        )
        self.on_straggler = on_straggler
        self._step_times: list[float] = []
        self.train_step = self._train_step

    def _train_step(self, params, opt_state, batch, step: int):
        """One step: returns (params, opt_state, loss), the first two
        updated in place; on a mesh, the loss gathered whole."""
        with _spmd(self.mesh):
            named = named_leaves(params)
            loss = self.model.loss(params, batch)
            grads = torch.autograd.grad(loss, list(named.values()),
                                        allow_unused=True)
            self.optimizer.update(dict(zip(named, grads)), opt_state, named,
                                  step)
            loss = loss.detach()
            if self.mesh is not None:
                loss = loss.full_tensor()
        return params, opt_state, loss

    # ------------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None):
        """Parameters from ``generator`` (default: seeded with
        ``cfg.seed`` on the model's device), zero moments, step 0."""
        if generator is None:
            generator = torch.Generator(device=self.model.device)
            generator.manual_seed(self.cfg.seed)
        params = self.model.init(generator).requires_grad_()
        if self.mesh is None:
            opt = self.optimizer.init(params)
        else:
            from repro_torch.launch import sharding

            plan = sharding.DEFAULT_PLAN
            sharding.shard_params(self.model, params, self.mesh, plan)
            with _spmd(self.mesh):
                opt = self.optimizer.init(params)
            opt = sharding.shard_tree(opt, sharding.mirror_opt_shardings(
                sharding.param_shardings(self.model, params, self.mesh, plan),
                opt, self.mesh))
        return {"params": params, "opt": opt,
                "step": torch.zeros((), dtype=torch.int32)}

    def run(self, state=None, steps=None):
        """Train from ``state`` (default: a fresh state, or the latest
        checkpoint of ``cfg.ckpt_dir``) up to step ``steps`` (default
        ``cfg.steps``).  Returns (state, the losses of the steps run)."""
        cfg = self.cfg
        ckpt = AsyncCheckpointer(cfg.ckpt_dir, cfg.ckpt_keep) \
            if cfg.ckpt_dir else None
        if state is None:
            state = self.init_state()
            if cfg.ckpt_dir and (last := latest_step(cfg.ckpt_dir)) is not None:
                state = restore_checkpoint(cfg.ckpt_dir, last, state)
                print(f"[trainer] resumed from step {last}")
        state["params"].requires_grad_()
        start = int(state["step"])
        total = steps if steps is not None else cfg.steps
        losses = []
        for step in range(start, total):
            if cfg.fail_at_step is not None and step == cfg.fail_at_step:
                if ckpt:
                    ckpt.wait()
                raise RuntimeError(f"injected failure at step {step}")
            t0 = time.perf_counter()
            batch = self.data.batch_at(step)
            params, opt, loss = self.train_step(
                state["params"], state["opt"], batch, step)
            state = {"params": params, "opt": opt,
                     "step": torch.tensor(step + 1, dtype=torch.int32)}
            losses.append(float(loss))      # waits for the step's work
            dt = time.perf_counter() - t0
            self._check_straggler(step, dt)
            if step % cfg.log_every == 0:
                print(f"[trainer] step {step} loss {losses[-1]:.4f} "
                      f"({dt*1e3:.0f} ms)")
            if ckpt and (step + 1) % cfg.ckpt_every == 0:
                ckpt.save(step + 1, state)
        if ckpt:
            ckpt.save(int(state["step"]), state)
            ckpt.wait()
        return state, losses

    # ------------------------------------------------------------------
    def _check_straggler(self, step: int, dt: float):
        """Per-step wall-time z-score straggler detector."""
        if step < 3:
            return  # exclude warmup steps from the baseline
        self._step_times.append(dt)
        hist = self._step_times[-50:]
        if len(hist) >= 20:
            mu = float(np.mean(hist[:-1]))
            sd = float(np.std(hist[:-1])) + 1e-9
            z = (dt - mu) / sd
            if z > self.cfg.straggler_zscore and self.on_straggler:
                self.on_straggler(step=step, zscore=z, dt=dt)


def _spmd(mesh):
    """On a mesh, plain tensors made inside the step count as replicated
    DTensors; without one, nothing."""
    import contextlib

    if mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()
