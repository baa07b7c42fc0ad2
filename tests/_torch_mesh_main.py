"""The port's mesh path on 4 CPU ranks (a 2x2 ("data", "model") mesh over
gloo, its store a file beside OUT.json), one case per run; imports no
JAX.

    python tests/_torch_mesh_main.py ep_moe IN.npz OUT.json
    python tests/_torch_mesh_main.py trainer ARCH OUT.json

``ep_moe``: ``mixers.moe_apply_ep`` on the inputs of ``IN.npz`` (dropless
and at capacity factor 8), its gradient against the port's dense
``moe_apply`` gradient, and the padding experts' gradient.  ``trainer``:
3 steps of the sharded ``Trainer`` on ``ARCH``'s reduced config against
the unsharded one (the first step's gradients, the losses and the
parameters after the steps), and a sharded run that crashes after its
step-2 checkpoint and resumes from it against the straight one.  Rank 0 writes what it measured to ``OUT.json``; the
test holds it to its bounds.
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

WORLD = 4


def _full(t):
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def ep_moe(mesh, in_npz: str) -> dict:
    from repro_torch.models import mixers

    z = np.load(in_npz)
    k, E_real = int(z["top_k"]), int(z["n_experts_real"])
    x = torch.from_numpy(z["x"])

    def params():
        p = {n: torch.from_numpy(z[n]) for n in ("router", "wi", "wg", "wo")}
        p["shared"] = {n: torch.from_numpy(z["shared_" + n])
                       for n in ("wi", "wg", "wo")}
        return p

    out = {}
    for name, kw in (("dropless", dict(dropless=True)),
                     ("capacity8", dict(capacity_factor=8.0))):
        got = mixers.moe_apply_ep(x, params(), top_k=k, mesh=mesh,
                                  batch_axes=("data",), n_experts_real=E_real,
                                  **kw)
        out[name] = _full(got).numpy().tolist()
        out[name + "_placements"] = [str(p) for p in got.placements]
        again = _full(mixers.moe_apply_ep(
            x, params(), top_k=k, mesh=mesh, batch_axes=("data",),
            n_experts_real=E_real, **kw))
        out[name + "_bitwise_rerun"] = bool(torch.equal(again, _full(got)))

    # gradients of sum(y^2): EP, on parameters laid out by the plan,
    # against the port's dense dispatch
    def grads(fn, layout=lambda t, spec: t):
        p, specs = params(), mixers.moe_specs(n_shared=1)
        p = {n: layout(p[n], specs[n]) for n in ("router", "wi", "wg", "wo")} \
            | {"shared": {n: layout(t, specs["shared"][n])
                          for n, t in p["shared"].items()}}
        leaves = [p["router"], p["wi"], p["wg"], p["wo"],
                  *p["shared"].values()]
        for t in leaves:
            t.requires_grad_()
        y = fn(p)
        g = torch.autograd.grad((y * y).sum(), leaves)
        return [_full(t) for t in g]

    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch import sharding

    def by_plan(t, spec):
        spec = sharding.guard_spec(t.shape, sharding.logical_to_spec(
            spec, sharding.DEFAULT_PLAN), mesh)
        return distribute_tensor(t, mesh, sharding.to_placements(spec, mesh))

    ep = grads(lambda p: mixers.moe_apply_ep(
        x, p, top_k=k, mesh=mesh, batch_axes=("data",), dropless=True,
        n_experts_real=E_real), by_plan)
    dense = grads(lambda p: mixers.moe_apply(x, p, top_k=k, dropless=True,
                                             n_experts_real=E_real))
    out["grad_max_abs_err"] = max(float((a - b).abs().max())
                                  for a, b in zip(ep, dense))
    out["grad_max_abs"] = max(float(b.abs().max()) for b in dense)
    out["grad_abs_sum"] = sum(float(a.abs().sum()) for a in ep)
    out["pad_expert_grad_max"] = float(ep[1][E_real:].abs().max())
    return out


def _first_grads(trainer, sink: dict):
    """Wraps ``trainer``'s optimizer so that its first update's gradients,
    whole (a DTensor gathered: every rank takes part), land in ``sink``."""
    import dataclasses

    update = trainer.optimizer.update

    def first(grads, *a, **kw):
        if not sink:
            sink.update({k: _full(g).detach().clone() for k, g in
                         grads.items() if g is not None})
        return update(grads, *a, **kw)

    trainer.optimizer = dataclasses.replace(trainer.optimizer, update=first)
    return trainer


def trainer(mesh, arch: str, out_json: str) -> dict:
    import dataclasses
    import shutil

    from repro_torch.configs import base
    from repro_torch.launch import sharding
    from repro_torch.launch.mesh import batch_axes
    from repro_torch.models import mixers
    from repro_torch.models import transformer as T
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train import TrainConfig, Trainer

    cfg = base.get(arch).reduced()
    traffic = dict(steps=3, batch=4, seq=32, lr=1e-3, warmup=1,
                   log_every=10 ** 9)

    def sharded_trainer(**kw):
        return Trainer(build_model(cfg, device="cpu"),
                       TrainConfig(**traffic, **kw), mesh=mesh,
                       batch_spec=("data",))

    ep = mixers.moe_apply_ep
    calls = []

    def counted(*a, **kw):
        calls.append(1)
        return ep(*a, **kw)

    mixers.moe_apply_ep = counted
    plan = sharding.DEFAULT_PLAN
    T.set_mesh_rules(mesh, {**plan.act_rule_map(mesh),
                            "batch": batch_axes(mesh)})
    grads: dict = {}
    ckpt = os.path.join(os.path.dirname(out_json), "ckpt")
    if dist.get_rank() == 0 and os.path.exists(ckpt):
        shutil.rmtree(ckpt)
    dist.barrier()
    try:
        state, losses = _first_grads(sharded_trainer(), grads).run()
        ep_calls = len(calls)
        # crash after step 2's checkpoint, then resume: every rank reads
        # the directory right after rank 0 wrote it (the library waits)
        try:
            sharded_trainer(ckpt_dir=ckpt, ckpt_every=2,
                            fail_at_step=2).run()
            crashed = False
        except RuntimeError:
            crashed = True
        resumed, resumed_losses = sharded_trainer(ckpt_dir=ckpt).run()
    finally:
        T.clear_mesh_rules()
        mixers.moe_apply_ep = ep
    from torch.distributed.tensor import DTensor

    sharded = {k: _full(p.detach()) for k, p in
               state["params"].named_parameters()}
    again = dict(resumed["params"].named_parameters())
    resume_bitwise = crashed and resumed_losses == losses[2:] and all(
        torch.equal(_full(again[k].detach()), v)
        for k, v in sharded.items()) and all(
        isinstance(p, DTensor) for p in again.values())
    placements = {k: [str(q) for q in p.placements] for k, p in
                  state["params"].named_parameters()}
    out = dict(arch=cfg.name, losses=losses, placements=placements,
               ep_calls=ep_calls, resumed_losses=resumed_losses,
               resume_bitwise=resume_bitwise)
    if dist.get_rank() == 0:
        ref_grads: dict = {}
        ref_state, ref_losses = _first_grads(Trainer(
            build_model(dataclasses.replace(cfg), device="cpu"),
            TrainConfig(**traffic)), ref_grads).run()
        ref = dict(ref_state["params"].named_parameters())
        out["ref_losses"] = ref_losses
        out["param_max_abs_err"] = max(
            float((sharded[k] - r.detach()).abs().max())
            for k, r in ref.items())
        out["n_params"] = len(ref)
        out["grad_keys_equal"] = sorted(grads) == sorted(ref_grads)
        # leaf by leaf: each leaf's largest difference over the tree's
        # largest |grad| (gate (a)'s grad_max_rel), and over its own
        tree_max = max(float(g.abs().max()) for g in ref_grads.values())
        diff = {k: float((grads[k] - g).abs().max())
                for k, g in ref_grads.items()}
        out["grad_max_rel"] = max(diff.values()) / tree_max
        out["grad_leaf_rel"] = {k: diff[k] / max(float(g.abs().max()),
                                                 tree_max * 1e-30)
                                for k, g in ref_grads.items()}
    return out


def _rank(rank: int, store: str, case: str, arg: str, out_json: str):
    torch.set_num_threads(1)
    # a file store: no port is picked and released before the ranks bind
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=WORLD, rank=rank)
    try:
        from repro_torch.launch.mesh import make_host_mesh

        mesh = make_host_mesh(2, 2)
        got = ep_moe(mesh, arg) if case == "ep_moe" else trainer(
            mesh, arg, out_json)
        if rank == 0:
            with open(out_json, "w") as f:
                json.dump(got, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    case, arg, out_json = sys.argv[1:4]
    store = os.path.join(os.path.dirname(os.path.abspath(out_json)),
                         "pg_store")
    if os.path.exists(store):
        os.remove(store)
    mp.spawn(_rank, args=(store, case, arg, out_json), nprocs=WORLD)
