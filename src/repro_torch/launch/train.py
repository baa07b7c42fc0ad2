"""Production training launcher, PyTorch port of ``repro.launch.train``.

Selects an architecture config (``--arch``), builds the sharding plan for
the mesh of the ranks it runs on, and runs the fault-tolerant trainer.
One process trains on one device (``--device``, default ``cuda``; raises
without a card), as the reference trains without a mesh on one device.
Under ``torchrun`` with a world of more than one, every rank joins the
default process group (``nccl`` on cards, ``gloo`` on the CPU), builds a
(data, model) mesh over the ranks, installs the plan's activation rules
and trains SPMD; rank 0 prints.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b \\
        --reduced --steps 50 --batch 8 --seq 128
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch granite_3_2b --reduced --steps 3 --model-axis 2 --device cpu
"""
from __future__ import annotations

import argparse
import os

import torch

from repro_torch.configs import base as config_base
from repro_torch.launch import sharding as shlib
from repro_torch.launch.mesh import batch_axes, make_host_mesh
from repro_torch.models import transformer as T
from repro_torch.models.model_zoo import build_model
from repro_torch.train import TrainConfig, Trainer
from repro_torch.train.trainer import log


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    choices=config_base.all_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--data-axis", type=int, default=0,
                    help="mesh data-axis size (0 = all ranks)")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; under torchrun each rank "
                         "takes the card of its LOCAL_RANK")
    args = ap.parse_args(argv)

    cfg = config_base.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    world = int(os.environ.get("WORLD_SIZE", "1"))
    device = torch.device(args.device)
    mesh = None
    batch_spec = ()
    rank = 0
    if world > 1:
        import torch.distributed as dist

        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        rank = dist.get_rank()
        data_ax = args.data_axis or max(world // args.model_axis, 1)
        mesh = make_host_mesh(data_ax, args.model_axis)
        plan = shlib.DEFAULT_PLAN
        T.set_mesh_rules(mesh, {**plan.act_rule_map(mesh),
                                "batch": batch_axes(mesh)})
        batch_spec = ("data",)
        if rank == 0:
            log(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    model = build_model(cfg, device=device)

    try:
        trainer = Trainer(model, TrainConfig(
            steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
            warmup=max(args.steps // 20, 2), ckpt_dir=args.ckpt_dir,
            compress_grads=args.compress_grads,
            log_every=max(args.steps // 20, 1)), mesh=mesh,
            batch_spec=batch_spec)
        state, losses = trainer.run()
        if rank == 0:
            log(f"done: arch={cfg.name} steps={int(state['step'])} "
                f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    finally:
        if mesh is not None:
            import torch.distributed as dist

            T.clear_mesh_rules()
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
