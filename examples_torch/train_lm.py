"""End-to-end training: train an LM with the full production stack
(data pipeline, optimizer, async checkpointing, fault-tolerant trainer) —
the PyTorch port's counterpart of ``examples/train_lm.py``.

    PYTHONPATH=src python examples_torch/train_lm.py --preset small   # a CUDA card
    PYTHONPATH=src python examples_torch/train_lm.py --preset 100m --steps 300
    PYTHONPATH=src python examples_torch/train_lm.py --preset tiny --device cpu

The 100m preset is a ~100M-parameter internlm2-family config.  The
checkpoints go to ``--ckpt-dir`` (default ``repro_torch_train_lm`` in the
temporary directory, apart from the JAX example's, so neither package
resumes the other's run); a directory that already holds a checkpoint is
resumed from its latest step.
"""
import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch.configs import base
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.model_zoo import build_model
from repro_torch.train import TrainConfig, Trainer

PRESETS = {
    # (d_model, n_layers, n_heads, n_kv, d_ff, vocab, batch, seq)
    "tiny": (64, 2, 4, 2, 128, 512, 4, 64),
    "small": (256, 4, 4, 2, 1024, 4096, 8, 128),
    "100m": (768, 12, 12, 4, 2048, 16384, 8, 256),
}


def make_cfg(preset: str):
    d, L, h, kv, f, v, b, s = PRESETS[preset]
    cfg = dataclasses.replace(
        base.get("internlm2_1_8b"),
        name=f"lm-{preset}", n_layers=L, d_model=d, n_heads=h,
        n_kv_heads=kv, d_head=d // h, d_ff=f, vocab=v,
        act_dtype="float32", remat="none",
    )
    return cfg, b, s


def count_params(model) -> int:
    """The parameter count of ``model``'s tree, from shapes alone (fake
    tensors: nothing is allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = model.init(torch.Generator(device=model.device))
    return sum(p.numel() for p in params.parameters())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="small", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default=None,
                    help="cuda (the default: raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg, batch, seq = make_cfg(args.preset)
    model = build_model(cfg, device=device)
    n = count_params(model)
    print(f"preset={args.preset}: {n / 1e6:.1f}M params, "
          f"batch={batch} seq={seq}, {args.steps} steps")

    trainer = Trainer(model, TrainConfig(
        steps=args.steps, batch=batch, seq=seq, lr=args.lr,
        warmup=max(args.steps // 20, 5), ckpt_dir=args.ckpt_dir,
        ckpt_every=max(args.steps // 4, 10), log_every=10))
    state, losses = trainer.run()
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f}); "
          f"checkpoints in {args.ckpt_dir}")
    return {"params": n, "losses": losses}


if __name__ == "__main__":
    main()
