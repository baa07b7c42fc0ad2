"""Fault-tolerance demo: train, crash mid-run, resume losslessly from the
atomic checkpoint, then "elastically" restore the same checkpoint as if
the surviving slice had a different topology — the PyTorch port's
counterpart of ``examples/elastic_restart.py``.

    PYTHONPATH=src python examples_torch/elastic_restart.py               # a CUDA card
    PYTHONPATH=src python examples_torch/elastic_restart.py --device cpu
"""
import argparse
import shutil
import tempfile

import torch

from repro_torch.checkpoint import latest_step, restore_checkpoint
from repro_torch.configs import base
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.layers import named_leaves
from repro_torch.models.model_zoo import build_model
from repro_torch.train import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default: raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_elastic_")
    cfg = base.get("granite_3_2b").reduced()
    model = build_model(cfg, device=device)

    print("=== phase 1: train with an injected failure at step 12 ===")
    t1 = Trainer(model, TrainConfig(
        steps=20, batch=4, seq=32, ckpt_dir=ckpt_dir, ckpt_every=5,
        log_every=5, fail_at_step=12))
    try:
        t1.run()
    except RuntimeError as e:
        print(f"!! {e}")
    print(f"latest durable checkpoint: step {latest_step(ckpt_dir)}")

    print("\n=== phase 2: restart — auto-resume from the checkpoint ===")
    t2 = Trainer(model, TrainConfig(
        steps=20, batch=4, seq=32, ckpt_dir=ckpt_dir, ckpt_every=5,
        log_every=5))
    state, losses = t2.run()
    print(f"resumed and finished at step {int(state['step'])}, "
          f"final loss {losses[-1]:.4f}")

    print("\n=== phase 3: elastic rescale — restore under a new topology ===")
    # the checkpoint is topology-free; here we restore it for a 'smaller
    # slice' (single device) and verify bitwise identity of the params
    like = t2.init_state()
    restored = restore_checkpoint(ckpt_dir, int(state["step"]), like)
    got, want = named_leaves(restored["params"]), named_leaves(state["params"])
    same = got.keys() == want.keys() and all(
        torch.equal(got[k].detach().cpu(), want[k].detach().cpu())
        for k in want)
    print(f"params identical after reshard-restore: {same}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"identical": same, "step": int(state["step"])}


if __name__ == "__main__":
    main()
