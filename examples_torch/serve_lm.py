"""Batched serving example: prefill + KV-cache decode with the ServeEngine —
the PyTorch port's counterpart of ``examples/serve_lm.py``.

    PYTHONPATH=src python examples_torch/serve_lm.py               # a CUDA card
    PYTHONPATH=src python examples_torch/serve_lm.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import base
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.model_zoo import build_model
from repro_torch.serve import Request, ServeEngine


def requests_for(cfg) -> list:
    rng = np.random.default_rng(0)
    return [
        Request(prompt=rng.integers(1, cfg.vocab, size=n).astype(np.int32),
                max_new_tokens=24)
        for n in (12, 7, 19, 4)
    ]


def engine_for(model, params) -> ServeEngine:
    return ServeEngine(model, params, batch_size=4, cache_len=96)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default: raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = base.get("recurrentgemma_2b").reduced()  # hybrid: RG-LRU + local
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    engine = engine_for(model, params)

    requests = requests_for(cfg)
    t0 = time.perf_counter()
    outs = engine.generate(requests)
    dt = time.perf_counter() - t0
    total_new = sum(len(o) for o in outs)
    print(f"arch={cfg.name}: generated {total_new} tokens for "
          f"{len(requests)} requests in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s incl. warm-up)")
    for i, o in enumerate(outs):
        print(f"  req{i} ({len(requests[i].prompt)} prompt toks) -> "
              f"{o[:10].tolist()}{'...' if len(o) > 10 else ''}")

    # steady-state decode throughput (caches and kernels warm)
    t0 = time.perf_counter()
    outs = engine.generate(requests)
    dt = time.perf_counter() - t0
    print(f"warm: {sum(len(o) for o in outs) / dt:.1f} tok/s")
    return {"generated": total_new}


if __name__ == "__main__":
    main()
