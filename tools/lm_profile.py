"""Where the LM serving path's time goes on one card: ``torch.profiler``
over one prefill of the served batch and over decode steps, per config.

Run from the root of a checkout, on a machine with a CUDA card::

    python3 tools/lm_profile.py [ARCH ...]

The configs default to ``chip_smoke.LM_ARCH`` and
``chip_smoke.LM_MIXER_ARCHS``, each at full width and depth with the
phases' seeded weights and the phases' served batch (8 prompts of 64-512
tokens drawn as ``chip_smoke.lm_serve`` draws them, left-padded as
``ServeEngine`` pads them) in bf16.  For each config and pass
(``prefill``: the batch; ``decode``: one step at the batch's next
position, from an empty cache of the traffic's length) one line gives the
unprofiled wall ms of one pass (CUDA events; the median of 3 prefills,
the mean of 8 decode steps after 4 warm ones), the profiled pass's kernel
launches, device-busy ms and share of that wall time, and the 10
operators (``aten::*``) with the most device time with their share of
it; ``copy_share`` is ``aten::copy_``'s share (every ``.to(dtype)``, the
fp32 masters cast to bf16 among them, and every ``.contiguous()``).  For
an MoE config the prefill line also gives, over the layers, the share of
the routed (token, expert) slots that go to each layer's 4 busiest
experts and the dropped share at the config's capacity.  The last line is
the card's ``nvidia-smi`` name and power limit.  Exits non-zero without
CUDA.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402


def _wall_ms(fn, reps: int) -> float:
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _profiled(fn, wall_ms: float) -> dict:
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    ops = sorted(((e.key, cs.device_us(e), e.count)
                  for e in prof.key_averages()
                  if e.key.startswith("aten::") and cs.device_us(e) > 0),
                 key=lambda t: -t[1])
    total = sum(us for _, us, _ in ops) or 1.0
    return dict(
        wall_ms=wall_ms, launches=len(kernels), device_busy_ms=busy_us / 1e3,
        device_busy_share=busy_us / 1e3 / wall_ms,
        copy_share=sum(us for k, us, _ in ops if k == "aten::copy_") / total,
        top_ops=[dict(op=k, device_ms=us / 1e3, share=us / total, calls=n)
                 for k, us, n in ops[:10]])


def main() -> int:
    if not torch.cuda.is_available():
        print("lm_profile: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    traffic = cs.LM_TRAFFIC
    for arch in sys.argv[1:] or (cs.LM_ARCH,) + cs.LM_MIXER_ARCHS:
        cfg = base.get(arch)
        model = build_model(cfg, device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(cs.LM_SEED))
        rng = np.random.default_rng(cs.LM_SEED)
        rng.integers(0, cfg.vocab, 16)          # gate (a)'s prompt
        rng.integers(0, cfg.vocab, (2, 64))     # gate (b)'s tokens
        lens = rng.integers(traffic["prompt_min"], traffic["prompt_max"] + 1,
                            traffic["requests"])
        S = int(max(lens))
        prompts = np.stack([np.pad(rng.integers(0, cfg.vocab, n), (S - n, 0))
                            for n in lens]).astype(np.int32)
        batch = {"tokens": prompts}

        def prefill():
            return model.prefill(params, batch)

        prefill()
        wall = sorted(_wall_ms(prefill, 1) for _ in range(3))[1]
        line = dict(arch=arch, pass_="prefill", batch=list(prompts.shape),
                    **_profiled(prefill, wall))
        if cfg.n_experts:
            with cs.MoeProbe() as probe:
                prefill()
            top4 = []
            for call in probe.calls:
                load = torch.bincount(call["experts"].reshape(-1),
                                      minlength=cfg.n_experts_padded)
                top4.append(float(load.topk(4).values.sum() / load.sum()))
            drops = [c["dropped_frac"] for c in probe.calls]
            line["routing"] = dict(
                top4_expert_share_mean=sum(top4) / len(top4),
                top4_expert_share_min=min(top4), layers=len(top4),
                dropped_frac_mean=sum(drops) / len(drops),
                capacity_factor=cfg.capacity_factor)
        print(json.dumps(line), flush=True)

        B = traffic["batch_size"]
        state = {"caches": model.init_cache(B, traffic["cache_len"]),
                 "pos": S}
        tok = torch.zeros((B, 1), dtype=torch.long, device=dev)

        def step():
            pos = torch.full((B,), state["pos"], dtype=torch.int32,
                             device=dev)
            _, state["caches"] = model.decode_step(params, tok,
                                                   state["caches"], pos)
            state["pos"] += 1

        for _ in range(4):
            step()
        wall = _wall_ms(step, 8)
        print(json.dumps(dict(arch=arch, pass_="decode", batch=B,
                              **_profiled(step, wall))), flush=True)
        del model, params, state
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
