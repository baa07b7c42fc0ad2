"""Readings behind the bounds of gate (b) of ``chip_smoke.py``'s phase
``lm_serve``: granite-3-2b at full width cut to depth 2, the same seeded
weights as the phase, the card against the port's CPU path, sound and with
a fault injected on the card's side.

Run from the checkout root on a machine with a card::

    python3 tools/lm_gate_readings.py [N_TOKEN_SETS]

Token sets: the phase's own (2, 64) tokens, then ``N_TOKEN_SETS - 1`` more
from seeds 1, 2, ...  For each set it prints one JSON line with
``chip_smoke.logit_errs``'s readings (``max_rel``, ``rms_rel`` of the
prefill logits and of 16 decode steps' logits) for

  * ``float32`` and ``bfloat16``: the port as it stands;
  * ``bf16_vs_f32``: the card's bf16 logits against its float32 logits;
  * ``tf32``: float32 with TF32 products allowed;
  * ``reduced_reduction``: bf16 with cuBLAS's reduced-precision bf16
    reductions allowed;
  * ``no_upcast``: bf16 with every ``Tensor.float()`` of the model a no-op
    (attention scores, softmax and norms left in bf16);

then a ``summary`` line: per metric the largest sound reading and each
fault's smallest, and the last line the card's ``nvidia-smi`` name and
power limit.  About 40 s on one H100.
"""
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402


class NoUpcast(torch.overrides.TorchFunctionMode):
    """``Tensor.float()`` returns its tensor unchanged."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.float:
            return args[0]
        return func(*args, **(kwargs or {}))


def token_sets(vocab: int, n: int):
    rng = np.random.default_rng(cs.LM_SEED)
    rng.integers(0, vocab, 16)         # gate (a)'s prompt, drawn first
    yield "phase", rng.integers(0, vocab, (2, 64)).astype(np.int32)
    for seed in range(1, n):
        yield (f"seed{seed}", np.random.default_rng(seed)
               .integers(0, vocab, (2, 64)).astype(np.int32))


def main() -> int:
    n_sets = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    if not torch.cuda.is_available():
        print("lm_gate_readings: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cfg = base.get(cs.LM_ARCH)
    params = build_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(cs.LM_SEED))
    cut = L.ParamTree({"embed": params["embed"],
                       "layers": [params["layers"][i] for i in range(2)],
                       "ln_f": params["ln_f"]})
    del params
    torch.cuda.empty_cache()
    steps = cs.LM_DECODE_STEPS
    cfgs = {dt: dataclasses.replace(cfg, n_layers=2, act_dtype=dt)
            for dt in ("float32", "bfloat16")}
    cut_cpu = copy.deepcopy(cut).to("cpu")

    def card(dt, tokens, flag=None, mode=None):
        model = build_model(cfgs[dt], device=dev)   # resets both flags
        if flag:
            setattr(torch.backends.cuda.matmul, flag, True)
        try:
            if mode is not None:
                with mode():
                    return cs.lm_logits(model, cut, tokens, steps)
            return cs.lm_logits(model, cut, tokens, steps)
        finally:
            build_model(cfgs[dt], device=dev)

    rows = []
    for name, tokens in token_sets(cfg.vocab, n_sets):
        row = dict(tokens=name)
        cpu, cpu_s = {}, {}
        for dt in cfgs:
            t0 = time.perf_counter()
            cpu[dt] = cs.lm_logits(build_model(cfgs[dt], device="cpu"),
                                   cut_cpu, tokens, steps)
            cpu_s[dt] = time.perf_counter() - t0
        row["cpu_s"] = cpu_s
        sound = {dt: card(dt, tokens) for dt in cfgs}
        for dt in cfgs:
            row[dt] = dict(cs.logit_errs(sound[dt], cpu[dt]),
                           cache_dtype=sound[dt][2])
        row["bf16_vs_f32"] = cs.logit_errs(sound["bfloat16"],
                                           sound["float32"])
        row["tf32"] = cs.logit_errs(card("float32", tokens, "allow_tf32"),
                                    cpu["float32"])
        row["reduced_reduction"] = cs.logit_errs(
            card("bfloat16", tokens,
                 "allow_bf16_reduced_precision_reduction"), cpu["bfloat16"])
        row["no_upcast"] = cs.logit_errs(
            card("bfloat16", tokens, mode=NoUpcast), cpu["bfloat16"])
        print(json.dumps(row), flush=True)
        rows.append(row)

    metrics = list(rows[0]["float32"])[:-1]
    summary = {dt: {m: max(r[dt][m] for r in rows) for m in metrics}
               for dt in cfgs}
    for fault in ("tf32", "reduced_reduction", "no_upcast"):
        summary[fault] = {m: min(r[fault][m] for r in rows) for m in metrics}
    summary["bf16_vs_f32"] = {m: max(r["bf16_vs_f32"][m] for r in rows)
                              for m in metrics}
    print(json.dumps(dict(summary=summary, token_sets=len(rows),
                          decode_steps=steps)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
