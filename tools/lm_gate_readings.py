"""Readings behind the bounds of gate (b) of ``chip_smoke.py``'s phases
``lm_serve`` and ``lm_mixers``: one config at full width cut to one
pattern group (``chip_smoke.gate_layers``: at least 2 layers), the same
seeded weights as the phase, the card against the port's CPU path, sound
and with a fault injected on the card's side.

Run from the checkout root on a machine with a card::

    python3 tools/lm_gate_readings.py [--arch ARCH] [N_TOKEN_SETS]

``ARCH`` defaults to ``chip_smoke.LM_ARCH`` (granite-3-2b); the phase
``lm_mixers`` reads its bounds with ``--arch recurrentgemma_2b``,
``mamba2_130m`` and ``qwen2_moe_a2_7b``.  Token sets: the phase's own
(2, 64) tokens, then ``N_TOKEN_SETS - 1`` more from seeds 1, 2, ...  For
each set it prints one JSON line with ``chip_smoke.logit_errs``'s readings
(``max_rel``, ``rms_rel`` of the prefill logits and of 16 decode steps'
logits) for

  * ``float32`` and ``bfloat16``: the port as it stands (for an MoE config
    also ``routing_flips``: tokens routed to other experts on the card
    than on the CPU, over ``routed_tokens``);
  * ``bf16_vs_f32``: the card's bf16 logits against its float32 logits;
  * ``tf32``: float32 with TF32 products allowed;
  * ``reduced_reduction``: bf16 with cuBLAS's reduced-precision bf16
    reductions allowed;
  * ``no_upcast``: bf16 with every ``Tensor.float()`` of the model a no-op
    (attention scores, softmax, norms, routing and recurrent states left
    in bf16; a product of a float32 and a bf16 operand runs in bf16);

then a ``summary`` line: per metric the largest sound reading and each
fault's smallest, and the last line the card's ``nvidia-smi`` name and
power limit.  About 40 s on one H100 for granite-3-2b.

With ``--train`` it reads gate (a) of phase ``lm_train`` instead::

    python3 tools/lm_gate_readings.py --train [--arch ARCH] [N_TOKEN_SETS]

the card's ``Model.loss`` and gradients against the port's CPU path on
the phase's weights (``chip_smoke.gate_params``), token set ``i`` being
step ``i`` of the synthetic data at ``chip_smoke.LM_TRAIN_GATE_BATCH``,
with ``chip_smoke.grad_errs``'s readings (``loss_rel``, ``grad_max_rel``,
``grad_rms_rel``) for ``float32``, ``bfloat16``, ``bf16_vs_f32``,
``tf32``, ``reduced_reduction`` and ``no_upcast`` as above.
"""
import argparse
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
from repro_torch.models.model_zoo import build_model  # noqa: E402

_PRODUCTS = ("matmul", "__matmul__", "bmm")   # torch.* and Tensor.* alike


class NoUpcast:
    """While active, ``Tensor.float()`` returns its tensor unchanged, and a
    product of operands of two float dtypes runs in the narrower one.  The
    functions are replaced on ``torch`` and ``torch.Tensor`` themselves
    (not through a ``TorchFunctionMode``, which is thread-local), so a
    remat's recompute in the backward pass sees the fault too."""

    def __enter__(self):
        def narrowed(fn):
            def product(a, b, *args, **kwargs):
                if a.dtype != b.dtype:
                    narrow = min((a.dtype, b.dtype),
                                 key=lambda d: torch.finfo(d).bits)
                    a, b = a.to(narrow), b.to(narrow)
                return fn(a, b, *args, **kwargs)
            return product

        self._saved = [(owner, name, getattr(owner, name))
                       for owner in (torch, torch.Tensor)
                       for name in _PRODUCTS if hasattr(owner, name)]
        self._saved.append((torch.Tensor, "float", torch.Tensor.float))
        for owner, name, fn in self._saved[:-1]:
            setattr(owner, name, narrowed(fn))
        torch.Tensor.float = lambda self, *args, **kwargs: self
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)
        return False


def token_sets(vocab: int, n: int):
    rng = np.random.default_rng(cs.LM_SEED)
    rng.integers(0, vocab, 16)         # gate (a)'s prompt, drawn first
    yield "phase", rng.integers(0, vocab, (2, 64)).astype(np.int32)
    for seed in range(1, n):
        yield (f"seed{seed}", np.random.default_rng(seed)
               .integers(0, vocab, (2, 64)).astype(np.int32))


def summarise(rows, sound, faults, metrics) -> dict:
    """Per metric the largest sound reading and each fault's smallest."""
    summary = {dt: {m: max(r[dt][m] for r in rows) for m in metrics}
               for dt in sound}
    for fault in faults:
        summary[fault] = {m: min(r[fault][m] for r in rows) for m in metrics}
    summary["bf16_vs_f32"] = {m: max(r["bf16_vs_f32"][m] for r in rows)
                              for m in metrics}
    return summary


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def train_main(dev, cfg, n_sets: int) -> int:
    """Gate (a) of phase ``lm_train``: loss and gradients, card vs CPU."""
    cut, cut_cfg = cs.gate_params(dev, cfg)
    cut_cpu = cs.cpu_copy(cut)
    cfgs = {dt: dataclasses.replace(cut_cfg, act_dtype=dt)
            for dt in ("float32", "bfloat16")}

    def card(dt, batch, flag=None, mode=None):
        model = build_model(cfgs[dt], device=dev)   # resets both flags
        if flag:
            setattr(torch.backends.cuda.matmul, flag, True)
        try:
            if mode is not None:
                with mode():
                    return cs.loss_and_grads(model, cut, batch)
            return cs.loss_and_grads(model, cut, batch)
        finally:
            build_model(cfgs[dt], device=dev)

    rows = []
    for step in range(n_sets):
        batch, batch_cpu = (cs.gate_batch(cfg, step, dev),
                            cs.gate_batch(cfg, step, "cpu"))
        row, cpu, sound = dict(tokens=f"step{step}"), {}, {}
        t0 = time.perf_counter()
        for dt in cfgs:
            cpu[dt] = cs.loss_and_grads(build_model(cfgs[dt], device="cpu"),
                                        cut_cpu, batch_cpu)
            sound[dt] = card(dt, batch)
            row[dt] = dict(cs.grad_errs(sound[dt], cpu[dt]), loss=sound[dt][0])
        row["bf16_vs_f32"] = cs.grad_errs(sound["bfloat16"], sound["float32"])
        row["tf32"] = cs.grad_errs(card("float32", batch, "allow_tf32"),
                                   cpu["float32"])
        row["reduced_reduction"] = cs.grad_errs(
            card("bfloat16", batch, "allow_bf16_reduced_precision_reduction"),
            cpu["bfloat16"])
        row["no_upcast"] = cs.grad_errs(card("bfloat16", batch, mode=NoUpcast),
                                        cpu["bfloat16"])
        row["s"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
    metrics = list(rows[0]["bf16_vs_f32"])
    print(json.dumps(dict(
        summary=summarise(rows, cfgs, ("tf32", "reduced_reduction",
                                       "no_upcast"), metrics),
        arch=cfg.name, layers=cut_cfg.n_layers, token_sets=len(rows),
        batch=list(cs.LM_TRAIN_GATE_BATCH))), flush=True)
    print(smi())
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_sets", nargs="?", type=int, default=5)
    ap.add_argument("--arch", default=cs.LM_ARCH)
    ap.add_argument("--train", action="store_true",
                    help="read gate (a) of phase lm_train")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lm_gate_readings: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cfg = base.get(args.arch)
    if args.train:
        return train_main(dev, cfg, args.n_sets)
    depth = cs.gate_layers(cfg)
    params = build_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(cs.LM_SEED))
    cut = cs.cut_params(params, depth)
    del params
    torch.cuda.empty_cache()
    steps = cs.LM_DECODE_STEPS
    cfgs = {dt: dataclasses.replace(cfg, n_layers=depth, act_dtype=dt)
            for dt in ("float32", "bfloat16")}
    cut_cpu = cs.cpu_copy(cut)

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
    for name, tokens in token_sets(cfg.vocab, args.n_sets):
        row = dict(tokens=name)
        cpu, cpu_s, sound = {}, {}, {}
        for dt in cfgs:
            t0 = time.perf_counter()
            with cs.MoeProbe() as on_cpu:
                cpu[dt] = cs.lm_logits(build_model(cfgs[dt], device="cpu"),
                                       cut_cpu, tokens, steps)
            cpu_s[dt] = time.perf_counter() - t0
            with cs.MoeProbe() as on_card:
                sound[dt] = card(dt, tokens)
            row[dt] = dict(cs.logit_errs(sound[dt], cpu[dt]),
                           cache_dtype=sound[dt][2])
            if on_card.calls:
                row[dt]["routing_flips"] = on_card.flips(on_cpu)
                row[dt]["routed_tokens"] = sum(
                    c["experts"].shape[0] for c in on_card.calls)
        row["cpu_s"] = cpu_s
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

    metrics = list(rows[0]["bf16_vs_f32"])
    summary = summarise(rows, cfgs, ("tf32", "reduced_reduction",
                                     "no_upcast"), metrics)
    if "routing_flips" in rows[0]["bfloat16"]:
        summary["routing_flips"] = {
            dt: [r[dt]["routing_flips"] for r in rows] for dt in cfgs}
    print(json.dumps(dict(summary=summary, arch=args.arch, layers=depth,
                          token_sets=len(rows), decode_steps=steps)),
          flush=True)
    print(smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
