"""Quickest proof that the PyTorch/CUDA port starts and is right on one GPU.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py

It builds the CUDA tile kernels from ``src/repro_torch/kernels/csrc`` into
``build/repro_torch_kernels/`` (one ``nvcc`` per kernel, all at once), then
runs nineteen phases, each printing JSON lines (each with ``t_s``, the
seconds since the script started, so the time of a phase is the gap
between its lines and the previous phase's):

  1. device    the card's name and power limit (``nvidia-smi``), versions;
  2. build     kernels built and seconds;
  3. small     every stock kernel at s in {1, 2, 4, 8} (all four boundary
               kinds) and a bfloat16 spec, on a small grid (edge blocks
               only) and a larger one (interior blocks at s = 8 too), on
               the default tile and a taller one: ``stencil_cuda`` against
               its plain version on the card, and ``stencil_cuda_batched``
               bitwise against ``stencil_cuda`` per entry.  Then the
               streamed bucket specs of JACOBI2D and SOBEL2D-REPLICATE
               under replicate (halo-index maps) and periodic (wrap maps),
               three entries with different maps, one of them the all-zero
               batch filler, on the default tile and a 16x16 one (tiles
               wholly in the padding): the same checks per round, and the
               round loop (wrap maps consumed between rounds) against its
               plain version;
  4. main      the port's main path at the paper's sizes:
               ``autotune(DSL, device="cuda")`` then ``design.runner`` (K2
               where the ranker picks ``buffer_depth=2``, as it does at
               these sizes; K1 otherwise), with
               the launch counters read around the run, the error against
               the plain version, K1 at the design's (s, tile) against the
               same plain run and bitwise against the design's result
               (not counted), median times and achieved bandwidth,
               then the ranker's prediction against K1's time at every
               fusion depth and tile it ranks for JACOBI2D 4096x4096
               (``sweep``), with the measured time per cell update;
  5. batched   ``build_batched_runner`` with ``buffer_depth=2`` (K2) on a
               batch of 8, bitwise against K1 per entry, and one round at
               s=1 against one ``F.conv2d`` call over the batch (TF32 off),
               timed only as a yardstick;
  6. yardstick JACOBI2D at s=1 against one ``F.conv2d`` call (cuDNN with
               TF32 off), timed only as a yardstick;
  7. serve     bucketed serving at the paper's width: ``StencilServer``
               with a (10240,) x (1024, 1088) bucket ladder serves
               JACOBI2D under zero, constant 25.0, replicate and periodic
               boundaries, 16 iterations, 5 shapes per mode (9720x1024
               and 4 drawn from seed 2022 in [8000, 9720] x [768, 1024]),
               2 requests per shape.  Every result is held bitwise against
               the port's single-shot ``build_bucket_runner`` and within
               tolerance of the plain version of the unpadded spec; one
               line per mode gives launches, flush seconds, grids per
               second and the padded-cell share, and for the most used
               micro-batch one round of K1 launched once per entry
               against one K2 launch (what the ranker's launch term
               prices);
  8. distribute the five SASA parallelisms of ``core/distribute.py`` on a
               pool of 4 logical devices that are all this one card
               (``[cuda] * 4``; every line says ``logical_devices: 4,
               physical_devices: 1``): JACOBI2D, HOTSPOT and
               SOBEL2D-REPLICATE at 9720x1024 and HEAT3D-PERIODIC at
               9720x32x32, 16 iterations, each as spatial_s(k=4),
               spatial_r(k=4), hybrid_s(k=4,s=4), hybrid_r(k=4,s=4) and
               temporal(s=4), held against the plain oracle
               (``kernels/ref.py``) on the card within 2e-4 x max|out|, with
               ms from CUDA events (median of 3 runs; the temporal
               pipeline's one checked run), halo bytes moved and, for
               the row partitions, the model's prediction for 4 H100s
               (its host term and launches too); then a batch of 2
               bitwise against single-grid runs.  The shard path runs no CUDA kernel (as the
               reference's reaches no Pallas kernel): its launch counts
               must read 0;
  9. degraded  hybrid_s(k=4,s=8) on the real pool (this one card): warns,
               reports ``degraded`` on 1 device, runs K1 at s=8 bitwise
               equal to temporal(s=8) K1 on the same tile; under
               ``strict`` it raises;
 10. rank_pool ``autotune`` and ``soda_baseline`` ranked for a pool of 4
               cards (``build=False``), JACOBI2D 9720x1024: the top five
               configurations of each and the best shard design, with
               their predictions; then ``autotune`` built on the pool
               ``[cuda] * 4``, whose design must run the tile kernel;
 11. cold_start ``benchmarks_torch/cold_start.py``'s pair at the paper's
               size: two fresh subprocesses share one empty store, each
               with a private, empty kernel build root; each serves
               JACOBI2D 9720x1024, 16 iterations, through
               ``StencilServer(device="cuda", max_batch=1, store_dir=...)``.
               The cold side must rank and run ``nvcc``; the warm side
               must rank nothing, compile nothing and load the kernel's
               library from the store, with a bitwise equal result (the
               script's correctness gates, hard here).  Each side's time
               to first result (after imports), its breakdown and the
               ratio are printed; the ratio's >= 10x gate is reported;
 12. scheduler phase ``serve``'s 40 requests through ``StencilScheduler``
               over the same server: every result bitwise equal to
               ``serve()``'s, no drop; then the open-loop Poisson trace
               of ``benchmarks/serving_latency.py`` (240 requests at 300
               per second over 4 designs) against the flush baseline:
               grids per second and p50/p99 latency of both, not gated;
 13. router    ``StencilRouter`` with 2 workers (``--device cuda``, both on
               this card) over one fresh store: the second worker
               registers with no ranking, no compile and the library from
               the store; the 40 requests routed, bitwise equal to the
               in-process server's; then the 40 again with the owner of
               one design killed with requests in flight: each is handed
               off and resolves bitwise equal, and ``close()`` drains and
               reaps both workers;
 14. bench     the port's benchmark gates (``benchmarks_torch/``) on the
               card at the reference's full sizes, one script after
               another: ``serving_throughput.py`` (its six sections, the
               cold start in two child processes), ``model_accuracy.py``
               and ``serving_latency.py``; one line per gate with its
               reading, bound and ``held``.  Correctness gates (bitwise,
               drops, failures, buckets, rankings and compiles on the warm
               side, cache hits, strictly fewer launches, launches > 0)
               fail the run; timing gates (the ratios, p99, the rank
               accuracy) are reported.  Then ``benchmarks_torch/run.py
               --device cuda`` once in a child process, skipping the two
               modules just run: its row count, and an ``ERROR`` row
               fails the run;
 15. lm_serve  the LM substrate: ``repro_torch.serve.lm.ServeEngine`` on
               granite-3-2b at full width and depth (40 layers, d_model
               2048, vocab 49155; 2.53 B fp32 masters initialised on the
               card from a seeded generator).  Gates: (a) with float32
               activations, a 16-token request's 4 greedy tokens equal
               re-running prefill on the grown prompt (the smallest top-2
               logit margin is printed); (b) at depth 2, the prefill logits
               and 16 decode steps' logits on the card within
               ``LM_CPU_TOL`` of the port's CPU path on the same weights,
               in float32 and in bf16, the caches in the activations'
               dtype; (c) the traffic (8 requests, prompts of 64-512
               tokens from seed 2022, 64 new tokens, batch 8, cache 1024,
               bf16) twice, bitwise equal, tokens in the vocabulary, and
               the logits of a full-depth prefill and of 4 decode steps at
               batch 8 (``Model.prefill``/``init_cache``/``decode_step``)
               finite.
               It prints init seconds, parameter bytes, peak memory,
               prefill ms, decode ms per step beside the byte bound of
               re-reading the masters, tokens/s and a profile of 4 decode
               steps.  The LM path launches no stencil kernel, and the
               phase checks that K1/K2's counts do not move;
 16. lm_mixers the MoE, SSM and hybrid families through the same checks
               as ``lm_serve``, one line per config, one after another,
               the memory of each freed before the next:
               recurrentgemma-2b (26 layers of RG-LRU and local
               attention), mamba2-130m (24 Mamba-2 SSD layers) and
               qwen2-moe-a2.7b (24 layers of 64 stored experts, top-4,
               and a shared expert), each at full width and at full depth
               where its fp32 masters fit the card beside
               ``LM_HEADROOM_BYTES`` (a cut depth is printed as
               ``reduced``).  Gate (b) runs one pattern group deep (3
               layers for recurrentgemma, 2 for the others), with the
               family's bf16 bounds (``LM_CPU_TOL``) and, for MoE, the
               tokens routed differently on the card and on the CPU;
               gate (a) runs MoE prefill at capacity ``n_experts /
               top_k``, where no token can drop.  For MoE the line also
               gives the served prefill's dropped share at the config's
               capacity;
 17. lm_train  the port's ``repro_torch.train.Trainer`` at full width, one
               line per config, the memory of each freed before the next:
               granite-3-2b (vocabulary 49155: the full-logits loss) and
               recurrentgemma-2b (256000: the chunked cross-entropy, and
               the RG-LRU scan's backward), AdamW over fp32 masters,
               bf16 activations, remat ``"full"``, 6 steps of 8 x 512
               tokens (``LM_TRAIN_TRAFFIC``, seed 2022), at full depth
               where 16 B a parameter fit beside
               ``LM_TRAIN_HEADROOM_BYTES`` (a cut prints as ``reduced``).
               Gates: (a) one pattern group deep, the card's loss and
               gradients against the port's CPU path on the same weights
               and a 2 x 64 batch, float32 within ``LM_TRAIN_TOL`` (with
               the ``tf32`` fault's readings printed and caught), bf16
               gated per config where ``LM_TRAIN_TOL`` has bounds; (b) on
               granite at that depth, 6 straight steps against a run
               crashed at step 3 after its checkpoint (under
               ``build/lm_train_ckpt``, deleted after) and resumed, params
               and losses within 1e-6 (the reference's contract), bitwise
               equality printed; (c) at full depth the last loss is below
               the first.  It prints init s, master and optimizer-state
               bytes, peak memory, step ms (median of the steps after the
               first) and tokens/s beside the step's FLOP bound, the
               optimizer's ms beside its byte bound, checkpoint save and
               restore s, and a profiled step's launches and busy share.
               Training launches no stencil kernel, and the phase checks
               that K1/K2's counts do not move.
 18. lm_launch the sharded layer (``repro_torch.launch``, ``roofline``),
               one line per part: (1) ``python -m repro_torch.launch.train
               --arch granite_3_2b --steps 4 --batch 8 --seq 512`` at full
               width and depth, its ``done:`` losses and step ms; (2) the
               sharded ``Trainer`` on a 1x1 NCCL mesh (a world of one over
               a localhost store) training granite-3-2b at full width and
               depth for 3 float32 steps, within ``LM_TRAIN_TOL``'s
               float32 bounds of the unsharded ``Trainer``: the first
               step's gradients, the losses, the parameters after the
               steps (bitwise equality printed); (3) qwen2-moe-a2.7b's prefill through
               ``moe_apply_ep`` on that mesh, full width, one pattern
               group deep, float32 logits within ``LM_CPU_TOL`` of the
               dense dispatch; (4) the dry-run cells ``LM_LAUNCH_CELLS`` on
               torch's ``fake`` backend (256 and 512 ranks) in a child
               process with no card in view, started first so it runs
               while the card trains: per-rank peak memory against the
               card's, and the compute, memory and collective terms at the
               H100's numbers; (5) ``analyze_step`` of (1)'s step: the
               counted FLOPs beside the analytic bound and the compute
               term's share of the measured step.  Any failure fails the
               run; the sharded path launches no stencil kernel;
 19. examples  each of the port's six examples (``examples_torch/``,
               ``EXAMPLES``) on the card with its default device, all
               six at once, each in a process of its own
               (``chip_smoke.py --example-child``, which also reports the
               tile kernels' launch counts of its run): one line per
               example with its wall time and its own check, read from
               what it printed: quickstart's max |err| against the oracle
               within the tolerance ``numerics.tolerance_for`` certifies;
               serve_stencils bitwise equal to single-shot ``serve()`` in
               all four parts and a warm replica that ranks nothing and
               compiles nothing; stencil_multidevice ``correct=True`` for
               all four configs; train_lm at ``--preset 100m --steps 30``
               with a falling loss (checkpoints under ``build/examples``,
               deleted after); serve_lm generating tokens; elastic_restart
               restoring identical parameters.  The three stencil examples
               must launch a tile kernel (K1 or K2, as their designs
               chose).

Then one JSON line lists every kernel with its launches (from phases
``main`` and ``bench``, each run with the counts set to 0 just before it
and read just after; ``launches_by_phase`` gives both), error and times,
and the last line is ``{"ok": true, "device": {...}}``.  Any failure
raises, so the exit code is non-zero and no result line is printed.
Imports nothing of JAX and nothing of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

TOL = {"float32": 2e-4, "bfloat16": 2e-2}   # tests/test_kernels.py::tol
SMALL_2D, SMALL_3D = (100, 77), (21, 13, 40)
# grids with interior blocks at s = 8 (windows wholly inside the grid)
LARGER_2D, LARGER_3D = (200, 150), (37, 40, 41)
SMALL_S = (1, 2, 4, 8)
TALL_ROWS = {2: 64, 3: 16}   # the non-default tile row extent checked
MAIN_CASES = [  # (stock kernel, shape); 16 iterations each
    ("jacobi2d", (9720, 1024)),
    ("jacobi2d", (4096, 4096)),
    ("hotspot", (9720, 1024)),
    ("blur_jacobi2d", (9720, 1024)),
    ("sobel2d_replicate", (9720, 1024)),
    ("heat3d_periodic", (9720, 32, 32)),
]
ITERATIONS = 16
# benchmarks/serving_throughput.py::BOUNDARY_DSL (copied: the port imports
# nothing of the JAX package's tree)
BOUNDARY_DSL = """
kernel: JACOBI2D_{tag}
iteration: {it}
boundary: {boundary}
input float: in_1({r}, {c})
output float: out_1(0,0) = (in_1(0,1) + in_1(1,0) + in_1(0,0)
    + in_1(0,-1) + in_1(-1,0)) / 5
"""
DIST_CASES = [  # (stock kernel, shape) of phase distribute; 16 iterations
    ("jacobi2d", (9720, 1024)),
    ("hotspot", (9720, 1024)),
    ("sobel2d_replicate", (9720, 1024)),
    ("heat3d_periodic", (9720, 32, 32)),   # 9720 = 4 x 2430: periodic fits
]
DIST_POOL = 4
# the cold-start replica's kernel: JACOBI2D at the paper's 9720x1024
COLD_DSL = BOUNDARY_DSL.format(tag="COLDSTART", it=ITERATIONS,
                               boundary="zero", r=9720, c=1024)
SERVE_MODES = ["zero", "constant 25.0", "replicate", "periodic"]
SERVE_LADDER = ((10240,), (1024, 1088))
SERVE_SHAPES, SERVE_REPEATS = 5, 2
STREAMED_BUCKET_PAD = 24   # small streamed specs: bucket = grid + this
BF16_DSL = """
kernel: J2D_BF16
iteration: 2
input bfloat16: x(16, 24)
output bfloat16: y(0,0) = (x(0,1) + x(1,0) + x(0,0) + x(0,-1) + x(-1,0)) / 5
"""

# phases lm_serve and lm_mixers: each config at full width (and depth,
# unless the card cannot hold it), random weights from a seeded generator
# on the card, and the traffic below in the config's bf16; gate (b) holds
# the card's prefill logits and LM_DECODE_STEPS decode steps' logits, cut
# to one pattern group (at least 2 layers), to the port's CPU path on the
# same weights and tokens, in float32 and in bf16, within LM_CPU_TOL:
# ``max_rel`` is max|card - cpu| / max|cpu|, ``rms_rel`` ||card - cpu|| /
# ||cpu||.  The bounds lie between the largest sound reading and the
# smallest reading with a fault injected, over 5 token sets of
# tools/lm_gate_readings.py --arch on an H100 (PERF.md): float32 read
# <= 3.6e-6 for every family, with TF32 products >= 6.9e-4; bf16 rms
# (prefill, decode) read <= (8.2e-3, 7.1e-3) for granite-3-2b, (1.11e-2,
# 1.14e-2) for recurrentgemma-2b and (5.4e-3, 3.9e-3) for mamba2-130m,
# with every upcast dropped (``no_upcast``) >= (1.58e-2, 1.31e-2),
# (2.08e-2, 2.14e-2) and (1.16e-2, 1.18e-2).  qwen2-moe-a2.7b has no bf16
# bound: 2-16 of 320 tokens route to other experts on the card than on
# the CPU in bf16 (0 in float32), so its sound bf16 readings (rms up to
# 5.6e-2) overlap the faulty ones (from 2.4e-2); its bf16 path is held by
# gate (c), its readings and flips are printed.
LM_ARCH = "granite_3_2b"
LM_MIXER_ARCHS = ("recurrentgemma_2b", "mamba2_130m", "qwen2_moe_a2_7b")
LM_SEED = 2022
LM_TRAFFIC = dict(batch_size=8, cache_len=1024, requests=8, prompt_min=64,
                  prompt_max=512, max_new_tokens=64)
LM_DECODE_STEPS = 16
LM_CPU_TOL = {
    "float32": dict(prefill_max_rel=1e-4, decode_max_rel=1e-4),
    "bfloat16": {
        "granite_3_2b": dict(prefill_rms_rel=1.1e-2, decode_rms_rel=1.0e-2),
        "recurrentgemma_2b": dict(prefill_rms_rel=1.5e-2,
                                  decode_rms_rel=1.55e-2),
        "mamba2_130m": dict(prefill_rms_rel=8e-3, decode_rms_rel=7e-3),
    },
}
LM_HEADROOM_BYTES = 12e9   # activations, bf16 weight copies, caches, logits
H100_BF16_FLOPS = 989e12   # NVIDIA data sheet, dense
# phase lm_train: the port's Trainer at full width, AdamW with fp32
# masters, bf16 activations, remat "full"; pre-training micro-batches of a
# chat-length context (4096 tokens a step).  Gate (a) holds the card's
# loss and gradients to the port's CPU path one pattern group deep on
# LM_TRAIN_GATE_BATCH: ``loss_rel`` |loss - cpu| / |cpu|, ``grad_max_rel``
# the largest |grad - cpu| of any leaf over the tree's largest |cpu|,
# ``grad_rms_rel`` over the whole tree.  Readings over 5 token sets of
# tools/lm_gate_readings.py --train on an H100 (PERF.md): float32 sound
# loss <= 8.8e-8, gradients max <= 4.0e-6, with TF32 products gradients
# >= 1.38e-3 (the phase checks that its gradient bound catches tf32) but
# loss only >= 2.3e-7: the mean over 126 tokens averages the products'
# rounding out, so the loss bound (the reference's 1e-5) cannot see TF32.
# bf16 (sound; every upcast dropped, ``no_upcast``): granite-3-2b loss
# <= 2.19e-5 (>= 2.9e-4), gradient rms <= 1.14e-2 (>= 2.17e-2);
# recurrentgemma-2b gradient rms <= 1.58e-2 (>= 2.97e-2), its loss
# readings overlap (sound up to 9.0e-6, no_upcast from 3.4e-6).
LM_TRAIN_ARCHS = ("granite_3_2b", "recurrentgemma_2b")
LM_TRAIN_TRAFFIC = dict(steps=6, batch=8, seq=512, lr=3e-4, warmup=2)
LM_TRAIN_GATE_BATCH = (2, 64)
LM_TRAIN_TOL = {
    "float32": dict(loss_rel=1e-5, grad_max_rel=1e-4),
    "bfloat16": {
        "granite_3_2b": dict(loss_rel=1e-4, grad_rms_rel=1.6e-2),
        "recurrentgemma_2b": dict(grad_rms_rel=2.2e-2),
    },
}
# 16 B a parameter live beside this: the remat's recomputed group, the
# loss's logits or chunks, the optimizer's temporaries of the largest leaf
LM_TRAIN_HEADROOM_BYTES = 20e9
# phase lm_launch: the sharded layer.  (1) the train CLI at full width and
# depth; (2) the sharded Trainer on a 1x1 NCCL mesh against the unsharded
# one in float32, within lm_train's gate (a) float32 bounds (loss_rel; the
# first step's gradients' grad_max_rel, which alone sees a wrong gradient
# scale, AdamW's update being blind to one; and grad_max_rel read as the
# parameters' largest difference after the steps
# over the tree's largest |parameter|); (3) qwen2-moe-a2.7b's prefill
# through the expert-parallel dispatch on that mesh against the dense one
# (LM_CPU_TOL's float32 prefill bound), one pattern group deep; (4) the
# dry-run cells on the fake backend in a child process; (5) the counted
# FLOPs of (1)'s step.
LM_LAUNCH_CLI = ("--arch", "granite_3_2b", "--steps", "4", "--batch", "8",
                 "--seq", "512")
LM_LAUNCH_MESH_TRAFFIC = dict(steps=3, batch=8, seq=512, lr=3e-4, warmup=2)
LM_LAUNCH_EP_BATCH = (8, 256)
LM_LAUNCH_CELLS = (("mamba2_130m", "decode_32k", False),
                   ("internlm2_1_8b", "decode_32k", True),
                   ("granite_3_2b", "train_4k", False))
# phase examples: each of the port's examples (examples_torch/) on the
# card with its default device, as a process of its own, and the
# arguments it is run with; train_lm at the 100m preset for 30 steps, its
# checkpoints in a fresh directory under build/ (deleted after)
EXAMPLES = (("quickstart", ()), ("serve_stencils", ()),
            ("stencil_multidevice", ()),
            ("train_lm", ("--preset", "100m", "--steps", "30")),
            ("serve_lm", ()), ("elastic_restart", ()))
STENCIL_EXAMPLES = ("quickstart", "serve_stencils", "stencil_multidevice")


START = time.perf_counter()


def emit(**fields) -> None:
    if "phase" in fields:
        fields["t_s"] = round(time.perf_counter() - START, 1)
    print(json.dumps(fields), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def lm_cpu_tol(arch: str, dt: str) -> dict:
    """Gate (b)'s bounds for ``arch`` in activation dtype ``dt`` (empty:
    only the logits' finiteness and the cache dtype are held)."""
    tol = LM_CPU_TOL[dt]
    return tol if dt == "float32" else tol.get(arch, {})


def gate_layers(cfg) -> int:
    """Gate (b)'s depth: one pattern group, at least 2 layers."""
    return max(2, len(cfg.pattern))


class MoeProbe:
    """While active, every MoE layer's dispatch is recorded: its dropped
    share (``moe_apply``'s ``return_aux``) and the sorted experts of each
    token.  The layer's output is unchanged."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        import torch

        from repro_torch.models import mixers

        apply = self._apply = mixers.moe_apply

        def probe(x, p, **kw):
            y, aux = apply(x, p, **dict(kw, return_aux=True))
            E = p["router"].shape[1]
            logits = x.reshape(-1, x.shape[-1]).float() @ p["router"].float()
            n_real = kw.get("n_experts_real") or E
            logits[:, n_real:] = -1e30
            experts = torch.topk(logits, kw["top_k"], dim=-1).indices
            self.calls.append(dict(
                dropless=kw.get("dropless", False),
                dropped_frac=float(aux["dropped_frac"]),
                experts=experts.sort(-1).values.cpu()))
            return y

        mixers.moe_apply = probe
        return self

    def __exit__(self, *exc):
        from repro_torch.models import mixers

        mixers.moe_apply = self._apply
        return False

    def flips(self, other: "MoeProbe") -> int:
        """Tokens whose expert set differs from ``other``'s, same calls."""
        check(len(self.calls) == len(other.calls), "MoeProbe: call counts")
        return sum(int((a["experts"] != b["experts"]).any(-1).sum())
                   for a, b in zip(self.calls, other.calls))


def lm_logits(model, params, tokens, steps):
    """Prefill logits of ``tokens`` (B,S) and the logits of ``steps`` decode
    steps from an empty cache fed ``tokens[:, :steps]``, as float32 on the
    CPU, with the dtype of the first block's prefill cache (its k, or the
    conv state of a recurrent block)."""
    import torch

    pre, caches = model.prefill(params, {"tokens": tokens})
    first = caches[0]["k"] if "k" in caches[0] else caches[0]["conv"]
    cache_dtype = str(first.dtype).removeprefix("torch.")
    B = tokens.shape[0]
    caches = model.init_cache(B, steps)
    dec = []
    for t in range(steps):
        pos = torch.full((B,), t, dtype=torch.int32, device=model.device)
        logits, caches = model.decode_step(params, tokens[:, t:t + 1],
                                           caches, pos)
        dec.append(logits)
    return pre.float().cpu(), torch.stack(dec, 1).float().cpu(), cache_dtype


def logit_errs(got, ref) -> dict:
    """``max_rel`` (max|got - ref| / max|ref|) and ``rms_rel``
    (||got - ref|| / ||ref||) of the prefill and of the decode logits of two
    :func:`lm_logits` results."""
    out = {}
    for name, g, r in zip(("prefill", "decode"), got, ref):
        d = (g - r).abs()
        out[f"{name}_max_rel"] = float(d.max() / r.abs().max())
        out[f"{name}_rms_rel"] = float(d.norm() / r.norm())
    return out


def cpu_copy(tree):
    """A copy of a ``ParamTree`` on the CPU, leaf by leaf (nothing is
    copied on the card)."""
    import torch

    from repro_torch.models import layers as L

    def walk(m):
        if isinstance(m, torch.nn.ModuleList):
            return [walk(v) for v in m]
        out = {n: t.detach().cpu() for n, t in m._parameters.items()}
        out.update((n, walk(v)) for n, v in m._modules.items())
        return out

    return L.ParamTree(walk(tree))


def cut_params(params, n_layers: int):
    """The first ``n_layers`` blocks of ``params`` with its embeddings and
    final norm (shared, not copied)."""
    from repro_torch.models import layers as L

    tree = {"embed": params["embed"], "ln_f": params["ln_f"],
            "layers": [params["layers"][i] for i in range(n_layers)]}
    if "unembed" in params:
        tree["unembed"] = params["unembed"]
    return L.ParamTree(tree)


def lm_vs_cpu(dev, cfg, params, tokens, steps) -> dict:
    """``cfg``'s model on ``dev`` against the port's CPU path on a copy of
    ``params``: :func:`logit_errs`, whether the card's logits are finite,
    the card's cache dtype, and for MoE the tokens routed to other experts
    on the card than on the CPU."""
    import torch

    from repro_torch.models.model_zoo import build_model

    with MoeProbe() as on_card:
        card = lm_logits(build_model(cfg, device=dev), params, tokens, steps)
    with MoeProbe() as on_cpu:
        cpu = lm_logits(build_model(cfg, device="cpu"), cpu_copy(params),
                        tokens, steps)
    out = dict(finite=bool(torch.isfinite(card[0]).all()
                           and torch.isfinite(card[1]).all()),
               cache_dtype=card[2], **logit_errs(card[:2], cpu[:2]))
    if on_card.calls:
        out["routing_flips"] = on_card.flips(on_cpu)
        out["routed_tokens"] = sum(c["experts"].shape[0]
                                   for c in on_card.calls)
    return out


def lm_depth(cfg, dev, bytes_per_param: int = 4,
             headroom: float = LM_HEADROOM_BYTES) -> int:
    """The most layers of ``cfg`` whose ``bytes_per_param`` bytes a
    parameter (4: fp32 masters; 16: masters, gradients and AdamW's two
    moments), with ``headroom`` beside them, fit in the card's free
    memory.  Blocks are counted by initialising one pattern group on the
    card."""
    import torch

    from repro_torch.models import transformer as T

    gen = torch.Generator(device=dev).manual_seed(0)
    group = [sum(t.numel() for t in _leaves(T.block_init(gen, cfg, kind)))
             for kind in cfg.pattern]
    torch.cuda.empty_cache()
    fixed = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    free = torch.cuda.mem_get_info(dev)[0] - headroom
    n = 0
    while (n < cfg.n_layers
           and bytes_per_param * (fixed + sum(group[i % len(group)]
                                              for i in range(n + 1)))
           <= free):
        n += 1
    return n


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def product_params(cfg, params) -> int:
    """The parameters that a token's forward multiplies (2 operations
    each): every matrix but the convolutions and biases, the unembedding
    but not an untied embedding (a lookup), and of an MoE layer's experts
    only the ``top_k`` routed."""
    n = sum(p.numel() for name, p in params.named_parameters()
            if p.dim() >= 2 and name.rsplit(".", 1)[-1]
            not in ("conv_w", "bq", "bk", "bv"))
    if not cfg.tie_embeddings:
        n -= cfg.vocab * cfg.d_model
    kinds = [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]
    n_moe = sum(k.endswith("_moe") for k in kinds)
    return n - n_moe * (cfg.n_experts_padded - cfg.top_k) * 3 \
        * cfg.d_model * cfg.d_ff_expert


def attention_ops(cfg, B: int, S: int) -> int:
    """The score and PV products of one forward over ``B`` sequences of
    ``S`` tokens: the causal pairs (window-limited for local attention)."""
    kinds = [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.n_layers)]
    pairs = sum(sum(min(q + 1, cfg.window) if k == "local" else q + 1
                    for q in range(S))
                for k in kinds if k in ("attn", "attn_moe", "local"))
    return 4 * B * cfg.n_heads * cfg.d_head * pairs


def lm_serve(dev, cfg, traffic: dict, hbm_bw: float, kernel_launches) -> dict:
    """``ServeEngine`` on ``cfg`` at its full size with random weights
    initialised on ``dev``; gates (a)-(c) raise.  Phase ``lm_serve`` runs
    it on granite-3-2b, phase ``lm_mixers`` on each of LM_MIXER_ARCHS."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve.lm import Request, ServeEngine

    name = cfg.name
    launches_before = kernel_launches()
    rng = np.random.default_rng(LM_SEED)
    model = build_model(cfg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(LM_SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    check(all(p.dtype == torch.float32 for p in params.parameters()),
          f"{name}: the masters are not float32")

    def top2_margin(logits) -> float:
        top = torch.topk(logits.float(), 2, dim=-1).values
        return float((top[..., 0] - top[..., 1]).min())

    # (a) decode equals repeated prefill, float32 activations, full size; an
    # MoE prefill with capacity n_experts/top_k drops no token (an expert
    # can take every token), as the dropless decode does
    cfg32 = dataclasses.replace(cfg, act_dtype="float32")
    if cfg.n_experts:
        cfg32 = dataclasses.replace(
            cfg32, capacity_factor=cfg.n_experts / cfg.top_k)
    model32 = build_model(cfg32, device=dev)
    prompt = rng.integers(0, cfg.vocab, 16).astype(np.int32)
    got = ServeEngine(model32, params, batch_size=1, cache_len=32).generate(
        [Request(prompt=prompt, max_new_tokens=4)])[0]
    seq, margins = list(prompt), []
    with MoeProbe() as probe_a:
        for _ in range(4):
            logits, _ = model32.prefill(params, {"tokens": np.asarray([seq])})
            margins.append(top2_margin(logits))
            seq.append(int(torch.argmax(logits[0])))
    dropped_a = max((c["dropped_frac"] for c in probe_a.calls), default=0.0)
    gate_a = [int(t) for t in got] == seq[len(prompt):] and dropped_a == 0
    check(gate_a, f"{name} (a): decode gave {list(got)}, repeated "
                  f"prefill {seq[len(prompt):]} (top-2 margins {margins}, "
                  f"prefill dropped share {dropped_a})")

    # (b) the card against the port's CPU path on the same weights, one
    # pattern group deep, in float32 and in the config's dtype
    depth_b = gate_layers(cfg)
    cut = cut_params(params, depth_b)
    tokens = rng.integers(0, cfg.vocab, (2, 64)).astype(np.int32)
    gate_b = {}
    for dt in dict.fromkeys(("float32", cfg.act_dtype)):
        got_b = lm_vs_cpu(dev, dataclasses.replace(cfg, n_layers=depth_b,
                                                  act_dtype=dt),
                          cut, tokens, LM_DECODE_STEPS)
        tol = lm_cpu_tol(name, dt)
        check(got_b["finite"] and got_b["cache_dtype"] == dt
              and all(got_b[k] <= tol[k] for k in tol),
              f"{name} (b) {dt}: card vs CPU {got_b}, bounds {tol}")
        gate_b[dt] = dict(got_b, tol=tol or "none (finite, cache dtype)")
    del cut

    # (c) the traffic in the config's dtype: two runs, bitwise equal
    lens = rng.integers(traffic["prompt_min"], traffic["prompt_max"] + 1,
                        traffic["requests"])
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                    max_new_tokens=traffic["max_new_tokens"]) for n in lens]
    engine = ServeEngine(model, params, batch_size=traffic["batch_size"],
                         cache_len=traffic["cache_len"])
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.generate(reqs)
        wall = time.perf_counter() - t0
        runs.append(dict(engine.timing, wall_s=wall,
                         tokens=sum(len(o) for o in out), out=out))
    peak_bytes = torch.cuda.max_memory_allocated()
    bitwise = all(np.array_equal(a, b)
                  for a, b in zip(runs[0]["out"], runs[1]["out"]))
    in_range = all(o.min() >= 0 and o.max() < cfg.vocab for o in runs[1]["out"])
    # the full-depth logits through the model's own entry points: prefill
    # of the served batch (the engine's left padding; for MoE its dropped
    # share at the config's capacity), then decode steps from an empty
    # cache at the engine's batch and cache length (profiled: not gated,
    # the profiler may see no device activity on some hosts)
    B, S = traffic["batch_size"], max(lens)
    prompts = np.stack([np.pad(r.prompt, (S - len(r.prompt), 0))
                        for r in reqs])
    with MoeProbe() as probe_c:
        logits, _ = model.prefill(params, {"tokens": prompts})
    caches = model.init_cache(B, traffic["cache_len"])
    tok = torch.argmax(logits, -1)[:, None]
    steps, step_logits = 4, []
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for t in range(steps):
            pos = torch.full((B,), S + t, dtype=torch.int32, device=dev)
            logits_t, caches = model.decode_step(params, tok, caches, pos)
            step_logits.append(logits_t)
            tok = torch.argmax(logits_t, -1)[:, None]
        b.record()
        b.synchronize()
    finite = bool(torch.isfinite(logits).all()
                  and torch.isfinite(torch.stack(step_logits)).all())
    check(bitwise and in_range and finite,
          f"{name} (c): bitwise {bitwise}, tokens in range {in_range}, "
          f"logits finite {finite}")
    window_ms = a.elapsed_time(b)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    profile = (dict(kernels_per_step=len(kernels) / steps,
                    device_busy_share=busy_ms / window_ms,
                    ms_per_step=window_ms / steps)
               if kernels else "not measured")

    # bounds: decode re-reads every fp32 master; prefill's operations are
    # the products over every prompt position (logits at all of them, as the
    # reference computes; an MoE layer's routed experts only) and the causal
    # attention pairs (window-limited for local attention), at the bf16 rate
    decode_bound_ms = param_bytes / hbm_bw * 1e3
    prefill_ops = 2 * product_params(cfg, params) * B * S \
        + attention_ops(cfg, B, S)
    prefill_bound_ms = max(param_bytes / hbm_bw,
                           prefill_ops / H100_BF16_FLOPS) * 1e3
    check(kernel_launches() == launches_before,
          f"{name}: the LM path launched a stencil kernel")
    last = runs[1]
    out = dict(
        arch=name, layers=cfg.n_layers, d_model=cfg.d_model,
        act_dtype=cfg.act_dtype, params=n_params, param_bytes=param_bytes,
        init_s=init_s, requests=len(reqs), prompt_lens=[int(n) for n in lens],
        batch_size=B, cache_len=traffic["cache_len"],
        max_new_tokens=traffic["max_new_tokens"],
        prefill_ms=last["prefill_ms"],
        decode_ms_per_step=last["decode_ms"] / last["decode_steps"],
        generate_s=last["wall_s"], tokens_per_s=last["tokens"] / last["wall_s"],
        first_run=dict(prefill_ms=runs[0]["prefill_ms"],
                       decode_ms_per_step=runs[0]["decode_ms"]
                       / runs[0]["decode_steps"], generate_s=runs[0]["wall_s"]),
        peak_bytes=peak_bytes, decode_bound_ms=decode_bound_ms,
        decode_bound_by="bytes", prefill_bound_ms=prefill_bound_ms,
        decode_profile=profile,
        gate_a=dict(tokens=seq[len(prompt):], min_top2_margin=min(margins)),
        gate_b=dict(layers=depth_b, tokens=list(tokens.shape),
                    decode_steps=LM_DECODE_STEPS, **gate_b),
        gate_c=dict(bitwise=bitwise, in_range=in_range, finite=finite,
                    min_top2_margin=top2_margin(logits)),
        stencil_kernel_launches=kernel_launches() - launches_before,
    )
    if cfg.n_experts:
        out["gate_a"].update(capacity_factor=cfg32.capacity_factor,
                             prefill_dropped_frac=dropped_a)
        drops = [c["dropped_frac"] for c in probe_c.calls]
        out["prefill_dropped_frac"] = dict(
            capacity_factor=cfg.capacity_factor, mean=sum(drops) / len(drops),
            max=max(drops), layers=len(drops))
    return out


def lm_mixers(dev, traffic: dict, hbm_bw: float, kernel_launches):
    """Phase ``lm_mixers``: :func:`lm_serve` on each of LM_MIXER_ARCHS in
    turn, the memory of each freed before the next.  A config whose full
    depth does not fit runs at the depth that does (``reduced`` says so);
    its width is never cut.  Yields one result per config."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs import base as arch_configs

    for arch in LM_MIXER_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        cfg = arch_configs.get(arch)
        depth = lm_depth(cfg, dev)
        check(depth >= gate_layers(cfg), f"{arch}: {depth} layers fit")
        reduced = None
        if depth < cfg.n_layers:
            reduced = dict(n_layers=[cfg.n_layers, depth],
                           why="fp32 masters beside LM_HEADROOM_BYTES "
                               "exceed the card's free memory")
            cfg = dataclasses.replace(cfg, n_layers=depth)
        t0 = time.perf_counter()
        got = lm_serve(dev, cfg, traffic, hbm_bw, kernel_launches)
        yield dict(got, reduced=reduced, phase_s=time.perf_counter() - t0)


def device_us(evt) -> float:
    """A profiler average's own device time (the attribute's name differs
    across torch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def loss_and_grads(model, params, batch):
    """``model.loss`` of ``batch`` and the gradient of every parameter,
    as a float and float32 CPU tensors keyed by path (zeros for a
    parameter the loss does not use)."""
    import torch

    from repro_torch.models import layers as L

    named = L.named_leaves(params.requires_grad_())
    loss = model.loss(params, batch)
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    return float(loss.detach()), {
        k: (torch.zeros_like(p) if g is None else g).float().cpu()
        for (k, p), g in zip(named.items(), grads)}


def first_step_grads(trainer, sink: dict):
    """``trainer``, its optimizer wrapped so that the first update's
    gradients (whole, float32, on the host) land in ``sink``."""
    import dataclasses

    update = trainer.optimizer.update

    def first(grads, *a, **kw):
        if not sink:
            for k, g in grads.items():
                if g is not None:
                    if hasattr(g, "full_tensor"):
                        g = g.full_tensor()
                    sink[k] = g.detach().float().cpu()
        return update(grads, *a, **kw)

    trainer.optimizer = dataclasses.replace(trainer.optimizer, update=first)
    return trainer


def grad_errs(got, ref) -> dict:
    """Two :func:`loss_and_grads` results: ``loss_rel`` (|loss - ref| /
    |ref|), ``grad_max_rel`` (the largest |grad - ref| of any leaf over
    the largest |ref| of the whole tree) and ``grad_rms_rel`` (||grad -
    ref|| / ||ref|| over the whole tree)."""
    (loss, grads), (ref_loss, ref_grads) = got, ref
    d2 = sum(float(((grads[k] - r).double() ** 2).sum())
             for k, r in ref_grads.items())
    r2 = sum(float((r.double() ** 2).sum()) for r in ref_grads.values())
    return dict(
        loss_rel=abs(loss - ref_loss) / abs(ref_loss),
        grad_max_rel=max(float((grads[k] - r).abs().max())
                         for k, r in ref_grads.items())
        / max(float(r.abs().max()) for r in ref_grads.values()),
        grad_rms_rel=math.sqrt(d2 / r2))


def gate_batch(cfg, step: int, device):
    """Gate (a)'s batch: step ``step`` of the synthetic data at
    ``LM_TRAIN_GATE_BATCH``, seed ``LM_SEED``."""
    from repro_torch.data import SyntheticLMData

    B, S = LM_TRAIN_GATE_BATCH
    return SyntheticLMData(vocab=cfg.vocab, batch=B, seq=S, seed=LM_SEED,
                           device=device).batch_at(step)


def gate_params(dev, cfg):
    """``cfg``'s first :func:`gate_layers` layers at full width, from the
    phases' seeded generator on the card (the first layers of the
    full-depth init: its embedding and blocks are drawn in order)."""
    import dataclasses

    import torch

    from repro_torch.models.model_zoo import build_model

    cut = dataclasses.replace(cfg, n_layers=gate_layers(cfg))
    return build_model(cut, device=dev).init(
        torch.Generator(device=dev).manual_seed(LM_SEED)), cut


def lm_train(dev, cfg, hbm_bw: float, build_dir: Path, kernel_launches,
             crash_resume: bool) -> dict:
    """The port's ``Trainer`` on ``cfg`` at full width on ``dev``: gates
    (a) card vs CPU loss and gradients one pattern group deep, (b) with
    ``crash_resume``, a crash and resume at that depth equal to a straight
    run, (c) at the depth that fits, the loss falls; any failure raises.
    Phase ``lm_train`` runs it on each of LM_TRAIN_ARCHS."""
    import dataclasses
    import gc
    import statistics

    import numpy as np
    import torch

    from repro_torch.checkpoint import (
        latest_step,
        restore_checkpoint,
        save_checkpoint,
    )
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train import TrainConfig, Trainer

    name = cfg.name
    launches_before = kernel_launches()

    # (a) the card against the CPU on the same weights and batch, one
    # pattern group deep: float32 gated, with the tf32 fault's readings
    # beside the bounds; bf16 gated where LM_TRAIN_TOL has its bounds
    cut, cut_cfg = gate_params(dev, cfg)
    cut_cpu = cpu_copy(cut)
    batch, batch_cpu = gate_batch(cfg, 0, dev), gate_batch(cfg, 0, "cpu")
    gate_a = {}
    for dt in dict.fromkeys(("float32", cfg.act_dtype)):
        c = dataclasses.replace(cut_cfg, act_dtype=dt)
        cpu = loss_and_grads(build_model(c, device="cpu"), cut_cpu, batch_cpu)
        model = build_model(c, device=dev)
        got = grad_errs(loss_and_grads(model, cut, batch), cpu)
        tol = LM_TRAIN_TOL[dt].get(name, {}) if dt != "float32" \
            else LM_TRAIN_TOL[dt]
        if dt == "float32":
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                tf32 = grad_errs(loss_and_grads(model, cut, batch), cpu)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            got["tf32"] = tf32
            check(tf32["grad_max_rel"] > tol["grad_max_rel"],
                  f"{name} (a): the bounds {tol} do not catch tf32 {tf32}")
        check(all(math.isfinite(v) for v in got.values()
                  if isinstance(v, float))
              and all(got[k] <= tol[k] for k in tol),
              f"{name} (a) {dt}: card vs CPU {got}, bounds {tol}")
        gate_a[dt] = dict(got, tol=tol or "none (readings printed)")
    del cut, cut_cpu, model
    gc.collect()
    torch.cuda.empty_cache()

    traffic = dict(LM_TRAIN_TRAFFIC, seed=LM_SEED, log_every=10 ** 9)

    def params_cpu(state):
        return {k: p.detach().cpu() for k, p in
                state["params"].named_parameters()}

    # (b) crash and resume at gate (a)'s depth: 6 straight steps (twice:
    # are two runs bitwise?), then a crash at step 3 after the checkpoint
    # of step 3, and a resume to step 6; the checkpoints live under
    # build_dir and are deleted after
    gate_b = None
    if crash_resume:
        model = build_model(cut_cfg, device=dev)
        straight = []
        for _ in range(2):
            state, losses = Trainer(model, TrainConfig(**traffic)).run()
            straight.append((params_cpu(state), losses))
            del state
        shutil.rmtree(build_dir, ignore_errors=True)
        try:
            crashy = Trainer(model, TrainConfig(
                **traffic, ckpt_dir=str(build_dir), ckpt_every=3,
                fail_at_step=3))
            try:
                crashy.run()
                crashed = False
            except RuntimeError as e:
                crashed = "injected failure at step 3" in str(e)
            check(crashed and latest_step(str(build_dir)) == 3,
                  f"{name} (b): no crash at step 3 after its checkpoint")
            state, losses = Trainer(model, TrainConfig(
                **traffic, ckpt_dir=str(build_dir), ckpt_every=3)).run()
            resumed = params_cpu(state)
            want, want_losses = straight[0]
            close = all(torch.allclose(resumed[k], w, rtol=1e-6, atol=1e-6)
                        for k, w in want.items()) and np.allclose(
                losses, want_losses[3:], rtol=1e-6, atol=1e-6)
            check(close and len(losses) == 3,
                  f"{name} (b): resumed losses {losses}, straight "
                  f"{want_losses}")
            # one save and restore of the whole state, timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = save_checkpoint(str(build_dir), 99, state)
            save_s = time.perf_counter() - t0
            nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
            t0 = time.perf_counter()
            restore_checkpoint(str(build_dir), 99, state)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
        finally:
            shutil.rmtree(build_dir, ignore_errors=True)
        gate_b = dict(
            layers=cut_cfg.n_layers, steps=traffic["steps"], crash_at=3,
            losses_straight=want_losses, losses_resumed=losses,
            resumed_bitwise=all(torch.equal(resumed[k], w)
                                for k, w in want.items())
            and losses == want_losses[3:],
            straight_repeat_bitwise=straight[0][1] == straight[1][1] and all(
                torch.equal(straight[1][0][k], w) for k, w in want.items()),
            checkpoint_bytes=nbytes, save_s=save_s, restore_s=restore_s)
        del model, state, straight, resumed
        gc.collect()
        torch.cuda.empty_cache()

    # (c) the traffic at the depth that fits: the loss falls
    depth = lm_depth(cfg, dev, 16, LM_TRAIN_HEADROOM_BYTES)
    check(depth >= gate_layers(cfg), f"{name}: {depth} layers fit")
    reduced = None
    if depth < cfg.n_layers:
        reduced = dict(n_layers=[cfg.n_layers, depth],
                       why="16 B a parameter beside LM_TRAIN_HEADROOM_BYTES "
                           "exceed the card's free memory")
        cfg = dataclasses.replace(cfg, n_layers=depth)
    model = build_model(cfg, device=dev)
    tr = Trainer(model, TrainConfig(**traffic))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = tr.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = state["params"]
    n_params = sum(p.numel() for p in params.parameters())
    master_bytes = sum(p.numel() * p.element_size()
                       for p in params.parameters())
    opt_bytes = sum(t.numel() * t.element_size()
                    for t in _leaves(state["opt"]))
    check(all(p.dtype == torch.float32 for p in params.parameters()),
          f"{name}: the masters are not float32")

    step_s = []
    step = tr.train_step

    def timed_step(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return out

    tr.train_step = timed_step
    state, losses = tr.run(state)
    peak_bytes = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"{name} (c): losses {losses}")
    with torch.no_grad():      # step 0's batch again, after the run
        first_batch_after = float(model.loss(state["params"],
                                             tr.data.batch_at(0)))

    # one more step with the optimizer's update timed alone, then one
    # under the profiler: its launches and the card's busy share
    tr.train_step = step
    update = tr.optimizer.update
    opt_s = []

    def timed_update(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = update(*args)
        torch.cuda.synchronize()
        opt_s.append(time.perf_counter() - t)
        return out

    tr.optimizer = dataclasses.replace(tr.optimizer, update=timed_update)
    n = traffic["steps"]
    step(state["params"], state["opt"], tr.data.batch_at(n), n)
    tr.optimizer = dataclasses.replace(tr.optimizer, update=update)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step(state["params"], state["opt"], tr.data.batch_at(n + 1), n + 1)
        b.record()
        b.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    window_ms = a.elapsed_time(b)
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    ops = sorted(((e.key, device_us(e)) for e in prof.key_averages()
                  if e.key.startswith("aten::") and device_us(e) > 0),
                 key=lambda t: -t[1])
    profile = (dict(launches=len(kernels), device_busy_share=busy_ms / window_ms,
                    ms=window_ms, top_ops=[
                        dict(op=k, share=us / 1e3 / busy_ms)
                        for k, us in ops[:8]])
               if kernels else "not measured")

    # bounds: 8 N T (forward, the remat's forward, backward) at the bf16
    # rate, N the parameters in products, plus 4x the attention products;
    # the optimizer reads 16 B and writes 12 B a parameter
    T_ = traffic["batch"] * traffic["seq"]
    step_ops = 8 * product_params(cfg, params) * T_ \
        + 4 * attention_ops(cfg, traffic["batch"], traffic["seq"])
    step_bound_ms = step_ops / H100_BF16_FLOPS * 1e3
    opt_bound_ms = 28 * n_params / hbm_bw * 1e3
    step_ms = statistics.median(step_s[1:]) * 1e3
    check(kernel_launches() == launches_before,
          f"{name}: the training path launched a stencil kernel")
    out = dict(
        arch=name, layers=cfg.n_layers, reduced=reduced, d_model=cfg.d_model,
        vocab=cfg.vocab, act_dtype=cfg.act_dtype, remat=cfg.remat,
        optimizer=cfg.optimizer,
        loss_path="chunked" if cfg.vocab >= model.CHUNKED_XENT_MIN_VOCAB
        else "full logits",
        params=n_params, master_bytes=master_bytes, opt_state_bytes=opt_bytes,
        init_s=init_s, traffic=traffic, losses=losses,
        step_ms=step_ms, first_step_ms=step_s[0] * 1e3,
        tokens_per_s=T_ / step_ms * 1e3, step_flop_bound_ms=step_bound_ms,
        step_bound_share=step_bound_ms / step_ms,
        optimizer_ms=opt_s[0] * 1e3, optimizer_bound_ms=opt_bound_ms,
        optimizer_bound_by="bytes", peak_bytes=peak_bytes,
        step_profile=profile,
        gate_a=dict(layers=gate_layers(cfg),
                    tokens=list(LM_TRAIN_GATE_BATCH), **gate_a),
        gate_b=gate_b if gate_b is not None else "not run (granite only)",
        gate_c=dict(first=losses[0], last=losses[-1],
                    first_batch_after=first_batch_after),
        stencil_kernel_launches=kernel_launches() - launches_before,
    )
    del model, tr, state, params
    return out


def lm_train_phase(dev, hbm_bw: float, build_dir: Path, kernel_launches):
    """Phase ``lm_train``: :func:`lm_train` on each of LM_TRAIN_ARCHS in
    turn (gate (b) on the first), the memory of each freed before the
    next.  Yields one result per config."""
    import gc

    import torch

    from repro_torch.configs import base as arch_configs

    for i, arch in enumerate(LM_TRAIN_ARCHS):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        got = lm_train(dev, arch_configs.get(arch), hbm_bw, build_dir,
                       kernel_launches, crash_resume=i == 0)
        yield dict(got, phase_s=time.perf_counter() - t0)


def lm_launch_child(out_json: str, hbm_bytes: str) -> int:
    """Phase ``lm_launch``'s CPU half, in a fresh process with no card in
    view: the dry-run cells (``LM_LAUNCH_CELLS``) on torch's ``fake``
    process group against ``hbm_bytes`` of memory a rank, then
    ``analyze_step`` of the CLI's granite-3-2b train step (fake tensors:
    shapes only) and the step's analytic FLOP bound."""
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import base as arch_configs
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch import dryrun
    from repro_torch.models.layers import named_leaves
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.roofline import analyze_step

    out = {"cells": []}
    for arch, shape, multi_pod in LM_LAUNCH_CELLS:
        t0 = time.perf_counter()
        res = dryrun.lower_cell(arch, shape, multi_pod=multi_pod,
                                verbose=False, hbm_limit=float(hbm_bytes),
                                dump_dir=str(root / "build" / "op_dumps"))
        out["cells"].append(dict(
            arch=arch, shape=shape, mesh=res.mesh, status=res.status,
            reason=res.reason, wall_s=time.perf_counter() - t0,
            report=res.report))

    # (5): the CLI's step (batch 8 x 512, AdamW, remat "full"), counted
    args = dict(zip(LM_LAUNCH_CLI[::2], LM_LAUNCH_CLI[1::2]))
    cfg = arch_configs.get(args["--arch"])
    B, S = int(args["--batch"]), int(args["--seq"])
    with FakeTensorMode():
        model = build_model(cfg, device="cpu")
        params = model.init(torch.Generator()).requires_grad_()
        opt = make_optimizer(cfg.optimizer)
        state = opt.init(params)
        batch = SyntheticLMData(vocab=cfg.vocab, batch=B, seq=S,
                                device="cpu").batch_at(0)
        named = named_leaves(params)

        def step():
            loss = model.loss(params, batch)
            grads = torch.autograd.grad(loss, list(named.values()))
            opt.update(dict(zip(named, grads)), state, named, 0)

        counts = analyze_step(step)
        counts.pop("out")
        bound_ops = 8 * product_params(cfg, params) * B * S \
            + 4 * attention_ops(cfg, B, S)
    out["step"] = dict(arch=cfg.name, tokens=B * S, counts=counts,
                       analytic_flop_bound_ms=bound_ops
                       / H100_BF16_FLOPS * 1e3,
                       model_flops=6 * cfg.params_active_estimate * B * S)
    Path(out_json).write_text(json.dumps(out))
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def lm_launch_phase(dev, root: Path, kernel_launches):
    """Phase ``lm_launch`` (see the module docstring): yields one result
    per part; the dry-run child runs on the host while the card trains."""
    import dataclasses
    import gc
    import os
    import statistics

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import base as arch_configs
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch import sharding
    from repro_torch.models import mixers
    from repro_torch.models import transformer as T
    from repro_torch.models.model_zoo import build_model
    from repro_torch.roofline import roofline_from_step
    from repro_torch.train import TrainConfig, Trainer

    launches_before = kernel_launches()
    card_bytes = torch.cuda.get_device_properties(dev).total_memory
    # the CLI is another process on this card: hand it the cached blocks
    gc.collect()
    torch.cuda.empty_cache()
    held_bytes = torch.cuda.memory_reserved(dev)
    child_json = root / "build" / "lm_launch_child.json"
    child_json.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               CUDA_VISIBLE_DEVICES="")
    t_child = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, str(root / "chip_smoke.py"), "--lm-launch-child",
         str(child_json), str(card_bytes)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        # (1) the train CLI, at full width and depth
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train",
             *LM_LAUNCH_CLI], capture_output=True, text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=str(root / "src")))
        check(cli.returncode == 0, f"lm_launch (1): the CLI failed: "
              f"{cli.stderr[-3000:]}")
        steps = [(int(m[1]), float(m[2]), float(m[3])) for m in re.finditer(
            r"\[trainer\] step (\d+) loss (\S+) \((\d+) ms\)", cli.stdout)]
        done = [ln for ln in cli.stdout.splitlines()
                if ln.startswith("done:")]
        first, last = map(float, re.search(
            r"loss (\S+) -> (\S+)", done[-1]).groups())
        check(len(steps) == 4 and math.isfinite(last) and last < first,
              f"lm_launch (1): {cli.stdout[-2000:]}")
        step_ms = statistics.median(ms for _, _, ms in steps[1:])
        yield dict(part="train_cli", command="python -m "
                   "repro_torch.launch.train " + " ".join(LM_LAUNCH_CLI),
                   parent_reserved_bytes=held_bytes,
                   done=done[-1], losses=[loss for _, loss, _ in steps],
                   step_ms=[ms for _, _, ms in steps],
                   median_step_ms_after_first=step_ms,
                   wall_s=time.perf_counter() - t0)

        # (2) the sharded Trainer on a 1x1 NCCL mesh, float32
        t0 = time.perf_counter()
        torch.cuda.set_device(dev.index or 0)
        dist.init_process_group("nccl", init_method="tcp://localhost:"
                                f"{_free_port()}", world_size=1, rank=0)
        try:
            mesh = meshlib.make_host_mesh(1, 1)
            cfg = dataclasses.replace(arch_configs.get(LM_ARCH),
                                      act_dtype="float32")
            traffic = dict(LM_LAUNCH_MESH_TRAFFIC, seed=LM_SEED,
                           log_every=10 ** 9)
            plan = sharding.DEFAULT_PLAN
            T.set_mesh_rules(mesh, {**plan.act_rule_map(mesh),
                                    "batch": meshlib.batch_axes(mesh)})
            sharded_grads: dict = {}
            try:
                st, sharded_losses = first_step_grads(Trainer(
                    build_model(cfg, device=dev), TrainConfig(**traffic),
                    mesh=mesh, batch_spec=("data",)), sharded_grads).run()
            finally:
                T.clear_mesh_rules()
            sharded = {k: p.detach().full_tensor().cpu()
                       for k, p in st["params"].named_parameters()}
            placements = sorted({str(tuple(p.placements)) for p in
                                 st["params"].parameters()})
            del st
            gc.collect()
            torch.cuda.empty_cache()
            ref_grads: dict = {}
            st, losses = first_step_grads(Trainer(
                build_model(cfg, device=dev), TrainConfig(**traffic)),
                ref_grads).run()
            ref = {k: p.detach().cpu()
                   for k, p in st["params"].named_parameters()}
            del st
            gc.collect()
            torch.cuda.empty_cache()
            tol = LM_TRAIN_TOL["float32"]
            # the first step's gradients, gate (a)'s way: the check that
            # sees a wrong gradient scale, which AdamW's m/sqrt(v) hides
            # from the losses and parameters
            check(sorted(sharded_grads) == sorted(ref_grads),
                  "lm_launch (2): the two trainers' gradient trees differ")
            grad_rel = grad_errs((sharded_losses[0], sharded_grads),
                                 (losses[0], ref_grads))
            del sharded_grads, ref_grads
            loss_rel = max(abs(a - b) / abs(b)
                           for a, b in zip(sharded_losses, losses))
            param_max_rel = max(float((sharded[k] - r).abs().max())
                                for k, r in ref.items()) \
                / max(float(r.abs().max()) for r in ref.values())
            check(len(losses) == traffic["steps"]
                  and loss_rel <= tol["loss_rel"]
                  and grad_rel["grad_max_rel"] <= tol["grad_max_rel"]
                  and param_max_rel <= tol["grad_max_rel"],
                  f"lm_launch (2): sharded {sharded_losses} vs {losses}, "
                  f"first-step gradients {grad_rel}, params "
                  f"{param_max_rel}")
            yield dict(part="sharded_trainer", mesh="1x1 (data, model), "
                       "nccl", arch=cfg.name, layers=cfg.n_layers,
                       act_dtype="float32", traffic=traffic,
                       losses_sharded=sharded_losses, losses=losses,
                       loss_rel=loss_rel,
                       first_step_grad_max_rel=grad_rel["grad_max_rel"],
                       first_step_grad_rms_rel=grad_rel["grad_rms_rel"],
                       param_max_rel=param_max_rel,
                       tol=dict(loss_rel=tol["loss_rel"],
                                grad_max_rel=tol["grad_max_rel"],
                                param_max_rel=tol["grad_max_rel"]),
                       bitwise=sharded_losses == losses and all(
                           torch.equal(sharded[k], r)
                           for k, r in ref.items()),
                       placements=placements,
                       wall_s=time.perf_counter() - t0)
            del sharded, ref

            # (3) qwen2-moe-a2.7b's prefill through the EP dispatch
            t0 = time.perf_counter()
            cfg = arch_configs.get("qwen2_moe_a2_7b")
            cfg = dataclasses.replace(cfg, n_layers=gate_layers(cfg),
                                      act_dtype="float32")
            model = build_model(cfg, device=dev)
            params = model.init(torch.Generator(device=dev).manual_seed(
                LM_SEED))
            B, S_ = LM_LAUNCH_EP_BATCH
            tokens = torch.randint(0, cfg.vocab, (B, S_), device=dev,
                                   generator=torch.Generator(device=dev)
                                   .manual_seed(LM_SEED))
            with torch.no_grad():
                dense = model.prefill(params, {"tokens": tokens})[0]
                dense = dense.float().cpu()
                sharding.shard_params(model, params, mesh)
                ep, ep_calls = mixers.moe_apply_ep, []

                def counted(*a, **kw):
                    ep_calls.append(1)
                    return ep(*a, **kw)

                mixers.moe_apply_ep = counted
                T.set_mesh_rules(mesh, {
                    **plan.act_rule_map(mesh, seq_shard=False),
                    "batch": meshlib.batch_axes(mesh)})
                try:
                    with implicit_replication():
                        got = model.prefill(params, {"tokens": tokens})[0]
                finally:
                    T.clear_mesh_rules()
                    mixers.moe_apply_ep = ep
                got = got.full_tensor().float().cpu()
            d = (got - dense).abs()
            errs = dict(prefill_max_rel=float(d.max() / dense.abs().max()),
                        prefill_rms_rel=float(d.norm() / dense.norm()))
            bound = LM_CPU_TOL["float32"]["prefill_max_rel"]
            check(len(ep_calls) == cfg.n_layers
                  and bool(torch.isfinite(got).all())
                  and errs["prefill_max_rel"] <= bound,
                  f"lm_launch (3): EP calls {len(ep_calls)}, {errs}")
            yield dict(part="ep_moe_prefill", arch=cfg.name,
                       layers=cfg.n_layers, d_model=cfg.d_model,
                       experts=cfg.n_experts_padded, top_k=cfg.top_k,
                       tokens=[B, S_], act_dtype="float32",
                       ep_calls=len(ep_calls),
                       prefill_max_rel=errs["prefill_max_rel"],
                       prefill_rms_rel=errs["prefill_rms_rel"],
                       bound_prefill_max_rel=bound,
                       bitwise=bool(torch.equal(got, dense)),
                       wall_s=time.perf_counter() - t0)
            del model, params
            gc.collect()
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()

        # (4) and (5): the child's dry-run cells and counted step
        t0 = time.perf_counter()
        c_out, c_err = child.communicate(timeout=900)
        check(child.returncode == 0,
              f"lm_launch (4): the dry-run child failed: {c_err[-3000:]}")
        got = json.loads(child_json.read_text())
        for cell in got["cells"]:
            rep = cell["report"] or {}
            check(cell["status"] == "ok", f"lm_launch (4): {cell}")
            mem = rep["memory_per_chip"]
            yield dict(part="dryrun_cell", arch=cell["arch"],
                       shape=cell["shape"], mesh=cell["mesh"],
                       chips=rep["chips"], status=cell["status"],
                       peak_bytes_per_rank=mem["peak"],
                       card_bytes=card_bytes, fits=rep["fits"],
                       compute_term_s=rep["compute_term"],
                       memory_term_s=rep["memory_term"],
                       collective_term_s=rep["collective_term"],
                       bottleneck=rep["bottleneck"],
                       roofline_fraction=rep["roofline_fraction"],
                       useful_flops_ratio=rep["useful_flops_ratio"],
                       flops_per_rank=rep["hlo_flops"] / rep["chips"],
                       collective_bytes_per_rank=rep[
                           "collective_bytes_per_chip"],
                       collective_counts=rep["collective_detail"]["counts"],
                       wall_s=cell["wall_s"])
        step = got["step"]
        rep = roofline_from_step(
            step["counts"], arch=step["arch"], shape="cli_8x512",
            mesh_desc="1", chips=1, model_flops=step["model_flops"],
            memory_per_chip={"peak": 0}, hbm_limit=card_bytes)
        yield dict(part="analyze_step", arch=step["arch"],
                   tokens=step["tokens"], counted_flops=rep.hlo_flops,
                   counted_bytes=rep.hlo_bytes,
                   compute_term_ms=rep.compute_term * 1e3,
                   memory_term_ms=rep.memory_term * 1e3,
                   analytic_flop_bound_ms=step["analytic_flop_bound_ms"],
                   roofline_fraction=rep.roofline_fraction,
                   useful_flops_ratio=rep.useful_flops_ratio,
                   measured_step_ms=step_ms,
                   compute_term_share_of_step=rep.compute_term * 1e3
                   / step_ms,
                   child_wall_s=time.perf_counter() - t_child,
                   wait_s=time.perf_counter() - t0)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    check(kernel_launches() == launches_before,
          "lm_launch: the sharded path launched a stencil kernel")


def example_child(name: str, out_json: str, *args: str) -> int:
    """Phase ``examples``' child: ``examples_torch/<name>.py``'s ``main``
    with ``args`` (the default device: the card), then the tile kernels'
    launch counts of the run, the tolerance quickstart certifies and the
    seconds from here to the end (imports included), written to
    ``out_json``.  The example's own lines go to stdout."""
    import importlib.util

    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import pipeline, stencil

    spec = importlib.util.spec_from_file_location(
        f"example_{name}", root / "examples_torch" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    got = module.main(list(args))
    sys.stdout.flush()
    Path(out_json).write_text(json.dumps(dict(
        launches={"stencil_cuda": stencil.stencil_cuda.launches,
                  "stencil_cuda_batched":
                  pipeline.stencil_cuda_batched.launches},
        tolerance=got.get("tolerance"), wall_s=time.perf_counter() - t0)))
    return 0


def example_checks(name: str, out: str, child: dict) -> dict:
    """The example's own check, read from what it printed; raises if it
    does not hold.  Returns the values read."""
    def grab(pattern, cast=str):
        return [cast(m) for m in re.findall(pattern, out)]

    if name in STENCIL_EXAMPLES:
        check(sum(child["launches"].values()) > 0,
              f"examples: {name} launched no tile kernel")
    if name == "quickstart":
        err = grab(r"max \|err\| vs oracle = (\S+)", float)
        check(len(err) == 1 and err[0] <= child["tolerance"],
              f"examples: quickstart error {err} over "
              f"{child['tolerance']}")
        return dict(max_abs_err=err[0], tolerance=child["tolerance"])
    if name == "serve_stencils":
        bitwise = grab(r"bitwise equal to single-shot serve\(\): (\w+)")
        warm = re.search(r"warm restart: first result in (\d+) ms "
                         r"\(autotune_calls=(\d+), jit_builds=(\d+)", out)
        check(bitwise == ["True"] * 4 and warm is not None
              and warm[2] == "0" and warm[3] == "0",
              f"examples: serve_stencils bitwise {bitwise}, warm {warm}")
        cold = re.search(r"cold replica: first result in (\d+) ms", out)
        return dict(bitwise_parts=len(bitwise), warm_autotune_calls=0,
                    warm_jit_builds=0, cold_first_result_ms=int(cold[1]),
                    warm_first_result_ms=int(warm[1]))
    if name == "stencil_multidevice":
        correct = grab(r"correct=(\w+)")
        check(correct == ["True"] * 4, f"examples: multidevice {correct}")
        return dict(ms={v: float(ms) for v, ms in re.findall(
            r"^  (\w+) +k=\d+ s=\d+: +(\S+) ms", out, re.M)})
    if name == "train_lm":
        m = re.search(r"final loss (\S+) \(start (\S+)\)", out)
        check(m is not None and float(m[1]) < float(m[2]),
              f"examples: train_lm's loss did not fall: {out[-600:]}")
        return dict(final_loss=float(m[1]), first_loss=float(m[2]))
    if name == "serve_lm":
        m = re.search(r"generated (\d+) tokens", out)
        warm = grab(r"warm: (\S+) tok/s", float)
        check(m is not None and int(m[1]) > 0, "examples: serve_lm "
              "generated no token")
        return dict(tokens=int(m[1]), warm_tokens_per_s=warm[0])
    m = re.search(r"params identical after reshard-restore: (\w+)", out)
    check(m is not None and m[1] == "True",
          "examples: elastic_restart's parameters differ after restore")
    return dict(identical=True)


def examples_phase(root: Path, kernel_launches):
    """Phase ``examples`` (see the module docstring): yields one result
    per example.  The six run at once, each in its own process on the
    card, so the phase takes about as long as the slowest."""
    import os

    work = root / "build" / "examples"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    launches_before = kernel_launches()
    runs = []
    t_phase = time.perf_counter()
    try:
        for name, args in EXAMPLES:
            if name == "train_lm":
                args = args + ("--ckpt-dir", str(work / "train_lm_ckpt"))
            child_json = work / f"{name}.json"
            runs.append((name, args, child_json, subprocess.Popen(
                [sys.executable, str(root / "chip_smoke.py"),
                 "--example-child", name, str(child_json), *args],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env)))
        for name, args, child_json, proc in runs:
            out, err = proc.communicate(timeout=600)
            check(proc.returncode == 0, f"examples: {name} failed: "
                  f"{err[-3000:]}")
            child = json.loads(child_json.read_text())
            yield dict(example=name, command="python examples_torch/"
                       f"{name}.py " + " ".join(args),
                       wall_s=child["wall_s"], concurrent=len(runs),
                       phase_s=time.perf_counter() - t_phase,
                       launches=child["launches"],
                       **example_checks(name, out, child))
    finally:
        for *_, proc in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(work, ignore_errors=True)
    check(kernel_launches() == launches_before,
          "examples: this process launched a kernel")


def bench_phase(root: Path, dev):
    """Phase ``bench`` (see the module docstring): yields one result per
    gate, one per script and one for ``run.py``.  A correctness gate that
    fails raises inside its script; timing gates are read and reported."""
    import dataclasses
    import os

    from benchmarks_torch import model_accuracy, serving_latency, serving_throughput
    from benchmarks_torch.common import Gates

    for name, mod in (("serving_throughput", serving_throughput),
                      ("model_accuracy", model_accuracy),
                      ("serving_latency", serving_latency)):
        gates = Gates()
        t0 = time.perf_counter()
        rows = mod.run(smoke=False, device=dev, gates=gates)
        seconds = time.perf_counter() - t0
        for g in gates:
            yield dict(script=name, **dataclasses.asdict(g))
        check(all(g.held for g in gates if g.kind == "correctness"),
              f"bench: {name}: a correctness gate failed")
        yield dict(script=name, seconds=seconds, rows=rows,
                   gates=len(gates),
                   timing_missed=[g.gate for g in gates
                                  if g.kind == "timing" and not g.held])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src"), str(root)]))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(root / "benchmarks_torch" / "run.py"),
         "--device", dev.type, "--skip", "serving_throughput,model_accuracy"],
        cwd=root, env=env, capture_output=True,
        text=True, timeout=600)
    rows = proc.stdout.strip().splitlines()[1:]
    errors = [r for r in rows if "/ERROR," in r]
    check(proc.returncode == 0 and not errors,
          f"bench: run.py exited {proc.returncode} with {errors}: "
          f"{proc.stderr[-3000:]}")
    yield dict(script="run.py", device=dev.type, rows=len(rows),
               errors=errors, seconds=time.perf_counter() - t0,
               measured=[r for r in rows if "measured" in r],
               elapsed_us={r.split("/")[0]: float(r.split(",")[1])
                           for r in rows if "/elapsed," in r})


def main() -> int:
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        raise SystemExit("chip_smoke: src/repro_torch not found beside this script")
    sys.path[:0] = [str(root / "src"), str(root)]   # repro_torch, benchmarks_torch

    import dataclasses
    import warnings

    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")

    from repro_torch.configs import stencils
    from repro_torch.core import dsl
    from repro_torch.core import distribute, model
    from repro_torch.core.autotune import autotune, soda_baseline
    from repro_torch.core.ir import lower
    from repro_torch.core.model import ParallelismConfig, resident_blocks
    from repro_torch.core.platform import gpu_platform_for
    from repro_torch.core.spec import Boundary
    from repro_torch.kernels import cuda_build, ops, pipeline, ref, stencil
    from repro_torch.runtime import (
        DesignCache,
        ShapeBucketer,
        bucket_plan,
        build_bucket_runner,
        padded_request_shape,
    )
    from repro_torch.runtime.batching import (
        DegradedDesignWarning,
        build_batched_runner,
    )
    from repro_torch.serve import StencilRequest, StencilServer

    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(2022)

    # ---- 1. device ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    card = torch.cuda.get_device_name(0)
    gpu = gpu_platform_for(card)
    emit(phase="device", nvidia_smi=smi, kind=card, sku_row=gpu.name,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])

    def timed(fn, reps: int, warm: int = 2, inner: int = 1) -> float:
        """Median ms of one call of ``fn`` over ``reps`` samples, each
        ``inner`` calls back to back between CUDA events (so the host's
        launch overhead hides behind the device's work), divided by
        ``inner``."""
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(inner):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / inner)
        return float(np.median(times))

    def bound_ms(spec, batch: int, iterations: int) -> tuple[float, str]:
        """Least time for the work: every input read once, the output
        written once, against the card's HBM rate; the useful operations
        against its float32 rate."""
        nbytes = batch * (spec.num_inputs + 1) * spec.cells * spec.itemsize
        nops = batch * spec.cells * spec.ops_per_cell * iterations
        t_bytes = nbytes / gpu.hbm_bw * 1e3
        t_ops = nops / gpu.fp32_flops * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def inputs(spec, batch: int | None = None):
        shape = spec.shape if batch is None else (batch,) + tuple(spec.shape)
        return {
            n: rng.standard_normal(shape).astype(np.float32)
            for n in spec.inputs
        }

    def plain_run(spec, arrays, iterations, s, tile):
        """The main path's rounds through the kernels' plain version."""
        return ops.run_rounds(spec, arrays, iterations, s,
                              stencil.stencil_torch_tiled, tile)

    def max_err(a, b) -> float:
        return float((a.float() - b.float()).abs().max())

    # ---- 2. build -------------------------------------------------------
    small = []
    for key in stencils.BENCHMARKS:
        shape = SMALL_3D if key in stencils.BENCHMARKS_3D else SMALL_2D
        small.append(lower(stencils.get(key, shape=shape, iterations=4)).spec)
    small.append(dataclasses.replace(small[0], boundary=Boundary("constant", 1.5)))
    small.append(lower(dsl.parse(BF16_DSL)).spec)
    # streamed bucket specs: (request spec, its bucket plan)
    streamed = []
    for key in ("jacobi2d", "sobel2d_replicate"):
        for kind, wrap in (("replicate", None), ("periodic", 2)):
            spec = dataclasses.replace(
                lower(stencils.get(key, shape=SMALL_2D, iterations=4)).spec,
                boundary=Boundary(kind),
            )
            bucket = tuple(n + STREAMED_BUCKET_PAD for n in SMALL_2D)
            streamed.append((spec, bucket_plan(spec, bucket, iterations=4,
                                               wrap_rounds=wrap)))
    t0 = time.perf_counter()
    libs = cuda_build.build_many(small + [p.mspec for _, p in streamed],
                                 ptxas_info=True)
    ptxas = [ln.strip() for ln in libs[0].build_log.splitlines() if "registers" in ln]
    emit(phase="build", kernels=len({lib.key for lib in libs}),
         seconds=round(time.perf_counter() - t0, 3), ptxas_jacobi2d=ptxas)

    # ---- 3. small: kernel vs plain, K2 vs K1 ------------------------------
    def small_variants(spec):
        """The spec on its small grid and on the larger one (bf16 keeps
        its own), each with the default tile and the taller one."""
        shapes = [tuple(spec.shape)]
        if spec.dtype == "float32":
            shapes.append(LARGER_3D if spec.ndim == 3 else LARGER_2D)
        for shape in shapes:
            sp = dataclasses.replace(spec, inputs={
                n: (dt, shape) for n, (dt, _) in spec.inputs.items()})
            for rows in (0, TALL_ROWS[sp.ndim]):
                yield sp, stencil.default_tile(sp.ndim, rows)

    kinds = set()
    for spec0 in small:
        kinds.add(spec0.boundary.kind)
        errs, bitwise, runs = [], True, []
        for spec, tile in small_variants(spec0):
            arrays = inputs(spec, batch=3)
            t = ops.to_device(spec, arrays, dev)
            for s in SMALL_S:
                if stencil.smem_bytes_estimate(spec, s, tile) > gpu.smem_per_block:
                    continue
                runs.append([list(spec.shape), list(tile), s])
                per_entry = []
                for b in range(3):
                    one = {n: a[b] for n, a in t.items()}
                    got = stencil.stencil_cuda(spec, one, s, tile)
                    want = stencil.stencil_torch_tiled(spec, one, s, tile)
                    torch.cuda.synchronize()
                    err = max_err(got, want)
                    scale = max(1.0, float(want.float().abs().max()))
                    check(err <= TOL[spec.dtype] * scale,
                          f"{spec.name} {spec.shape} tile={tile} s={s}: kernel "
                          f"vs plain {err} > {TOL[spec.dtype]} x {scale}")
                    errs.append(err / scale)
                    per_entry.append(got)
                both = pipeline.stencil_cuda_batched(spec, t, s, tile)
                torch.cuda.synchronize()
                bitwise &= all(torch.equal(both[b], per_entry[b]) for b in range(3))
        check(bitwise, f"{spec0.name}: K2 differs from K1 per entry")
        emit(phase="small", spec=spec0.name, boundary=spec0.boundary.kind,
             dtype=spec0.dtype, runs=len(runs), shapes_tiles_s=runs,
             max_rel_err=max(errs), tol=TOL[spec0.dtype], k2_bitwise=bitwise)
    check(kinds == {"zero", "constant", "replicate", "periodic"},
          f"boundary kinds covered: {sorted(kinds)}")

    # streamed bucket specs: three entries with their own maps (a full
    # grid, a smaller one, the all-zero batch filler)
    streamed_err = 0.0
    for spec, plan in streamed:
        mspec = plan.mspec
        entries = []
        for cut in (0, 5):
            shape = tuple(n - cut for n in spec.shape)
            e = {n: plan.place_entry(rng.standard_normal(shape).astype(np.float32))
                 for n in spec.inputs}
            e.update(plan.service_entry(shape))
            entries.append(e)
        filler = {n: plan.filler_entry(n) for n in spec.inputs}
        filler.update(plan.service_filler())
        entries.append(filler)
        check(all(not np.any(filler[n]) for n in plan.service_names),
              "the filler entry carries all-zero service arrays")
        t = ops.to_device(mspec, {n: np.stack([e[n] for e in entries])
                                  for n in mspec.inputs}, dev)
        errs, bitwise = [], True
        for tile in (None, (16, 16)):    # (16, 16): tiles wholly in padding
            for s in SMALL_S:
                both = pipeline.stencil_cuda_batched(mspec, t, s, tile)
                for b in range(3):
                    one = {n: a[b] for n, a in t.items()}
                    got = stencil.stencil_cuda(mspec, one, s, tile)
                    want = stencil.stencil_torch_tiled(mspec, one, s, tile)
                    torch.cuda.synchronize()
                    scale = max(1.0, float(want.abs().max()))
                    errs.append(max_err(got, want) / scale)
                    bitwise &= torch.equal(both[b], got)
        rounds = pipeline.stencil_run_batched(mspec, t, 4, s=1)
        rounds_plain = ops.run_rounds(mspec, t, 4, 1,
                                      pipeline.stencil_torch_pipeline)
        scale = max(1.0, float(rounds_plain.abs().max()))
        errs.append(max_err(rounds, rounds_plain) / scale)
        check(max(errs) <= TOL[mspec.dtype],
              f"{mspec.name}: streamed kernel vs plain {max(errs)}")
        check(bitwise, f"{mspec.name}: K2 differs from K1 per entry")
        streamed_err = max(streamed_err, max(errs))
        emit(phase="small", spec=mspec.name, boundary=spec.boundary.kind,
             streamed=list(plan.service_names), bucket=list(plan.bucket),
             dtype=mspec.dtype, s=list(SMALL_S), tiles=["default", [16, 16]],
             rounds_iterations=4,
             max_rel_err=max(errs), tol=TOL[mspec.dtype], k2_bitwise=bitwise)

    # ---- 4. main path -----------------------------------------------------
    main_launches = {"stencil_cuda": 0, "stencil_cuda_batched": 0}
    for key, shape in MAIN_CASES:
        text = dsl.format_spec(stencils.get(key, shape=shape, iterations=ITERATIONS))
        arrays = inputs(stencils.get(key, shape=shape))
        stencil.stencil_cuda.launches = 0
        pipeline.stencil_cuda_batched.launches = 0
        t0 = time.perf_counter()
        design = autotune(text, device="cuda")
        out = design.runner(arrays)
        wall = time.perf_counter() - t0
        launches = {"stencil_cuda": stencil.stencil_cuda.launches,
                    "stencil_cuda_batched": pipeline.stencil_cuda_batched.launches}
        spec, cfg, run = design.spec, design.config, design.runner
        want_kernel = "stencil_cuda" if run.path == "single_pe" else "stencil_cuda_batched"
        check(launches[want_kernel] > 0, f"{key}: {want_kernel} never launched")
        for k, v in launches.items():
            main_launches[k] += v
        check(out.shape == tuple(shape) and bool(np.isfinite(out).all()),
              f"{key}: output shape {out.shape} or non-finite values")
        t = ops.to_device(spec, arrays, dev)
        plain = plain_run(spec, t, ITERATIONS, cfg.s, run.batched.tile)
        err = float(np.abs(out - plain.cpu().numpy()).max())
        scale = max(1.0, float(plain.abs().max()))
        check(err <= TOL[spec.dtype] * scale,
              f"{key} {shape}: main path vs plain {err} > tol x {scale}")
        # K1 at the design's (s, tile) on the same grid: held against the
        # same plain run and bitwise against the design's result (K2 when
        # the ranker picks it).  A comparison: its launches are not counted
        k1_out = ops.stencil_run(spec, t, ITERATIONS, s=cfg.s,
                                 tile=run.batched.tile)
        k1_err = max_err(k1_out, plain)
        k1_bitwise = bool(np.array_equal(k1_out.cpu().numpy(), out))
        check(k1_err <= TOL[spec.dtype] * scale,
              f"{key} {shape}: K1 vs plain {k1_err} > tol x {scale}")
        check(k1_bitwise, f"{key} {shape}: K1 differs from the {run.path} result")
        staged = run.batched.stage({n: a[None] for n, a in arrays.items()})
        ms = timed(lambda: run.batched.dispatch(staged), reps=10, inner=5)
        plain_ms = timed(lambda: plain_run(spec, t, ITERATIONS, cfg.s,
                                           run.batched.tile), reps=3, warm=1)
        b_ms, b_by = bound_ms(spec, 1, ITERATIONS)
        nbytes = (spec.num_inputs + 1) * spec.cells * spec.itemsize
        emit(phase="main", spec=spec.name, shape=list(shape),
             iterations=ITERATIONS,
             config=dict(s=cfg.s, tile=list(run.batched.tile),
                         buffer_depth=cfg.buffer_depth),
             path=run.path, launches=launches, first_call_s=round(wall, 3),
             max_abs_err=err, scale=scale, k1_max_abs_err=k1_err,
             k1_bitwise=k1_bitwise, ms=ms, plain_ms=plain_ms,
             bound_ms=b_ms, bound_by=b_by, bound_share=b_ms / ms,
             gb_per_s=nbytes / ms / 1e6,
             predicted_ms=design.prediction.latency * 1e3,
             predicted_hbm_mb=design.prediction.hbm_bytes / 1e6,
             cell_updates=design.prediction.cell_updates)

    # the model against the kernel at every fusion depth and tile it ranks
    spec = lower(stencils.jacobi2d(shape=(4096, 4096), iterations=ITERATIONS)).spec
    t = ops.to_device(spec, inputs(spec), dev)
    tuned = autotune(spec, device="cuda", build=False)
    sweep, fit = [], []
    for pred in tuned.ranking:
        if pred.config.buffer_depth:
            continue
        s, tile = pred.config.s, stencil.default_tile(2, pred.config.tile_rows)
        ms = timed(lambda: ops.stencil_run(spec, t, ITERATIONS, s=s, tile=tile),
                   reps=10, inner=3)
        sweep.append((ms, s, tile))
        emit(phase="sweep", spec=spec.name, shape=[4096, 4096],
             iterations=ITERATIONS, s=s, tile=list(tile),
             smem_bytes=stencil.smem_bytes_estimate(spec, s, tile), ms=ms,
             predicted_ms=pred.latency * 1e3,
             predicted_compute_ms=pred.compute_term * 1e3,
             predicted_memory_ms=pred.memory_term * 1e3,
             cell_updates=pred.cell_updates,
             measured_s_per_update=ms * 1e-3 / pred.cell_updates,
             resident_blocks=resident_blocks(int(pred.smem_bytes), gpu),
             ranked_first=pred is tuned.prediction)
        if s >= 4 and resident_blocks(int(pred.smem_bytes), gpu) >= gpu.full_rate_blocks:
            fit.append((ms - pred.memory_term * 1e3) * 1e-3 / pred.cell_updates)
    best = min(sweep)
    picked = next(m for m, s, tile in sweep
                  if (s, tile) == (tuned.config.s, stencil.default_tile(
                      2, tuned.config.tile_rows)))
    emit(phase="sweep_summary", picked=dict(s=tuned.config.s,
         tile_rows=tuned.config.tile_rows), picked_ms=picked,
         fastest=dict(s=best[1], tile=list(best[2])), fastest_ms=best[0],
         picked_over_fastest=picked / best[0],
         # the ranker's cell_update_s as this run measures it (s >= 4,
         # full-rate occupancy): (measured - memory term) / updates
         fitted_s_per_update=float(np.median(fit)) if fit else None,
         platform_s_per_update=gpu.cell_update_s)

    # ---- 5. batched: K2 on a batch of 8 ------------------------------------
    spec = lower(stencils.jacobi2d(shape=(9720, 1024), iterations=ITERATIONS)).spec
    cfg_main = autotune(spec, device="cuda", build=False).config
    s_main = cfg_main.s
    run = build_batched_runner(
        spec, ParallelismConfig("temporal", s=s_main, buffer_depth=2,
                                tile_rows=cfg_main.tile_rows),
        device="cuda",
    )
    batch = inputs(spec, batch=8)
    stencil.stencil_cuda.launches = 0
    pipeline.stencil_cuda_batched.launches = 0
    out = run(batch)
    k2_batched_launches = pipeline.stencil_cuda_batched.launches
    check(run.path == "tile_pipeline" and k2_batched_launches > 0
          and stencil.stencil_cuda.launches == 0,
          f"batched runner went through {run.path}")
    t = ops.to_device(spec, batch, dev)
    per_entry = torch.stack([
        ops.stencil_run(spec, {n: a[b] for n, a in t.items()}, ITERATIONS,
                        s=s_main, tile=run.tile, backend="cuda")
        for b in range(8)
    ])
    k2_bitwise = bool(np.array_equal(out, per_entry.cpu().numpy()))
    check(k2_bitwise, "K2 batch differs from K1 per entry")
    one_round = lambda: pipeline.stencil_cuda_batched(spec, t, s_main, run.tile)
    k2_out = one_round()
    k2_plain = pipeline.stencil_torch_pipeline(spec, t, s_main, run.tile)
    k2_err = max_err(k2_out, k2_plain)
    check(k2_err <= TOL[spec.dtype] * max(1.0, float(k2_plain.abs().max())),
          f"K2 vs plain {k2_err}")
    round_ms = timed(one_round, reps=10, inner=5)
    # K2 at s=1 against one F.conv2d over the batch (its yardstick)
    xb = t["in_1"].view(8, 1, *spec.shape)
    w5 = torch.tensor([[0.0, 1.0, 0.0], [1.0, 1.0, 1.0], [0.0, 1.0, 0.0]],
                      device=dev).div_(5).view(1, 1, 3, 3)
    k2_s1 = lambda: pipeline.stencil_cuda_batched(spec, t, 1, run.tile)
    k2_conv = lambda: F.conv2d(xb, w5, padding=1)
    conv_err = max_err(k2_conv().view(8, *spec.shape), k2_s1())
    check(conv_err <= 1e-5 * max(1.0, float(xb.abs().max())),
          f"batched conv2d yardstick computes another function: {conv_err}")
    k2_ms = timed(k2_s1, reps=10, inner=10)
    k2_library_ms = timed(k2_conv, reps=10, inner=10)
    k2_plain_ms = timed(lambda: pipeline.stencil_torch_pipeline(
        spec, t, 1, run.tile), reps=3, warm=1)
    k2_bound, k2_by = bound_ms(spec, 8, 1)
    emit(phase="batched", spec=spec.name, batch=8, s=s_main,
         tile=list(run.tile), launches=k2_batched_launches,
         k2_bitwise_vs_k1=k2_bitwise, round_ms=round_ms,
         max_abs_err=k2_err, s1_ms=k2_ms, s1_plain_ms=k2_plain_ms,
         s1_library_ms=k2_library_ms, s1_bound_ms=k2_bound, s1_bound_by=k2_by,
         conv_vs_kernel_err=conv_err, cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         run_ms=timed(lambda: run.dispatch(run.stage(batch)), reps=5, warm=1))

    # ---- 6. yardstick: one JACOBI2D iteration against F.conv2d -------------
    spec = lower(stencils.jacobi2d(shape=(4096, 4096), iterations=1)).spec
    t = ops.to_device(spec, inputs(spec), dev)
    x = t["in_1"]
    k1_out = stencil.stencil_cuda(spec, t, 1)
    k1_plain = stencil.stencil_torch_tiled(spec, t, 1)
    k1_err = max_err(k1_out, k1_plain)
    check(k1_err <= TOL["float32"] * max(1.0, float(k1_plain.abs().max())),
          f"K1 vs plain at 4096x4096: {k1_err}")
    w = torch.tensor([[0.0, 1.0, 0.0], [1.0, 1.0, 1.0], [0.0, 1.0, 0.0]],
                     device=dev).div_(5).view(1, 1, 3, 3)
    conv = lambda: F.conv2d(x.view(1, 1, 4096, 4096), w, padding=1)
    conv_err = max_err(conv().view(4096, 4096), k1_out)
    check(conv_err <= 1e-5 * max(1.0, float(k1_out.abs().max())),
          f"conv2d yardstick computes another function: {conv_err}")
    k1_ms = timed(lambda: stencil.stencil_cuda(spec, t, 1), reps=20, inner=10)
    k1_plain_ms = timed(lambda: stencil.stencil_torch_tiled(spec, t, 1), reps=5)
    library_ms = timed(conv, reps=20, inner=10)
    k1_bound, k1_by = bound_ms(spec, 1, 1)
    emit(phase="yardstick", spec=spec.name, shape=[4096, 4096], s=1,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32, ms=k1_ms,
         plain_ms=k1_plain_ms, library_ms=library_ms, bound_ms=k1_bound,
         bound_by=k1_by, conv_vs_kernel_err=conv_err)


    # ---- 7. serve: bucketed serving at the paper's width -------------------
    def serve_spec(mode, shape):
        return dsl.parse(BOUNDARY_DSL.format(
            tag=mode.split()[0].upper(), it=ITERATIONS, boundary=mode,
            r=shape[0], c=shape[1]))

    srv = StencilServer(device="cuda", max_batch=4, cache=DesignCache(),
                        bucketing=ShapeBucketer(ladder=SERVE_LADDER),
                        async_dispatch=True, warmup=False)
    srng = np.random.default_rng(2022)
    paper = (9720, 1024)
    traffic = {}
    for mode in SERVE_MODES:
        shapes = [paper] + [
            (int(srng.integers(8000, 9721)), int(srng.integers(768, 1025)))
            for _ in range(SERVE_SHAPES - 1)
        ]
        reg = srv.register(mode.split()[0], serve_spec(mode, paper))
        traffic[mode] = [
            (shape, {"in_1": srng.standard_normal(shape).astype(np.float32)})
            for shape in shapes for _ in range(SERVE_REPEATS)
        ]
        for shape in shapes:      # route every shape: bucket designs exist
            reg.cached.runner_for(shape, count=0)
    bucket_specs = [e.cached.design.spec for m in SERVE_MODES
                    for e in srv.design(m.split()[0]).cached.buckets.values()]
    t0 = time.perf_counter()
    cuda_build.build_many(bucket_specs)
    emit(phase="serve_build", kernels=len({cuda_build.kernel_key(sp)
                                          for sp in bucket_specs}),
         seconds=time.perf_counter() - t0)
    serve_launches = {"stencil_cuda": 0, "stencil_cuda_batched": 0}
    serve_err = 0.0
    served = {}     # mode -> serve()'s results, held by phases 12 and 13
    for mode in SERVE_MODES:
        name = mode.split()[0]
        reqs = [StencilRequest(name, arrays) for _, arrays in traffic[mode]]
        before = srv.stats()[name]["batches"]
        torch.cuda.synchronize()
        stencil.stencil_cuda.launches = 0
        pipeline.stencil_cuda_batched.launches = 0
        t0 = time.perf_counter()
        outs = srv.serve(reqs)
        flush_s = time.perf_counter() - t0
        served[mode] = outs
        launches = {"stencil_cuda": stencil.stencil_cuda.launches,
                    "stencil_cuda_batched": pipeline.stencil_cuda_batched.launches}
        check(sum(launches.values()) > 0, f"serve {mode}: no kernel launched")
        for k, v in launches.items():
            serve_launches[k] += v
        bd = srv.design(name).cached
        batches = srv.stats()[name]["batches"] - before
        per_bucket = {}
        for shape, _ in traffic[mode]:
            b = bd.bucket_for(shape)
            per_bucket[b] = per_bucket.get(b, 0) + 1
        dispatched = sum(-(-n // srv.max_batch) * srv.max_batch * math.prod(b)
                         for b, n in per_bucket.items())
        real = sum(math.prod(shape) for shape, _ in traffic[mode])
        err, bitwise = 0.0, True
        for (shape, arrays), out in zip(traffic[mode], outs):
            sp = serve_spec(mode, shape)
            check(out.shape == shape and bool(np.isfinite(out).all()),
                  f"serve {mode} {shape}: shape {out.shape} or non-finite")
            entry = bd.runner_for(shape, count=0)
            minimal = padded_request_shape(sp, shape, ITERATIONS, bd.wrap_rounds)
            single = build_bucket_runner(
                sp, minimal, entry.config, iterations=ITERATIONS,
                device="cuda", wrap_rounds=bd.wrap_rounds,
            )({n: a[None] for n, a in arrays.items()})[0]
            bitwise &= bool(np.array_equal(out, single))
            low = lower(sp).spec
            t = ops.to_device(low, arrays, dev)
            plain = plain_run(low, t, ITERATIONS, entry.config.s, entry.runner.tile)
            scale = max(1.0, float(plain.abs().max()))
            err = max(err, float(np.abs(out - plain.cpu().numpy()).max()) / scale)
        # device time of one full micro-batch of the most used bucket
        # (CUDA events around the dispatch of staged inputs)
        top = max(per_bucket, key=per_bucket.get)
        chunk = [(i, r, shape) for i, (r, (shape, _)) in
                 enumerate(zip(reqs, traffic[mode])) if bd.bucket_for(shape) == top]
        runner, stacked, _, _ = srv._prepare(srv.design(name), top,
                                             chunk[:srv.max_batch])
        staged = runner.stage(stacked)
        batch_ms = timed(lambda: runner.dispatch(staged), reps=3, warm=1)
        # what the ranker's launch term prices: one round of this
        # micro-batch as one K2 launch and as one K1 launch per entry
        mspec, s_r, tile_r = runner.masked_spec, runner.cfg.s, runner.tile
        B = next(iter(staged.values())).shape[0]
        entries = [{n: a[b] for n, a in staged.items()} for b in range(B)]
        k2_round_ms = timed(lambda: pipeline.stencil_cuda_batched(
            mspec, staged, s_r, tile_r), reps=10, warm=2)
        k1_round_ms = timed(lambda: [stencil.stencil_cuda(
            mspec, e, s_r, tile_r) for e in entries], reps=10, warm=2)
        check(bitwise, f"serve {mode}: differs from single-shot bucket runner")
        check(err <= TOL["float32"], f"serve {mode}: vs plain {err}")
        serve_err = max(serve_err, err)
        emit(phase="serve", mode=mode, iterations=ITERATIONS,
             requests=len(reqs), shapes=sorted({s for s, _ in traffic[mode]}),
             micro_batches=batches, buckets_built=bd.num_buckets,
             buckets=["x".join(map(str, b)) for b in per_bucket],
             config=dict(s=entry.config.s, buffer_depth=entry.config.buffer_depth),
             wrap_rounds=bd.wrap_rounds, path=entry.runner.path,
             launches=launches, flush_s=flush_s, grids_per_s=len(reqs) / flush_s,
             micro_batch_device_ms=batch_ms,
             round_k2_once_ms=k2_round_ms, round_k1_per_entry_ms=k1_round_ms,
             round_entries=B, round_s=s_r,
             device_busy_share=batches * batch_ms / 1e3 / flush_s,
             padded_cell_share=1.0 - real / dispatched,
             bitwise_vs_single_shot=bitwise, max_rel_err=err, tol=TOL["float32"])

    # ---- 8. distribute: the five parallelisms on 4 logical devices -------
    pool = [dev] * DIST_POOL
    on_pool = dict(logical_devices=len(pool),
                   physical_devices=len(set(pool)))
    gpu_pool = gpu.with_gpus(DIST_POOL)
    dist_cfgs = [
        ParallelismConfig("spatial_s", k=4),
        ParallelismConfig("spatial_r", k=4),
        ParallelismConfig("hybrid_s", k=4, s=4),
        ParallelismConfig("hybrid_r", k=4, s=4),
        ParallelismConfig("temporal", s=4),
    ]

    def kernel_launches():
        return stencil.stencil_cuda.launches + pipeline.stencil_cuda_batched.launches

    for key, shape in DIST_CASES:
        spec = lower(stencils.get(key, shape=shape, iterations=ITERATIONS)).spec
        arrays = inputs(spec)
        want = ref.stencil_iterations_ref(
            spec, ops.to_device(spec, arrays, dev), ITERATIONS).cpu().numpy()
        scale = max(1.0, float(np.abs(want).max()))
        for cfg in dist_cfgs:
            run = distribute.build_runner(spec, cfg, iterations=ITERATIONS,
                                          devices=pool)
            staged = run.stage(arrays)
            torch.cuda.synchronize()
            stencil.stencil_cuda.launches = 0
            pipeline.stencil_cuda_batched.launches = 0
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            pending = run.dispatch(staged)
            b.record()
            out = run.finalize(pending)
            launched = kernel_launches()
            halo_bytes = run.halo_bytes
            err = float(np.abs(out - want).max()) / scale
            check(out.shape == tuple(shape) and bool(np.isfinite(out).all()),
                  f"distribute {key} {cfg.variant}: shape or non-finite")
            check(err <= TOL["float32"],
                  f"distribute {key} {cfg.variant}: vs oracle {err}")
            check(launched == 0, f"distribute {key}: the shard path launched "
                  f"{launched} tile kernels")
            # the temporal pipeline takes seconds (host-bound, see PERF.md):
            # its one checked run is its sample
            ms = a.elapsed_time(b) if cfg.variant == "temporal" else timed(
                lambda: run.dispatch(staged), reps=3, warm=1)
            # the ranker prices a temporal design as the tile kernel that
            # runs it, not this pipeline; a row partition as it runs here
            # (its host term is the same on one card as on four)
            pred = (None if cfg.variant == "temporal" else
                    model.predict_gpu(spec, cfg, gpu_pool, ITERATIONS))
            emit(phase="distribute", spec=spec.name, shape=list(shape),
                 iterations=ITERATIONS, variant=cfg.variant, k=cfg.k, s=cfg.s,
                 **on_pool, path=run.path, backend=run.backend,
                 kernel_launches=launched, ms=ms, halo_bytes=halo_bytes,
                 max_rel_err=err, tol=TOL["float32"],
                 predicted_4gpu_ms=pred and pred.latency * 1e3,
                 predicted_host_ms=pred and pred.host_term * 1e3,
                 predicted_launches=pred and pred.launches)
    spec = lower(stencils.jacobi2d(shape=(9720, 1024), iterations=ITERATIONS)).spec
    cfg = ParallelismConfig("hybrid_s", k=4, s=4)
    batch = inputs(spec, batch=2)
    both = distribute.build_runner(spec, cfg, iterations=ITERATIONS,
                                   devices=pool, batched=True)(batch)
    single = distribute.build_runner(spec, cfg, iterations=ITERATIONS,
                                     devices=pool)
    dist_bitwise = all(np.array_equal(both[b], single({"in_1": batch["in_1"][b]}))
                       for b in range(2))
    check(dist_bitwise, "distribute: batched entries differ from single grids")
    emit(phase="distribute_batched", spec=spec.name, batch=2,
         variant=cfg.variant, k=cfg.k, s=cfg.s, **on_pool,
         bitwise_vs_single_grid=dist_bitwise)

    # ---- 9. degraded: a k=4 design on the real pool of one card ----------
    x = inputs(spec)
    cfg = ParallelismConfig("hybrid_s", k=4, s=8)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run = build_batched_runner(spec, cfg, iterations=ITERATIONS)
    warned = any(issubclass(w.category, DegradedDesignWarning) for w in caught)
    stencil.stencil_cuda.launches = 0
    pipeline.stencil_cuda_batched.launches = 0
    out = run({"in_1": x["in_1"][None]})[0]
    degraded_launches = stencil.stencil_cuda.launches
    k1 = ops.stencil_run(spec, x, ITERATIONS, s=8, tile=run.tile,
                         backend="cuda").cpu().numpy()
    try:
        build_batched_runner(spec, cfg, iterations=ITERATIONS, strict=True)
        strict_raised = False
    except ValueError:
        strict_raised = True
    check(warned and run.degraded and run.n_devices == 1,
          f"degraded: warned={warned} degraded={run.degraded} "
          f"n_devices={run.n_devices}")
    check(degraded_launches > 0, "degraded: K1 never launched")
    check(bool(np.array_equal(out, k1)), "degraded: differs from temporal(s=8) K1")
    check(strict_raised, "degraded: strict=True did not raise")
    emit(phase="degraded", spec=spec.name, variant=cfg.variant, k=cfg.k,
         s=cfg.s, pool=[str(d) for d in run.devices],
         devices_requested=run.devices_requested, n_devices=run.n_devices,
         path=run.path, tile=list(run.tile), warned=warned,
         stencil_cuda_launches=degraded_launches,
         bitwise_vs_temporal_k1=True, strict_raised=strict_raised)

    # ---- 10. rank_pool: SASA's design space against SODA's ----------------
    text = dsl.format_spec(stencils.jacobi2d(shape=(9720, 1024),
                                             iterations=ITERATIONS))
    def described(i, p):
        return dict(rank=i, variant=p.config.variant, k=p.config.k,
                    s=p.config.s, tile_rows=p.config.tile_rows,
                    buffer_depth=p.config.buffer_depth,
                    predicted_ms=p.latency * 1e3,
                    host_ms=p.host_term * 1e3,
                    collective_ms=p.collective_term * 1e3)

    for name, tune in (("autotune", autotune), ("soda_baseline", soda_baseline)):
        td = tune(text, devices=pool, build=False)
        shard = next(((i, p) for i, p in enumerate(td.ranking)
                      if p.config.k > 1), None)
        emit(phase="rank_pool", ranker=name, spec=td.spec.name,
             shape=[9720, 1024], iterations=ITERATIONS, **on_pool,
             candidates=len(td.ranking),
             top=[described(i, p) for i, p in enumerate(td.ranking[:5])],
             best_shard=shard and described(*shard))
    # the chosen design, built on the pool, runs the tile kernel
    design = autotune(text, devices=pool)
    stencil.stencil_cuda.launches = 0
    pipeline.stencil_cuda_batched.launches = 0
    out = design.runner(inputs(design.spec))
    pool_launches = kernel_launches()
    run = design.runner.batched
    check(run.path in ("single_pe", "tile_pipeline") and pool_launches > 0,
          f"rank_pool: the design built on the pool ran {run.path} with "
          f"{pool_launches} tile-kernel launches")
    check(bool(np.isfinite(out).all()), "rank_pool: non-finite output")
    emit(phase="rank_pool_build", variant=design.config.variant,
         k=design.config.k, s=design.config.s, **on_pool, path=run.path,
         n_devices=run.n_devices, degraded=run.degraded,
         tile_kernel_launches=pool_launches)

    # ---- 11. cold_start: two fresh replicas over one store ---------------
    from benchmarks_torch import cold_start
    from benchmarks_torch.common import Gates

    gates = Gates()   # a correctness gate that fails raises here
    pair = cold_start.run_cold_start([], gates, dev, dsl=COLD_DSL)
    emit(phase="cold_start", spec="JACOBI2D", shape=[9720, 1024],
         iterations=ITERATIONS, **pair,
         gates=[dataclasses.asdict(g) for g in gates])

    # ---- 12. scheduler: continuous batching over phase serve's server ----
    from repro_torch.serve import StencilScheduler

    trace = [(mode, StencilRequest(mode.split()[0], arrays), i)
             for mode in SERVE_MODES
             for i, (_, arrays) in enumerate(traffic[mode])]
    torch.cuda.synchronize()
    stencil.stencil_cuda.launches = 0
    pipeline.stencil_cuda_batched.launches = 0
    t0 = time.perf_counter()
    with StencilScheduler(srv) as sched:
        tickets = [sched.submit(req) for _, req, _ in trace]
        sched.drain()
    sched_s = time.perf_counter() - t0
    sched_launches = {"stencil_cuda": stencil.stencil_cuda.launches,
                      "stencil_cuda_batched": pipeline.stencil_cuda_batched.launches}
    st = sched.stats()
    check(all(t.done() and t.exception() is None for t in tickets)
          and st["completed"] == len(trace) and st["failed"] == 0,
          f"scheduler: dropped or failed requests: {st}")
    sched_bitwise = all(np.array_equal(t.result(), served[mode][i])
                        for t, (mode, _, i) in zip(tickets, trace))
    check(sched_bitwise, "scheduler: differs from synchronous serve()")
    check(sum(sched_launches.values()) > 0, "scheduler: no kernel launched")
    emit(phase="scheduler", requests=len(trace), seconds=sched_s,
         grids_per_s=len(trace) / sched_s,
         dispatched_batches=st["dispatched_batches"],
         deadline_misses=st["deadline_misses"], launches=sched_launches,
         bitwise_vs_serve=sched_bitwise)

    # the open-loop Poisson trace of benchmarks/serving_latency.py
    lrng = np.random.default_rng(42)
    lat_designs = {
        "jac_s": stencils.jacobi2d(shape=(64, 32), iterations=4),
        "jac_l": stencils.jacobi2d(shape=(96, 48), iterations=4),
        "hot_s": stencils.hotspot(shape=(64, 32), iterations=4),
        "hot_l": stencils.hotspot(shape=(96, 48), iterations=4),
    }
    names = sorted(lat_designs)
    arrivals = np.cumsum(lrng.exponential(1.0 / 300.0, size=240))
    lat_trace = []
    for t_arr in arrivals:
        name = names[int(lrng.integers(len(names)))]
        lat_trace.append((float(t_arr), StencilRequest(name, {
            k: lrng.standard_normal(shape).astype(dt)
            for k, (dt, shape) in lat_designs[name].inputs.items()})))
    lat_cache = DesignCache()

    def lat_server():
        server = StencilServer(device="cuda", max_batch=4, cache=lat_cache)
        for name, sp in lat_designs.items():
            server.register(name, sp)
        return server

    def pct(xs, q):
        return float(np.percentile(np.asarray(xs), q)) * 1e3

    fsrv, pending, flush_lat = lat_server(), {}, []
    t0 = last = time.monotonic()
    for arrive_s, req in lat_trace:
        delay = t0 + arrive_s - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        pending[fsrv.submit(req)] = t0 + arrive_s
        if time.monotonic() - last >= 0.1:
            done = fsrv.flush()
            now = last = time.monotonic()
            flush_lat += [now - pending.pop(k) for k in done if k in pending]
    done = fsrv.flush()
    now = time.monotonic()
    flush_lat += [now - pending.pop(k) for k in done if k in pending]
    flush_span = now - t0
    check(not pending and len(flush_lat) == len(lat_trace),
          f"latency: the flush baseline lost {len(pending)} requests")
    csrv, fired = lat_server(), []
    with StencilScheduler(csrv) as lsched:
        t0 = time.monotonic()
        for arrive_s, req in lat_trace:
            delay = t0 + arrive_s - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            fired.append((t0 + arrive_s, lsched.submit(req), req))
        lsched.drain()
        cont_span = time.monotonic() - t0
    check(all(t.done() and t.exception() is None for _, t, _ in fired),
          "latency: the scheduler dropped or failed requests")
    cont_lat = [t.completed_at - due for due, t, _ in fired]
    rsrv = lat_server()
    lat_bitwise = all(np.array_equal(t.result(), rsrv.serve([req])[0])
                      for _, t, req in fired[::5])
    check(lat_bitwise, "latency: a scheduled result differs from serve()")
    emit(phase="latency", requests=len(lat_trace), rate_hz=300.0,
         designs=names, flush_interval_s=0.1,
         flush_grids_per_s=len(lat_trace) / flush_span,
         flush_p50_ms=pct(flush_lat, 50), flush_p99_ms=pct(flush_lat, 99),
         continuous_grids_per_s=len(lat_trace) / cont_span,
         continuous_p50_ms=pct(cont_lat, 50),
         continuous_p99_ms=pct(cont_lat, 99),
         continuous_batches=lsched.stats()["dispatched_batches"],
         bitwise_vs_serve_sampled=len(fired[::5]))

    # ---- 13. router: two workers on this card over one store -------------
    from repro_torch.serve import StencilRouter

    router_dir = root / "build" / "router_store"
    shutil.rmtree(router_dir, ignore_errors=True)
    ladder = ShapeBucketer(ladder=SERVE_LADDER)
    t0 = time.perf_counter()
    router = StencilRouter(router_dir, replicas=2, max_batch=4, warmup=True,
                           device="cuda")
    try:
        spawn_s = time.perf_counter() - t0
        for mode in SERVE_MODES:
            router.register(mode.split()[0], serve_spec(mode, paper),
                            bucketing=ladder)
        register_s = time.perf_counter() - t0 - spawn_s
        after_register = router.ping()
        second = after_register["replica-1"]
        check(second["cache"]["jit_builds"] == 0
              and second["cache"]["autotune_calls"] == 0
              and second["store"]["executable_hits"] >= 1,
              f"router: the second worker did not start warm: {second}")
        reqs = [req for _, req, _ in trace]
        t0 = time.perf_counter()
        outs = router.serve(reqs)
        route_s = time.perf_counter() - t0
        router_bitwise = all(np.array_equal(o, served[mode][i])
                             for o, (mode, _, i) in zip(outs, trace))
        check(router_bitwise, "router: differs from the in-process server")
        before_kill = router.ping()
        # kill the owner of one design with the trace in flight
        futures = [router.submit(req) for req in reqs]
        owner = router._route("zero")
        with router._lock:
            in_flight = sum(1 for _, rep in router._pending.values()
                            if rep is owner)
        owner.proc.kill()
        handed = [f.result(timeout=600.0) for f in futures]
        handoff_bitwise = all(np.array_equal(o, served[mode][i])
                              for o, (mode, _, i) in zip(handed, trace))
        check(not owner.healthy, "router: the killed worker was not detected")
        check(in_flight >= 1, "router: nothing was in flight at the kill")
        check(handoff_bitwise, "router: a handed-off result differs")
        after_kill = router.ping()
    finally:
        router.close()
    check(all(r.proc.poll() is not None for r in router._replicas),
          "router: close() left a worker running")
    emit(phase="router", replicas=2, device="cuda", requests=len(reqs),
         spawn_s=spawn_s, register_s=register_s, route_s=route_s,
         grids_per_s=len(reqs) / route_s, bitwise_vs_serve=router_bitwise,
         per_replica={n: dict(completed=i["scheduler"]["completed"],
                              launches=i["launches"], cache=i["cache"],
                              store=i["store"])
                      for n, i in before_kill.items()},
         killed=owner.name, in_flight_at_kill=in_flight,
         handoff_bitwise=handoff_bitwise,
         survivor={n: dict(completed=i["scheduler"]["completed"],
                           launches=i["launches"])
                   for n, i in after_kill.items() if i["healthy"]})

    # ---- 14. bench: the port's benchmark gates on the card ---------------
    stencil.stencil_cuda.launches = 0
    pipeline.stencil_cuda_batched.launches = 0
    for got in bench_phase(root, dev):
        emit(phase="bench", nvidia_smi=smi, **got)
    bench_launches = {"stencil_cuda": stencil.stencil_cuda.launches,
                      "stencil_cuda_batched":
                          pipeline.stencil_cuda_batched.launches}
    check(all(v > 0 for v in bench_launches.values()),
          f"bench: a tile kernel never launched: {bench_launches}")

    # ---- 15. lm_serve: granite-3-2b through ServeEngine -------------------
    from repro_torch.configs import base as arch_configs

    emit(phase="lm_serve", nvidia_smi=smi, **lm_serve(
        dev, arch_configs.get(LM_ARCH), LM_TRAFFIC, gpu.hbm_bw,
        kernel_launches))

    # ---- 16. lm_mixers: the MoE, SSM and hybrid families ------------------
    for got in lm_mixers(dev, LM_TRAFFIC, gpu.hbm_bw, kernel_launches):
        emit(phase="lm_mixers", nvidia_smi=smi, **got)

    # ---- 17. lm_train: the port's Trainer at full width ------------------
    for got in lm_train_phase(dev, gpu.hbm_bw,
                              root / "build" / "lm_train_ckpt",
                              kernel_launches):
        emit(phase="lm_train", nvidia_smi=smi, **got)

    # ---- 18. lm_launch: the sharded layer ---------------------------------
    for got in lm_launch_phase(dev, root, kernel_launches):
        emit(phase="lm_launch", nvidia_smi=smi, **got)

    # ---- 19. examples: the port's examples, each in its own process -------
    for got in examples_phase(root, kernel_launches):
        emit(phase="examples", nvidia_smi=smi, **got)

    kernels = [
        dict(name="stencil_cuda", route="cuda",
             source="src/repro_torch/kernels/csrc/stencil_tile.cuh",
             replaces="src/repro/kernels/stencil.py:96",
             launches=main_launches["stencil_cuda"]
             + bench_launches["stencil_cuda"],
             launches_by_phase=dict(main=main_launches["stencil_cuda"],
                                    bench=bench_launches["stencil_cuda"]),
             max_abs_err=k1_err, ms=k1_ms,
             plain_ms=k1_plain_ms, bound_ms=k1_bound, bound_by=k1_by,
             bound_share=k1_bound / k1_ms, library_ms=library_ms,
             serve_launches=serve_launches["stencil_cuda"],
             streamed_max_rel_err=streamed_err),
        dict(name="stencil_cuda_batched", route="cuda",
             source="src/repro_torch/kernels/csrc/stencil_tile.cuh",
             replaces="src/repro/kernels/pipeline.py:85",
             launches=main_launches["stencil_cuda_batched"]
             + bench_launches["stencil_cuda_batched"],
             launches_by_phase=dict(
                 main=main_launches["stencil_cuda_batched"],
                 bench=bench_launches["stencil_cuda_batched"]),
             max_abs_err=k2_err, ms=k2_ms,
             plain_ms=k2_plain_ms, bound_ms=k2_bound, bound_by=k2_by,
             bound_share=k2_bound / k2_ms, library_ms=k2_library_ms,
             serve_launches=serve_launches["stencil_cuda_batched"],
             streamed_max_rel_err=streamed_err),
    ]
    check(all(k["launches"] > 0 for k in kernels), "a kernel never launched")
    emit(kernels=kernels)
    emit(ok=True, device={"platform": "gpu", "kind": card,
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--lm-launch-child"]:
        sys.exit(lm_launch_child(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--example-child"]:
        sys.exit(example_child(*sys.argv[2:]))
    sys.exit(main())
