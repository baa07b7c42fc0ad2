"""SASA analytical performance model (paper Section 4.2) + H100 re-derivation.

PyTorch port of ``repro.core.model``.  Part 1 is the reference's, verbatim.
Part 2 replaces the TPU model: its VMEM fusion limit assumed a 64 MiB
scratchpad holding the whole padded column extent, which a GPU block's
227 KB of shared memory does not have.

Part 1 — paper-exact model (Eqs. 1-9) in FPGA cycles for the Alveo U280.
  Used to reproduce the paper's own parallelism decisions (Table 3) and the
  SODA-vs-SASA speedups (Sec. 5.4).  Resource estimates per PE are a
  microarchitectural byte/op model calibrated against the paper's reported
  max-PE counts (Figs. 18-20); they stand in for the Vitis HLS synthesis
  report that step 2 of the paper's tool flow runs.

Part 2 — GPU model for the CUDA tile kernel (one card).  A round of ``s``
  fused iterations launches one kernel over every tile of every axis; per
  round it reads each input window (tile + 2sr per axis, halo overlap
  included) and writes the grid once, and it computes ``s`` stages over
  every window cell.  The fusion limit comes from the kernel's own tile
  geometry (:func:`repro_torch.kernels.stencil.smem_bytes_estimate`), so
  the ranker and the kernel share one source of truth.

    FPGA concept                      GPU concept
    ------------                      -----------
    PE streaming one HBM bank         thread blocks streaming HBM windows
    s cascaded PEs (FIFO dataflow)    s fused iterations per shared-memory
                                      residency (temporal blocking)
    redundant halo compute            redundant halo compute (identical)

  Latency = max(compute, HBM) + one launch per round.
"""
from __future__ import annotations

import dataclasses
import math
from repro_torch.core.platform import FPGAPlatform, GPUPlatform
from repro_torch.core.spec import BinOp, Call, Neg, StencilSpec, walk
from repro_torch.kernels.stencil import (
    default_tile,
    plan_blocks,
    smem_bytes_estimate,
)

VARIANTS = ("temporal", "spatial_r", "spatial_s", "hybrid_r", "hybrid_s")


@dataclasses.dataclass(frozen=True)
class ParallelismConfig:
    """A point in the SASA design space."""

    variant: str          # one of VARIANTS
    k: int = 1            # degree of spatial parallelism (devices / PE groups)
    s: int = 1            # degree of temporal parallelism (stages / fusion depth)
    tile_rows: int = 0    # GPU: row extent of the kernel tile (0 = default)
    batch_tile: int = 0   # batch entries folded into the kernel grid per
                          # step (0 = the whole batch)
    buffer_depth: int = 0  # 0 = one kernel launch per batch entry (K1,
                          # single_pe); >= 2 = the batch folded into the
                          # kernel grid (K2, tile_pipeline)

    def __post_init__(self):
        assert self.variant in VARIANTS, self.variant
        assert self.batch_tile >= 0, self.batch_tile
        assert self.buffer_depth in (0,) or self.buffer_depth >= 2, (
            "buffer_depth is 0 (vmapped one-shot) or >= 2 (pipelined); "
            "a single buffer cannot overlap copy with compute"
        )

    @property
    def devices_needed(self) -> int:
        """Device count this config occupies (temporal stages map to
        devices; every executor must size device pools from this)."""
        return max(self.s, 1) if self.variant == "temporal" else max(self.k, 1)


@dataclasses.dataclass(frozen=True)
class Prediction:
    config: ParallelismConfig
    latency: float              # seconds
    compute_term: float         # seconds
    memory_term: float          # seconds
    collective_term: float      # seconds
    collective_bytes: float     # per-device bytes over the whole run
    hbm_bytes: float            # per-device bytes over the whole run
    flops: float                # per-device ops over the whole run
    rounds: int
    smem_bytes: float = 0.0     # shared memory of one thread block
    notes: str = ""

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_term,
            "memory": self.memory_term,
            "collective": self.collective_term,
        }
        return max(terms, key=terms.get)

    @property
    def gcells_per_s(self) -> float:
        return 0.0  # filled by caller with grid knowledge; see predict()


# ===========================================================================
# Part 1: paper-exact FPGA model (Eqs. 1-9)
# ===========================================================================


def _op_mix(spec: StencilSpec) -> dict[str, int]:
    mix = {"add": 0, "mul": 0, "div": 0, "cmp": 0}
    for stage in spec.stages:
        for node in walk(stage.expr):
            if isinstance(node, BinOp):
                if node.op in "+-":
                    mix["add"] += 1
                elif node.op == "*":
                    mix["mul"] += 1
                else:
                    mix["div"] += 1
            elif isinstance(node, Call):
                mix["cmp"] += max(len(node.args) - 1, 1)
            elif isinstance(node, Neg):
                mix["add"] += 1
    return mix


def estimate_pe_resources(
    spec: StencilSpec, fpga: FPGAPlatform, U: int = 16
) -> dict[str, float]:
    """Per-PE resource vector (stand-in for the Vitis HLS synthesis report).

    Cost constants are fp32 operator costs on UltraScale+ (DSP48E2), with
    streaming infrastructure overhead calibrated so the derived max-PE
    counts match the paper's Figs. 18-20 (JACOBI2D 21, DILATE 18,
    HOTSPOT 9, others 9-15 on U280).
    """
    mix = _op_mix(spec)
    # DSPs: fp32 add/sub=2, mul=3, div=0 (LUT-heavy), cmp=0; one op set per PU.
    dsp = U * (2 * mix["add"] + 3 * mix["mul"])
    # LUTs: per-PU datapath + per-PE streaming infra + reuse-buffer muxing.
    lut = (
        9_000  # AXI-stream plumbing, control FSM
        + U * (120 * mix["add"] + 90 * mix["mul"] + 3_000 * mix["div"]
               + 150 * mix["cmp"])
        + 250 * spec.points * (1 + spec.radius)
    )
    ff = 2.2 * lut
    # BRAM: coalesced reuse buffer holds `halo` rows of every streamed input
    # at 512b width (Sec. 3.1).  4.5 KiB per BRAM36.
    reuse_bytes = (
        spec.halo * spec.cols_flat * spec.itemsize * max(spec.num_inputs, 1)
    )
    bram = max(2.0, reuse_bytes / 4608) + 4 * spec.num_inputs
    return {"lut": lut, "ff": ff, "dsp": float(dsp), "bram": bram}


def fpga_pe_res(spec: StencilSpec, fpga: FPGAPlatform, U: int = 16) -> int:
    """Eq. 1: resource-bound PE count."""
    res = estimate_pe_resources(spec, fpga, U)
    avail = {
        "lut": fpga.luts,
        "ff": fpga.ffs,
        "dsp": fpga.dsps,
        "bram": fpga.brams,
    }
    bound = min(fpga.alpha * avail[r] / max(res[r], 1e-9) for r in avail)
    return max(int(bound), 1)


def fpga_pe_bw(spec: StencilSpec, fpga: FPGAPlatform) -> int:
    """Eq. 2: bandwidth-bound spatial PE count."""
    banks_per_pe = spec.num_inputs + 1
    return max((fpga.hbm_banks - fpga.reserved_banks) // banks_per_pe, 1)


def fpga_max_pe(spec: StencilSpec, fpga: FPGAPlatform, s: int = 1) -> int:
    """Eq. 3 (temporal stages need no extra bandwidth)."""
    return min(fpga_pe_res(spec, fpga), fpga_pe_bw(spec, fpga) * max(s, 1))


def _fpga_latency_cycles(
    spec: StencilSpec, cfg: ParallelismConfig, fpga: FPGAPlatform, U: int = 16
) -> float:
    """Eqs. 4-8, verbatim (two-dimensional view: R rows x C flat columns)."""
    R, C = spec.rows, spec.cols_flat
    it = spec.iterations
    r = spec.radius
    d = halo = 2 * r
    k, s = cfg.k, cfg.s
    if cfg.variant == "temporal":
        return math.ceil((R + d * (s - 1)) * C / U) * math.ceil(it / s)
    if cfg.variant == "spatial_r":
        iter_avg = it / 2.0  # paper: halo shrinks over iterations, avg iter/2
        return math.ceil((math.ceil(R / k) + halo * iter_avg) * C / U) * it
    if cfg.variant == "spatial_s":
        return math.ceil((math.ceil(R / k) + halo) * C / U) * it
    if cfg.variant == "hybrid_r":
        iter_avg = it / 2.0
        return (
            math.ceil((math.ceil(R / k) + halo * iter_avg) * C / U)
            * math.ceil(it / s)
        )
    if cfg.variant == "hybrid_s":
        return (
            math.ceil((math.ceil(R / k) + halo * s) * C / U)
            * math.ceil(it / s)
        )
    raise ValueError(cfg.variant)


def predict_fpga(
    spec: StencilSpec, cfg: ParallelismConfig, fpga: FPGAPlatform, U: int = 16
) -> Prediction:
    cycles = _fpga_latency_cycles(spec, cfg, fpga, U)
    lat = cycles / fpga.freq_hz
    # Roofline bookkeeping for reporting parity with the GPU model.
    hbm = spec.cells * spec.itemsize * (spec.num_inputs + 1)
    if cfg.variant in ("spatial_r", "spatial_s"):
        hbm *= spec.iterations
    else:
        hbm *= math.ceil(spec.iterations / max(cfg.s, 1))
    return Prediction(
        config=cfg,
        latency=lat,
        compute_term=lat,
        memory_term=hbm / (cfg.k * fpga.bank_bw * max(spec.num_inputs, 1)),
        collective_term=0.0,
        collective_bytes=0.0,
        hbm_bytes=hbm / max(cfg.k, 1),
        flops=spec.cells * spec.ops_per_cell * spec.iterations / max(cfg.k, 1),
        rounds=math.ceil(spec.iterations / max(cfg.s, 1)),
    )


def fpga_candidate_configs(
    spec: StencilSpec,
    fpga: FPGAPlatform,
    U: int = 16,
    pe_res_override: int | None = None,
) -> list[ParallelismConfig]:
    """Step 3 of the tool flow (Sec. 4.3): the candidate set the paper explores.

    ``pe_res_override`` lets callers substitute a synthesizer-reported
    resource-bound PE count (the paper obtains this from Vitis HLS, Figs.
    18-20) for our analytical resource estimate.
    """
    pe_res = pe_res_override or fpga_pe_res(spec, fpga, U)
    pe_bw = fpga_pe_bw(spec, fpga)
    out = []
    # temporal: s_t = #PE_res, capped by iteration count
    out.append(ParallelismConfig("temporal", k=1, s=min(pe_res, spec.iterations)))
    # spatial: k = Max#PE (s=1)
    max_pe1 = min(pe_res, pe_bw)
    out.append(ParallelismConfig("spatial_r", k=max_pe1, s=1))
    out.append(ParallelismConfig("spatial_s", k=max_pe1, s=1))
    # hybrid: k multiple of #SLRs, k*s <= Max#PE(s), k <= PE_bw
    for k in range(fpga.num_slrs, pe_bw + 1, fpga.num_slrs):
        s = max(min(pe_res // k, spec.iterations), 1)
        if s >= 1 and k * s <= pe_res:
            out.append(ParallelismConfig("hybrid_r", k=k, s=s))
            out.append(ParallelismConfig("hybrid_s", k=k, s=s))
    return out


# ===========================================================================
# Part 2: GPU model (one H100, the CUDA tile kernel)
# ===========================================================================


def smem_fusion_limit(
    spec: StencilSpec, gpu: GPUPlatform, tile=None, cap: int = 256
) -> int:
    """Largest fusion depth ``s`` whose thread block fits in shared memory.

    The GPU analogue of Eq. 1's resource bound.  It asks the kernel's own
    :func:`~repro_torch.kernels.stencil.smem_bytes_estimate`, so the ranker
    never picks a depth the kernel would refuse.
    """
    from repro_torch.kernels.stencil import smem_bytes_estimate

    s = 1
    while s < cap and smem_bytes_estimate(spec, s + 1, tile) <= gpu.smem_per_block:
        s += 1
    return s


def predict_gpu(
    spec: StencilSpec,
    cfg: ParallelismConfig,
    gpu: GPUPlatform,
    iterations: int | None = None,
) -> Prediction:
    """Latency of one single-device configuration on the CUDA tile kernel.

      * HBM term: per round every input window is read (tile + 2sr per
        axis) and every grid cell written once;
      * compute term: every stage of every fused iteration runs over the
        whole window, ``ops_per_cell`` float32 operations per cell;
      * one kernel launch per round.
    """
    it = spec.iterations if iterations is None else iterations
    s = max(min(cfg.s, it), 1)
    rounds = math.ceil(it / s)
    tile = default_tile(spec.ndim, cfg.tile_rows)
    g = plan_blocks(spec, s, tile)
    window_cells = g["tiles"] * g["window_cells"]
    bytes_per_round = (
        spec.num_inputs * window_cells + spec.cells
    ) * spec.itemsize
    hbm_bytes = float(bytes_per_round * rounds)
    flops = float(window_cells * spec.ops_per_cell * it)
    memory_term = hbm_bytes / gpu.hbm_bw
    compute_term = flops / gpu.fp32_flops
    smem = smem_bytes_estimate(spec, s, tile)
    notes = "batch-in-grid" if cfg.buffer_depth >= 2 else ""
    return Prediction(
        config=cfg,
        latency=max(compute_term, memory_term) + rounds * gpu.launch_s,
        compute_term=compute_term,
        memory_term=memory_term,
        collective_term=0.0,
        collective_bytes=0.0,
        hbm_bytes=hbm_bytes,
        flops=flops,
        rounds=rounds,
        smem_bytes=float(smem),
        notes=notes,
    )


def gpu_candidate_configs(
    spec: StencilSpec, gpu: GPUPlatform, iterations: int | None = None
) -> list[ParallelismConfig]:
    """The single-device design space: temporal ``k=1`` at every fusion
    depth the shared memory allows, each as K1 (``buffer_depth=0``) and as
    the batch-in-grid K2 (``buffer_depth=2``)."""
    it = spec.iterations if iterations is None else iterations
    s_max = smem_fusion_limit(spec, gpu, default_tile(spec.ndim), cap=it)
    out: list[ParallelismConfig] = []
    for s in _fusion_depths(min(it, s_max)):
        out.append(ParallelismConfig("temporal", k=1, s=s))
        out.append(ParallelismConfig("temporal", k=1, s=s, buffer_depth=2))
    return out


def _fusion_depths(s_max: int) -> list[int]:
    out = [1]
    s = 2
    while s <= s_max:
        out.append(s)
        s *= 2
    if s_max not in out and s_max > 1:
        out.append(s_max)
    return out


def choose_best(
    spec: StencilSpec,
    platform,
    iterations: int | None = None,
    pe_res_override: int | None = None,
    tie_eps: float = 0.05,
    optimize: bool = True,
) -> list[Prediction]:
    """Eq. 9: rank candidate configurations by predicted latency.

    Configurations within ``tie_eps`` of the fastest are re-ranked by
    resource efficiency (fewest spatial groups = fewest HBM banks / ICI
    links), matching the paper's "choose the most resource-efficient one"
    tie-break (Sec. 4.3 step 3).

    With ``optimize`` (the default) the spec is first lowered through the
    IR pass pipeline (:mod:`repro.core.ir`), so compute terms and op-mix
    resource estimates are derived from *post-optimization* op counts —
    the counts the executors actually run — rather than the raw DSL's.
    Callers that already hold a lowered spec pass ``optimize=False``.
    """
    if optimize:
        from repro_torch.core.ir import lower

        spec = lower(spec).spec
    if isinstance(platform, FPGAPlatform):
        cfgs = fpga_candidate_configs(spec, platform, pe_res_override=pe_res_override)
        preds = [predict_fpga(spec, c, platform) for c in cfgs]
    else:
        cfgs = gpu_candidate_configs(spec, platform, iterations)
        preds = [predict_gpu(spec, c, platform, iterations) for c in cfgs]
    preds.sort(key=lambda p: p.latency)
    best = preds[0].latency
    near = [p for p in preds if p.latency <= best * (1 + tie_eps)]
    rest = [p for p in preds if p.latency > best * (1 + tie_eps)]
    near.sort(key=lambda p: (p.config.k, p.latency, -p.config.s))
    return near + rest
