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
  included) and writes the grid once, and every stage updates the cells
  of its region of the shrinking trapezoid, each at a cost per cell
  update measured on the card.  The fusion limit, the window bytes and
  the updates come from the round plan the kernel launches
  (:func:`repro_torch.kernels.tiling.round_plan`), so the ranker and the
  kernel share one source of truth.

    FPGA concept                      GPU concept
    ------------                      -----------
    PE streaming one HBM bank         thread blocks streaming HBM windows
    s cascaded PEs (FIFO dataflow)    s fused iterations per shared-memory
                                      residency (temporal blocking)
    redundant halo compute            redundant halo compute (identical)

  Latency = compute + HBM + one launch per round.

  On a pool of ``num_gpus`` cards the row-partitioned variants (spatial_r,
  spatial_s, hybrid_r, hybrid_s) are priced as they run: eager torch on
  each shard's band (rows plus the variant's halo rows), paced by the
  host launching one kernel per operator, with the halo exchanges over
  the card's peer link (``link_bw``, ``link_latency_s``) at the
  reference's bytes and message counts.
"""
from __future__ import annotations

import dataclasses
import math
from repro_torch.core.platform import FPGAPlatform, GPUPlatform
from repro_torch.core.spec import BinOp, Call, Neg, StencilSpec, walk
from repro_torch.kernels.tiling import default_tile, round_plan

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
    cell_updates: float = 0.0   # GPU: stage cell updates over the whole run
    host_term: float = 0.0      # GPU shard path: seconds of eager launches
    launches: int = 0           # GPU shard path: operators launched per run
    notes: str = ""

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_term,
            "memory": self.memory_term,
            "collective": self.collective_term,
            "host": self.host_term,
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
    round plan (:func:`~repro_torch.kernels.tiling.round_plan`), so the
    ranker never picks a depth the kernel would refuse.
    """
    s = 1
    while s < cap and round_plan(spec, s + 1, tile).smem_bytes <= gpu.smem_per_block:
        s += 1
    return s


def predict_gpu(
    spec: StencilSpec,
    cfg: ParallelismConfig,
    gpu: GPUPlatform,
    iterations: int | None = None,
) -> Prediction:
    """Latency of one configuration on the CUDA tile kernel.

    A row-partitioned configuration (``k > 1``, not temporal) runs no
    tile kernel and is priced by :func:`_predict_shard`; the rest of this
    docstring is the single-device model, which also prices a temporal
    configuration on any pool (the runners fuse its stages on one card).

      * HBM term: per round every floating input window is read (tile +
        2sr per axis), and every halo-index map window (int32) once for
        the belt bounds, and every grid cell written once.  Streamed wrap
        maps are read between rounds by a per-axis gather over the grid
        (map and iterate read, iterate written);
      * compute term: the cell updates of every stage's region of the
        shrinking trapezoid, summed over tiles and rounds (a ragged last
        round has its own, shallower trapezoid), at ``gpu.cell_update_s``
        each.  With fewer than ``gpu.full_rate_blocks`` blocks resident
        per SM (shared memory bound) an update costs more, by the square
        root of the shortfall (measured: 1.2x at 2 blocks, 1.7x at 1).
        Blocks of a streamed spec past a request's real region update more
        (the kernel's head comment); they are not charged;
      * the launches: K1 (``buffer_depth=0``) launches once per grid per
        round, K2 (``buffer_depth >= 2``) once per round for the whole
        batch (``runtime/batching.py``), so a grid's share of K2's launch
        is ``1 / batch_tile`` of it.  This is the card's counterpart of
        the reference amortising K2's pipeline fill over ``batch_tile``
        grids (``repro.core.model.predict_tpu``).

    The terms add: a block waits for its windows before its first stage
    and writes its tile after its last, and on the card the sum tracks
    the measured time where the larger term alone falls short.
    """
    it = spec.iterations if iterations is None else iterations
    if cfg.variant != "temporal" and cfg.k > 1:
        return _predict_shard(spec, cfg, gpu, it)
    s = max(min(cfg.s, it), 1)
    if spec.wrap_index_inputs:
        s = min(s, max(spec.wrap_round_depth, 1))
    rounds = math.ceil(it / s)
    tile = default_tile(spec.ndim, cfg.tile_rows)
    full = round_plan(spec, s, tile)
    last = round_plan(spec, it - (rounds - 1) * s, tile)
    bytes_per_round = (
        (full.window_cells + spec.cells) * spec.itemsize
        + len(spec.halo_index_inputs) * full.tiles * math.prod(full.window) * 4
    )
    rewrap = len(spec.wrap_index_inputs) * spec.cells * (4 + 2 * spec.itemsize)
    hbm_bytes = float(bytes_per_round * rounds + rewrap * (rounds - 1))
    updates = float((rounds - 1) * full.issued + last.issued)
    flops = float((rounds - 1) * full.flops + last.flops)
    smem = full.smem_bytes
    memory_term = hbm_bytes / gpu.hbm_bw
    rate = min(1.0, resident_blocks(smem, gpu) / gpu.full_rate_blocks) ** 0.5
    compute_term = updates * gpu.cell_update_s / rate
    k2 = cfg.buffer_depth >= 2
    launch_term = rounds * gpu.launch_s / (max(cfg.batch_tile, 1) if k2 else 1)
    notes = "batch-in-grid" if k2 else ""
    return Prediction(
        config=cfg,
        latency=compute_term + memory_term + launch_term,
        compute_term=compute_term,
        memory_term=memory_term,
        collective_term=0.0,
        collective_bytes=0.0,
        hbm_bytes=hbm_bytes,
        flops=flops,
        rounds=rounds,
        smem_bytes=float(smem),
        cell_updates=updates,
        notes=notes,
    )


def _predict_shard(
    spec: StencilSpec, cfg: ParallelismConfig, gpu: GPUPlatform, it: int
) -> Prediction:
    """One run of a ``k``-way row partition as the shard runner executes
    it (:mod:`repro_torch.core.distribute`): eager torch over each shard's
    band, one small kernel per operator of the tile body, all launched by
    one host thread.  No CUDA kernel of the port runs on this path.

      * host term: the operators launched, times ``gpu.eager_op_s``
        (measured).  Each block call runs the operators
        :func:`repro_torch.core.distribute.block_call_work` counts for its
        depth; each halo exchange of one input adds a concatenation per
        shard, two zero edges unless it wraps, and its peer copies;
      * memory term: each block call's whole-band passes, each reading two
        band-sized operands and writing one, on one card (the shards run
        in parallel, one per card).  The band is the shard's
        ``ceil(R / k)`` rows plus the variant's halo rows: ``it * r`` on
        each side for the ``*_r`` variants, ``step * r`` for the others;
      * collective term: the reference's bytes and message counts
        (``repro.core.model.predict_tpu``) over ``gpu.link_bw``, plus
        ``gpu.link_latency_s`` per message.

    The host issues kernels ahead of the card, so the larger of the host
    and memory terms paces the run; the collectives add to it.
    """
    from repro_torch.core.distribute import block_call_work

    R, C, r, k = spec.rows, spec.cols_flat, spec.radius, cfg.k
    itemsize = spec.itemsize
    s = 1 if cfg.variant in ("spatial_r", "spatial_s") else max(min(cfg.s, it), 1)
    rounds = math.ceil(it / s)
    steps = [s] * (rounds - 1) + [it - (rounds - 1) * s]
    rows_local = math.ceil(R / k)
    if cfg.variant in ("spatial_r", "hybrid_r"):
        halo = min(it * r, rows_local)
        coll_bytes = 2 * halo * C * itemsize * spec.num_inputs
        n_msgs = 2
        exchanges = spec.num_inputs
    else:
        halo = s * r
        h = r if cfg.variant == "spatial_s" else min(s * r, rows_local)
        coll_bytes = 2 * h * C * itemsize * rounds
        n_msgs = 2 * rounds
        exchanges = (spec.num_inputs - 1 + it if cfg.variant == "spatial_s"
                     else spec.num_inputs * rounds)
    wrap = spec.boundary.kind == "periodic"
    per_exchange = k + (2 * k if wrap else 2 + 2 * (k - 1))
    work = [block_call_work(spec, step) for step in steps]
    launches = k * sum(w[0] for w in work) + exchanges * per_exchange
    band_bytes = (rows_local + 2 * halo) * C * itemsize
    hbm_bytes = float(3 * band_bytes * sum(w[1] for w in work))
    host_term = launches * gpu.eager_op_s
    memory_term = hbm_bytes / gpu.hbm_bw
    collective_term = coll_bytes / gpu.link_bw + n_msgs * gpu.link_latency_s
    return Prediction(
        config=cfg,
        latency=max(host_term, memory_term) + collective_term,
        compute_term=0.0,
        memory_term=memory_term,
        collective_term=collective_term,
        collective_bytes=float(coll_bytes),
        hbm_bytes=hbm_bytes,
        flops=0.0,
        rounds=rounds,
        host_term=host_term,
        launches=launches,
        notes="shard (eager torch)",
    )


def resident_blocks(smem: int, gpu: GPUPlatform) -> int:
    """Thread blocks of the tile kernel one SM holds at once: its shared
    memory (1 KB per block taken by the system) or its 2048 threads."""
    return max(1, min(2048 // 256, gpu.smem_per_sm // (smem + 1024)))


# Row extents of the kernel tile the ranker weighs, per number of axes
# (0 = the default tile's); a bigger tile cuts the halo's redundant
# updates and costs shared memory.
TILE_ROWS = {1: (0, 1024), 2: (0, 64, 128), 3: (0, 16)}


def gpu_candidate_configs(
    spec: StencilSpec, gpu: GPUPlatform, iterations: int | None = None
) -> list[ParallelismConfig]:
    """The design space on a pool of ``gpu.num_gpus`` cards.

    Single-device: temporal ``k=1`` for every tile row extent of
    :data:`TILE_ROWS` at every fusion depth the shared memory allows, each
    as K1 (``buffer_depth=0``) and as the batch-in-grid K2
    (``buffer_depth=2``, ``batch_tile=8`` as in the reference).  Then, for every ``k > 1`` dividing the pool,
    the row-partitioned variants at every fusion depth up to ``it`` (the
    shard path holds no tile, so ``tile_rows`` is 0 and shared memory sets
    no limit), under the reference's guards
    (``repro.core.model.tpu_candidate_configs``): ``R // k >= 2r``,
    ``it * r <= R // k`` for the ``*_r`` variants and ``s * r <= R // k``
    for ``hybrid_s``.
    """
    it = spec.iterations if iterations is None else iterations
    r = spec.radius
    out: list[ParallelismConfig] = []
    seen = set()
    for rows in TILE_ROWS[spec.ndim]:
        tile = default_tile(spec.ndim, rows)
        plan = round_plan(spec, 1, tile)
        if plan.tile in seen or (rows and plan.smem_bytes > gpu.smem_per_block):
            # the grid clips it to a tile already weighed, or a taller tile
            # does not fit (the default one stays, for SASA401 to report)
            continue
        seen.add(plan.tile)
        s_max = smem_fusion_limit(spec, gpu, tile, cap=it)
        for s in _fusion_depths(min(it, s_max)):
            out.append(ParallelismConfig("temporal", k=1, s=s, tile_rows=rows))
            out.append(ParallelismConfig(
                "temporal", k=1, s=s, tile_rows=rows,
                batch_tile=8, buffer_depth=2,
            ))
    n = gpu.num_gpus
    for k in range(2, n + 1):
        rows_local = spec.rows // k
        if n % k or rows_local < 2 * r:
            continue
        if it * r <= rows_local:
            out.append(ParallelismConfig("spatial_r", k=k))
        out.append(ParallelismConfig("spatial_s", k=k))
        for s in _fusion_depths(it)[1:]:
            if s * r <= rows_local:
                out.append(ParallelismConfig("hybrid_s", k=k, s=s))
            if it * r <= rows_local:
                out.append(ParallelismConfig("hybrid_r", k=k, s=s))
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
