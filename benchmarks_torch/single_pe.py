"""Paper Fig. 8: single-PE resource usage -- SODA's distributed reuse
buffers and line buffer against SASA's coalesced reuse buffer; the port's
counterpart of ``benchmarks/single_pe.py``.

The FPGA rows (the modelled BRAM/FF/LUT numbers, a stand-in for Vitis
synthesis) equal the reference's.  The reference's TPU translation, VMEM
bytes of a fused tile, becomes the CUDA tile kernel's shared memory per
thread block (:func:`repro_torch.kernels.stencil.smem_bytes_estimate`, on
the default tile) at ``s`` in {1, 4}, checked against the card's
``smem_per_block``: the coalesced buffer is one shared-memory window per
block instead of per-tap FIFO slices."""
from __future__ import annotations

from repro_torch.configs import stencils
from repro_torch.core.model import estimate_pe_resources
from repro_torch.core.platform import DEFAULT_FPGA, DEFAULT_GPU
from repro_torch.kernels.stencil import smem_bytes_estimate

BENCHES = ["jacobi2d", "jacobi3d", "blur", "seidel2d", "dilate", "hotspot",
           "heat3d", "sobel2d"]


def soda_style_resources(spec, fpga, U=16):
    """SODA baseline: adds the 512-bit line buffer and per-tap narrow FIFO
    overhead that the coalesced design removes (Sec. 3.1 / Fig. 3)."""
    base = estimate_pe_resources(spec, fpga, U)
    # line buffer: one row of 512b words double-buffered per input
    line_buffer_bytes = 2 * spec.cols_flat * spec.itemsize * spec.num_inputs
    # distributed FIFOs: one BRAM-min per tap channel (U channels per tap)
    taps = spec.points
    distributed_overhead = taps * 1.0 + line_buffer_bytes / 4608
    out = dict(base)
    out["bram"] = base["bram"] + distributed_overhead
    out["ff"] = base["ff"] * 1.25       # extra fan-out registers
    out["lut"] = base["lut"] * 1.15
    return out


def run(device=None):
    del device          # analytic rows
    rows = []
    fpga, gpu = DEFAULT_FPGA, DEFAULT_GPU
    for name in BENCHES:
        shape = (9720, 32, 32) if name in stencils.BENCHMARKS_3D \
            else (9720, 1024)
        spec = stencils.get(name, shape=shape, iterations=4)
        ours = estimate_pe_resources(spec, fpga)
        soda = soda_style_resources(spec, fpga)
        bram_red = 100 * (1 - ours["bram"] / soda["bram"])
        rows.append(
            f"fig8/single_pe/{name},0.00,"
            f"bram_ours={ours['bram']:.0f};bram_soda={soda['bram']:.0f};"
            f"bram_reduction_pct={bram_red:.1f};dsp={ours['dsp']:.0f};"
            f"lut={ours['lut']:.0f}")
        # H100 translation: shared memory of one tile's block at s in {1, 4}
        for s in (1, 4):
            sm = smem_bytes_estimate(spec, s)
            rows.append(
                f"fig8/smem_tile/{name}/s{s},0.00,"
                f"smem_bytes={sm};smem_per_block={gpu.smem_per_block};"
                f"fits={sm <= gpu.smem_per_block}")
    return rows
