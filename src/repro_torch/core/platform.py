"""Hardware platform descriptions for the analytical model (PyTorch port).

* :class:`FPGAPlatform` — the paper's target (Xilinx Alveo U280), verbatim
  from ``repro.core.platform``: the paper-exact model (Eqs. 1-9) ranks on it.

* :class:`GPUPlatform` — the port's target, one NVIDIA H100.  Figures are
  the data-sheet values of each SKU (NVIDIA H100 Tensor Core GPU data
  sheet; Hopper architecture white paper for SM count, shared memory per
  block and L2).  ``fp32_flops`` is the CUDA-core float32 rate (the
  stencils do not use the tensor cores); rates assume the full power
  limit (700 W for the SXM part, 350 W for PCIe), which ``chip_smoke.py``
  prints beside every measurement.
  ``launch_s`` is the model's assumed fixed cost of one kernel launch, an
  assumption to be calibrated against chip runs, not a data-sheet figure.
  ``cell_update_s`` is the card's time per stage cell update of the tile
  kernel (one cell of one stage's region, all SMs busy) and
  ``full_rate_blocks`` the thread blocks an SM must hold for that rate;
  both are measured on the card (``chip_smoke.py`` phase ``sweep``), not
  data-sheet figures.  ``smem_per_sm`` is the shared memory of one SM, of
  which each resident block also takes 1 KB for the system.
  ``num_gpus`` is the size of the device pool the multi-device designs
  rank over (:meth:`GPUPlatform.with_gpus`); ``link_bw`` is one
  direction of one card's peer link, from the same data sheets (SXM:
  NVLink, 900 GB/s per GPU in both directions together; PCIe: the PCIe
  Gen5 row, 128 GB/s in both directions, since the NVLink bridge of the
  PCIe card joins only a pair).  ``link_latency_s``, the fixed cost of
  one peer copy, is an assumption, as ``launch_s`` is.  ``eager_op_s`` is
  the host time of one eager torch operator on the shard path (each
  launches one small kernel), measured by ``tools/shard_profile.py``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FPGAPlatform:
    """Xilinx Alveo U280 (paper Section 5.1)."""

    name: str = "xilinx-u280"
    freq_hz: float = 225e6                 # target frequency; >=225MHz saturates HBM
    hbm_banks: int = 32
    bank_bw: float = 14.4e9                # 512b/cycle @ 225MHz
    num_slrs: int = 3
    # chip resources (U280 datasheet)
    luts: int = 1_304_000
    ffs: int = 2_607_000
    brams: int = 2_016                     # BRAM36 blocks
    dsps: int = 9_024
    alpha: float = 0.75                    # Eq. 1 utilisation constraint
    reserved_banks: int = 2                # shell/host-reserved HBM banks
    axi_bits: int = 512


@dataclasses.dataclass(frozen=True)
class GPUPlatform:
    """One NVIDIA Hopper card (data-sheet figures of one SKU)."""

    name: str = "h100-sxm"
    hbm_bw: float = 3.35e12               # B/s, 80 GB HBM3
    sms: int = 132
    smem_per_block: int = 232_448         # 227 KB opt-in dynamic shared memory
    smem_per_sm: int = 233_472            # 228 KB of shared memory per SM
    l2_bytes: int = 50 * 2**20
    fp32_flops: float = 67e12             # CUDA-core float32, dense
    launch_s: float = 5e-6                # assumed per-launch cost (model)
    # Seconds per stage cell update of the tile kernel, card-wide, with at
    # least full_rate_blocks blocks resident per SM: the median over the
    # sweep's configurations with s >= 4 and >= 3 resident blocks of
    # (measured - memory term) / updates, JACOBI2D 4096x4096 on an
    # "NVIDIA H100 80GB HBM3, 700.00 W" card (chip_smoke.py sweep_summary).
    cell_update_s: float = 1.478e-12
    full_rate_blocks: int = 3
    num_gpus: int = 1                     # device pool the ranker weighs
    link_bw: float = 450e9                # B/s, NVLink, one direction
    link_latency_s: float = 5e-6          # assumed per-copy cost (model)
    # Host seconds per eager operator of the shard path: a shard run's
    # time over the operators the model counts for it, spatial_s and
    # hybrid_r(s=4) on JACOBI2D 9720x1024 over four logical devices of an
    # "NVIDIA H100 80GB HBM3, 700.00 W" card (tools/shard_profile.py): the
    # median of 13.7-24.1 us measured on three machines.
    eager_op_s: float = 1.87e-5

    def with_gpus(self, n: int) -> "GPUPlatform":
        """The same card in a pool of ``n``."""
        return dataclasses.replace(self, num_gpus=n)


H100_SXM = GPUPlatform()
# PCIe: the SXM update cost scaled by the float32 rates (not measured)
H100_PCIE = GPUPlatform(
    name="h100-pcie", hbm_bw=2.0e12, sms=114, fp32_flops=51e12,
    link_bw=64e9,
    cell_update_s=H100_SXM.cell_update_s * 67 / 51,
)


def gpu_platform_for(device_name: str) -> GPUPlatform:
    """The SKU row for a ``torch.cuda.get_device_name`` / ``nvidia-smi``
    name ("NVIDIA H100 80GB HBM3" is the SXM part, "NVIDIA H100 PCIe" the
    PCIe one); unknown names get the SXM row."""
    return H100_PCIE if "pcie" in device_name.lower() else H100_SXM


DEFAULT_FPGA = FPGAPlatform()
DEFAULT_GPU = H100_SXM
