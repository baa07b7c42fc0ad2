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
    l2_bytes: int = 50 * 2**20
    fp32_flops: float = 67e12             # CUDA-core float32, dense
    launch_s: float = 5e-6                # assumed per-launch cost (model)


H100_SXM = GPUPlatform()
H100_PCIE = GPUPlatform(name="h100-pcie", hbm_bw=2.0e12, sms=114, fp32_flops=51e12)


def gpu_platform_for(device_name: str) -> GPUPlatform:
    """The SKU row for a ``torch.cuda.get_device_name`` / ``nvidia-smi``
    name ("NVIDIA H100 80GB HBM3" is the SXM part, "NVIDIA H100 PCIe" the
    PCIe one); unknown names get the SXM row."""
    return H100_PCIE if "pcie" in device_name.lower() else H100_SXM


DEFAULT_FPGA = FPGAPlatform()
DEFAULT_GPU = H100_SXM
