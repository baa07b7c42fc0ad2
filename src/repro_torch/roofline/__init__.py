from repro_torch.roofline.analysis import (
    H100_HBM_BW, H100_NVLINK_BW, H100_PEAK_BF16, OpCounter, RooflineReport,
    analyze_step, roofline_from_step,
)

__all__ = [
    "analyze_step", "roofline_from_step", "RooflineReport", "OpCounter",
    "H100_PEAK_BF16", "H100_HBM_BW", "H100_NVLINK_BW",
]
