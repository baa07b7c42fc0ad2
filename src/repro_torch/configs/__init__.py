"""Configurations of the PyTorch port: the paper's stock stencil kernels
(:mod:`repro_torch.configs.stencils`) and the LM substrate's architectures
(:mod:`repro_torch.configs.base`, one module per architecture)."""
