"""Stock stencil kernels of the paper, for the PyTorch port."""
