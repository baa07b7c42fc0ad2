"""PyTorch/CUDA port of the SASA stencil framework (core front end)."""
