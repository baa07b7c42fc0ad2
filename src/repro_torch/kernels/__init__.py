"""Stencil executors of the PyTorch port: oracle, dense torch, CUDA tile kernel."""
