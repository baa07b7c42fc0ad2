"""Request-facing stencil serving of the PyTorch port (one device)."""
from repro_torch.serve.engine import StencilRequest, StencilServer

__all__ = ["StencilRequest", "StencilServer"]
