"""PyTorch/CUDA port of the SASA stencil framework.

The JAX package ``repro`` is the reference; this package imports neither
it nor JAX.  Entry points run on ``cuda`` unless given ``device=``.
"""
