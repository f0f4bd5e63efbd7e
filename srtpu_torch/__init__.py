"""srtpu_torch: the PyTorch + CUDA (Hopper) port of srtpu.

It trains and serves EDSR end to end: ``python -m srtpu_torch fit`` and
``python -m srtpu_torch predict``. The JAX package ``srtpu`` beside it is
the reference; this package imports neither it nor JAX.
"""
