"""srtpu_torch: the PyTorch + CUDA (Hopper) port of srtpu.

It runs EDSR predict end to end: ``python -m srtpu_torch predict``. The
JAX package ``srtpu`` beside it is the reference; this package imports
neither it nor JAX.
"""
