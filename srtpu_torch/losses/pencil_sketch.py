"""Pencil-sketch loss (srtpu/losses/pencil_sketch.py): 100 - PSNR
between the sketches of the SR and HR (luma divided by the inverted blur
of its inverse, NaNs and infinities zeroed, clipped to [0, 1]). It
carries no gradient, as srtpu's (its inputs are detached)."""

from __future__ import annotations

import torch

from ..metrics.psnr_ssim import psnr
from ..utils.imgops import gaussian_blur2d, invert, rgb_to_grayscale


def pencil_sketch(x: torch.Tensor, kernel_size: int = -1, sigma: float = 1.0,
                  border_type: str = 'reflect') -> torch.Tensor:
    """NHW1 sketch of NHWC ``x``; the default blur is W // 10 made odd,
    at least 3."""
    if kernel_size == -1:
        kernel_size = x.shape[-2] // 10
        if kernel_size % 2 == 0:
            kernel_size += 1
        kernel_size = max(kernel_size, 3)
    gray = rgb_to_grayscale(x)
    blurred = invert(gaussian_blur2d(invert(gray), (kernel_size, kernel_size),
                                     (sigma, sigma), border_type))
    sketch = torch.nan_to_num(gray / blurred, nan=0.0, posinf=0.0,
                              neginf=0.0)
    return sketch.clamp(0.0, 1.0)


def pencil_sketch_loss(sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
    sr, hr = sr.detach(), hr.detach()
    return 100.0 - psnr(pencil_sketch(sr), pencil_sketch(hr))
