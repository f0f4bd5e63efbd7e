"""Edge loss (srtpu/losses/edge.py): the mean absolute difference of the
edge maps (Canny's suppressed magnitude, Laplacian or Sobel) of the SR
and HR luma. It carries no gradient: srtpu stops it, as its reference
computes it under ``torch.no_grad``; here the inputs are detached."""

from __future__ import annotations

import torch

from ..utils.imgops import canny, laplacian, rgb_to_grayscale, sobel


def extract_edges(x: torch.Tensor, operator: str = 'canny') -> torch.Tensor:
    """NHW1 edge map of NHWC ``x``; the Laplacian's kernel is W // 10
    made odd, at least 3."""
    gray = rgb_to_grayscale(x)
    if operator == 'canny':
        return canny(gray)[0]
    if operator == 'laplacian':
        kernel_size = gray.shape[-2] // 10
        if kernel_size % 2 == 0:
            kernel_size += 1
        return laplacian(gray, kernel_size=max(kernel_size, 3))
    if operator == 'sobel':
        return sobel(gray)
    raise ValueError('operator must be one of {canny, laplacian, sobel}')


def edge_loss(sr: torch.Tensor, hr: torch.Tensor,
              operator: str = 'canny') -> torch.Tensor:
    sr, hr = sr.detach(), hr.detach()
    return (extract_edges(sr, operator)
            - extract_edges(hr, operator)).abs().mean()
