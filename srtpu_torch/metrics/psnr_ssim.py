"""PSNR / SSIM / MS-SSIM on NHWC images in [0, 1] (srtpu/metrics/
psnr_ssim.py), on the images' device, each an f32 0-dim tensor.

Each takes an optional NHW1 validity mask, so a bucket-padded eval image
scores as its unpadded original. The arithmetic is srtpu's, in its
order: the gaussian blur is separable, each 1-D pass k shifted
slice-scale-adds summed as a pairwise tree (SSIM's sigma terms cancel
filter(x*x) against filter(x)^2, and a depthwise conv's order of sums
loses the constant-image identity), the window mask a separable min-pool
(VALID), MS-SSIM's 2x2 average pool and its ``>= 0.999`` re-mask at each
scale. srtpu leaves these to XLA; here they are stock PyTorch ops.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor | None,
                 dim) -> torch.Tensor:
    if mask is None:
        return x.mean(dim=dim)
    mask = mask.expand_as(x)
    return (x * mask).sum(dim=dim) / mask.sum(dim=dim).clamp_min(1.0)


def psnr(sr: torch.Tensor, hr: torch.Tensor, data_range: float = 1.0,
         mask: torch.Tensor | None = None) -> torch.Tensor:
    """Batch-mean PSNR (dB); ``mask`` NHW1 validity of padded eval."""
    sr, hr = sr.float(), hr.float()
    mse = _masked_mean((sr - hr).square(), mask, (1, 2, 3)).clamp_min(1e-12)
    return (10.0 * torch.log10(data_range ** 2 / mse)).mean()


@functools.lru_cache(maxsize=8)
def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return g.astype(np.float32)


def _filter1d(x: torch.Tensor, kernel: np.ndarray, dim: int) -> torch.Tensor:
    """1-D valid correlation along ``dim`` as k shifted slice-scale-adds,
    summed as a pairwise tree in srtpu's order (psnr_ssim.py:47-66)."""
    k = kernel.shape[0]
    n = x.shape[dim] - k + 1
    terms = [float(kernel[i]) * x.narrow(dim, i, n) for i in range(k)]
    while len(terms) > 1:
        terms = [terms[i] + terms[i + 1]
                 for i in range(0, len(terms) - 1, 2)] \
            + ([terms[-1]] if len(terms) % 2 else [])
    return terms[0]


def _filter2(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Separable valid gaussian blur of NHWC: rows, then columns."""
    return _filter1d(_filter1d(x, kernel, 1), kernel, 2)


def _ssim_per_channel(sr, hr, kernel, k1=0.01, k2=0.03, data_range=1.0):
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_x = _filter2(sr, kernel)
    mu_y = _filter2(hr, kernel)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_x = _filter2(sr * sr, kernel) - mu_xx
    sigma_y = _filter2(hr * hr, kernel) - mu_yy
    sigma_xy = _filter2(sr * hr, kernel) - mu_xy
    cs = (2 * sigma_xy + c2) / (sigma_x + sigma_y + c2)
    ssim_map = ((2 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs
    return ssim_map, cs


def _window_valid(mask: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """A window is valid iff every pixel it covers is: a min-pool of the
    NHW1 mask over (k, 1) then (1, k), VALID (exact for a min), as
    ``-max_pool2d(-m)``."""
    k = kernel_size
    m = -mask.permute(0, 3, 1, 2)
    m = F.max_pool2d(F.max_pool2d(m, (k, 1), stride=1), (1, k), stride=1)
    return (-m).permute(0, 2, 3, 1)


def _pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool of NHWC, stride 2, VALID (srtpu's reduce_window
    sum over the window in row order, then / 4)."""
    h, w = x.shape[1] // 2 * 2, x.shape[2] // 2 * 2
    x = x[:, :h, :w]
    return (((x[:, 0::2, 0::2] + x[:, 0::2, 1::2]) + x[:, 1::2, 0::2])
            + x[:, 1::2, 1::2]) / 4.0


def ssim(sr: torch.Tensor, hr: torch.Tensor, data_range: float = 1.0,
         kernel_size: int = 11, kernel_sigma: float = 1.5,
         mask: torch.Tensor | None = None) -> torch.Tensor:
    """Batch-mean SSIM (gaussian window, valid padding: piq's)."""
    sr, hr = sr.float(), hr.float()
    kernel = _gaussian_kernel(kernel_size, kernel_sigma)
    ssim_map, _ = _ssim_per_channel(sr, hr, kernel, data_range=data_range)
    if mask is not None:
        m = _window_valid(mask.float(), kernel_size)
        return _masked_mean(ssim_map, m, (1, 2, 3)).mean()
    return ssim_map.mean()


def ms_ssim(sr: torch.Tensor, hr: torch.Tensor, data_range: float = 1.0,
            kernel_size: int = 11, kernel_sigma: float = 1.5,
            weights=MS_SSIM_WEIGHTS,
            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Multi-scale SSIM, 5 scales with a 2x average pool between them.
    Needs min(H, W) > (kernel_size - 1) * 2 ** (len(weights) - 1); the
    eval bucketing guarantees it for full images. ``mask`` restricts
    scoring to unpadded pixels at every scale."""
    sr, hr = sr.float(), hr.float()
    kernel = _gaussian_kernel(kernel_size, kernel_sigma)
    w = torch.tensor(weights, dtype=torch.float32, device=sr.device)
    vals = []
    m = None if mask is None else mask.float()
    for i in range(len(weights)):
        ssim_map, cs = _ssim_per_channel(sr, hr, kernel,
                                         data_range=data_range)
        mc = None if m is None else _window_valid(m, kernel_size)
        if i == len(weights) - 1:
            vals.append(_masked_mean(ssim_map, mc, (1, 2, 3)).mean())
        else:
            vals.append(_masked_mean(cs, mc, (1, 2, 3)).mean())
            sr, hr = _pool(sr), _pool(hr)
            if m is not None:
                m = (_pool(m) >= 0.999).float()
    vals = torch.stack(vals).clamp_min(1e-6)   # relu'd as piq, for pow
    return torch.prod(vals ** w)
