"""Barron's adaptive robust loss with trainable shape and scale
(srtpu/losses/adaptive.py): the general loss
``rho(x, a, c) = |a - 2| / a * (((x / c)^2 / |a - 2| + 1)^(a / 2) - 1)``
of the residual SR - HR in a YUV + 2-level Haar representation (srtpu's
stand-in for the CDF 9/7 wavelet of robust_loss_pytorch), one (alpha,
scale) per band and channel: alpha in (0.001, 1.999) through a scaled
sigmoid of ``latent_alpha``, scale 1e-5 + softplus(``latent_scale``).

The latent parameters, two (7, 3) tensors, are the trainable state
beside the model: :meth:`AdaptiveLoss.init` draws no random numbers
(alpha 1, scale 1), and the train state optimises them with the model
(``train/state.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.imgops import DeviceConst

RGB2YUV = np.array([[0.299, 0.587, 0.114],
                    [-0.14714119, -0.28886916, 0.43601035],
                    [0.61497538, -0.51496512, -0.10001026]], dtype=np.float32)
_RGB2YUV = DeviceConst(RGB2YUV)


def _f32(x: torch.Tensor) -> torch.Tensor:
    """At least f32 (srtpu's); f64 stays f64, for a reference."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _haar_level(x: torch.Tensor):
    """One 2-D Haar analysis level of NHWC ``x`` (a trailing odd row or
    column dropped): (ll, (lh, hl, hh))."""
    h2, w2 = x.shape[1] // 2 * 2, x.shape[2] // 2 * 2
    x = x[:, :h2, :w2]
    a, b = x[:, 0::2, 0::2], x[:, 0::2, 1::2]
    c, d = x[:, 1::2, 0::2], x[:, 1::2, 1::2]
    return (a + b + c + d) / 2.0, ((a - b + c - d) / 2.0,
                                   (a + b - c - d) / 2.0,
                                   (a - b - c + d) / 2.0)


def wavelet_bands(x: torch.Tensor, num_levels: int = 2) -> list[torch.Tensor]:
    """YUV, then ``num_levels`` Haar levels: [lh, hl, hh] per level, then
    the last ll."""
    ll = _f32(x)
    ll = ll @ _RGB2YUV.on(x.device).to(ll.dtype).T
    bands = []
    for _ in range(num_levels):
        ll, (lh, hl, hh) = _haar_level(ll)
        bands.extend([lh, hl, hh])
    bands.append(ll)
    return bands


def general_loss(x: torch.Tensor, alpha: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """Barron's general loss of ``x`` at ``alpha`` and ``scale``, with
    srtpu's branches at alpha 0 and 2."""
    sq = (_f32(x) / scale) ** 2
    b = torch.abs(alpha - 2.0) + eps
    d = torch.where(alpha >= 0, alpha + eps, alpha - eps)
    loss_general = (b / d) * ((sq / b + 1.0) ** (0.5 * d) - 1.0)
    return torch.where(alpha.abs() < eps, torch.log1p(0.5 * sq),
                       torch.where((alpha - 2.0).abs() < eps, 0.5 * sq,
                                   loss_general))


class AdaptiveLoss:
    """The trainable adaptive loss (``__call__(sr, hr, params)``);
    ``params`` holds ``latent_alpha`` and ``latent_scale``."""

    trainable = True

    def __init__(self, num_levels: int = 2, channels: int = 3,
                 alpha_lo: float = 0.001, alpha_hi: float = 1.999,
                 alpha_init: float = 1.0, scale_lo: float = 1e-5,
                 scale_init: float = 1.0):
        self.num_levels = num_levels
        self.channels = channels
        self.alpha_lo, self.alpha_hi = alpha_lo, alpha_hi
        self.alpha_init = alpha_init
        self.scale_lo, self.scale_init = scale_lo, scale_init
        self.n_bands = 3 * num_levels + 1

    def init(self) -> dict[str, torch.Tensor]:
        """The latents of alpha_init and scale_init (the sigmoid's and the
        softplus's inverses), f32 (n_bands, channels)."""
        t = (self.alpha_init - self.alpha_lo) / (self.alpha_hi - self.alpha_lo)
        latent_alpha = math.log(t / (1 - t)) if 0 < t < 1 else 0.0
        latent_scale = math.log(
            math.expm1(self.scale_init - self.scale_lo) + 1e-12) \
            if self.scale_init > self.scale_lo else 0.0
        shape = (self.n_bands, self.channels)
        return {'latent_alpha': torch.full(shape, latent_alpha),
                'latent_scale': torch.full(shape, latent_scale)}

    def alphas_scales(self, params):
        alpha = self.alpha_lo + (self.alpha_hi - self.alpha_lo) * \
            torch.sigmoid(params['latent_alpha'])
        # jax.nn.softplus: log(exp(x) + 1), no linear branch past 20
        scale = self.scale_lo + torch.logaddexp(
            params['latent_scale'], torch.zeros_like(params['latent_scale']))
        return alpha, scale

    def __call__(self, sr: torch.Tensor, hr: torch.Tensor,
                 params) -> torch.Tensor:
        alpha, scale = self.alphas_scales(params)
        total, count = 0.0, 0
        for i, band in enumerate(wavelet_bands(sr - hr, self.num_levels)):
            total = total + general_loss(band, alpha[i], scale[i]).sum()
            count += band.numel()
        return total / count
