"""RCAN: residual groups of channel-attention blocks (srtpu/models/rcan.py,
use_pallas='cs'). Mean shift, head conv, n_resgroups residual groups
(K5, each closed by a K2 conv and a group skip), the trunk close conv
(K2) and the global skip, then srtpu's XLA tail: ``UpscaleBlock`` and a
final 3x3 conv (cuDNN here). The flagship is RCAN-10x16 x4: 64
features, 10 groups of 16 RCABs, reduction 16, bf16 compute on f32
parameters.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops import conv3x3, resgroup
from .common import Conv2d, UpscaleBlock, mean_shift, uniform_param


class ResidualGroup(nn.Module):
    """One residual group (srtpu ``CSResidualGroup``): L RCABs with
    stacked weights, HWIO conv weights w1, w2 (L, 3, 3, C, C), biases b1,
    b2 (L, C), the attention MLP wd (L, C, C/r), bd (L, C/r), wu (L, C/r,
    C), bu (L, C), and the close conv wc (3, 3, C, C), bc (C,); srtpu's
    init bounds."""

    def __init__(self, n_feats: int = 64, reduction: int = 16,
                 n_resblocks: int = 16, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        n, nb, cr = n_feats, n_resblocks, n_feats // reduction
        cb = 1.0 / math.sqrt(9 * n)

        def param(shape, bound):
            return uniform_param(shape, bound, device, generator)

        self.w1 = param((nb, 3, 3, n, n), cb)
        self.b1 = param((nb, n), cb)
        self.w2 = param((nb, 3, 3, n, n), cb)
        self.b2 = param((nb, n), cb)
        self.wd = param((nb, n, cr), 1 / math.sqrt(n))
        self.bd = param((nb, cr), 1 / math.sqrt(n))
        self.wu = param((nb, cr, n), 1 / math.sqrt(cr))
        self.bu = param((nb, n), 1 / math.sqrt(cr))
        self.wc = param((3, 3, n, n), cb)
        self.bc = param((n,), cb)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        return resgroup(x, self.w1, self.b1, self.w2, self.b2, self.wd,
                        self.bd, self.wu, self.bu, self.wc, self.bc, plain)


class RCAN(nn.Module):
    """NHWC f32 images in [0, 1] -> NHWC SR images in ``dtype`` (the input's
    dtype when None). ``device`` places the parameters; ``generator`` (a
    CPU ``torch.Generator``) draws them."""

    # The channel attention pools over the whole image, so a tiled
    # forward would gate on per-tile statistics (srtpu rcan.py:162-166).
    GLOBAL_POOLING = True
    # Scales the card runs: the tail is cuDNN, so x3 needs no kernel shape.
    CARD_SCALES = (2, 3, 4, 8)

    def __init__(self, scale_factor: int = 4, channels: int = 3,
                 n_feats: int = 64, n_resblocks: int = 16,
                 n_resgroups: int = 10, reduction: int = 16,
                 dtype: torch.dtype | None = None, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        self.scale_factor = scale_factor
        self.channels = channels
        self.dtype = dtype
        kw = dict(device=device, generator=generator)
        n = n_feats
        self.head = Conv2d(channels, n, 3, **kw)
        self.groups = nn.ModuleList(
            ResidualGroup(n, reduction, n_resblocks, **kw)
            for _ in range(n_resgroups))
        cb = 1.0 / math.sqrt(9 * n)
        self.trunk_close_weight = uniform_param((3, 3, n, n), cb, device,
                                                generator)
        self.trunk_close_bias = uniform_param((n,), cb, device, generator)
        self.upscale = UpscaleBlock(scale_factor, n, **kw)
        self.final = Conv2d(n, channels, 3, **kw)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """``plain=True`` runs every kernel's plain PyTorch version instead
        (the reference the kernels are held against on the card)."""
        dtype = self.dtype or x.dtype
        if self.channels == 3:
            x = mean_shift(x, sign=-1)
        x = self.head(x, dtype)
        res = x
        for group in self.groups:
            res = group(res, plain)
        res = conv3x3(res, self.trunk_close_weight, self.trunk_close_bias,
                      plain) + x
        x = self.final(self.upscale(res, dtype), dtype)
        if self.channels == 3:
            x = mean_shift(x, sign=1)
        return x
