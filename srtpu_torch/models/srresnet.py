"""SRResNet: a 9x9 head conv with PReLU, BatchNorm resblocks (K4 in
training), the closing conv + BN and the global skip, then the PReLU
sub-pixel tail whose 9x9 HR output conv runs as a 5x5 phase-dense coarse
conv (K2) (srtpu/models/srresnet.py, use_pallas='cs'). The flagship
configuration is SRResNet x4: 64 features, 16 resblocks, bf16 compute on
f32 parameters. No mean shift: srtpu's has none.
"""

from __future__ import annotations

import torch
from torch import nn

from .common import BNTrunk, Conv2d, PReLU, UpscaleTail, only_cs


class SRResNet(nn.Module):
    """NHWC f32 images in [0, 1] -> NHWC SR images in ``dtype`` (the input's
    dtype when None). ``device`` places the parameters; ``generator`` (a
    CPU ``torch.Generator``) draws them. Batch norm follows the module's
    mode: ``train()`` normalises with batch statistics and updates the
    running ones, ``eval()`` reads the running ones (srtpu's ``train``).
    ``use_pallas``: srtpu's, 'cs' alone (any other value raises, F14)."""

    # Eval-mode batch norm is per pixel (running statistics), so a padded
    # or tiled image gives the same values on its real pixels.
    GLOBAL_POOLING = False
    # Scales the card runs: every SRResNet scale (x3's phase-dense conv is
    # 576 -> 32 at 5x5, on K2's general path).
    CARD_SCALES = (2, 3, 4, 8)

    def __init__(self, scale_factor: int = 4, channels: int = 3,
                 n_feats: int = 64, n_resblocks: int = 16,
                 use_pallas: bool | str = 'cs',
                 dtype: torch.dtype | None = None, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        only_cs('SRResNet', use_pallas, 20)
        self.use_pallas = use_pallas
        self.n_feats, self.n_resblocks = n_feats, n_resblocks
        self.scale_factor = scale_factor
        self.channels = channels
        self.dtype = dtype
        kw = dict(device=device, generator=generator)
        self.head = Conv2d(channels, n_feats, 9, **kw)
        self.head_act = PReLU(device=device)
        self.trunk = BNTrunk(n_feats, n_resblocks, **kw)
        self.tail = UpscaleTail(scale_factor, n_feats, channels, act='prelu',
                                final_ksize=9, **kw)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """``plain=True`` runs every kernel's plain PyTorch version instead
        (the reference the kernels are held against on the card)."""
        dtype = self.dtype or x.dtype
        x = self.head_act(self.head(x, dtype))
        x = self.trunk(x, dtype, plain)
        return self.tail(x, dtype, plain)
