"""EDSR: mean shift, head conv, resblock trunk with a global skip, and
the sub-pixel tail (srtpu/models/edsr.py, use_pallas='cs'). The flagship
configuration is EDSR-baseline x4: 64 features, 16 resblocks, bf16
compute on f32 parameters.
"""

from __future__ import annotations

import torch
from torch import nn

from .common import Conv2d, Trunk, UpscaleTail, mean_shift


class EDSR(nn.Module):
    """NHWC f32 images in [0, 1] -> NHWC SR images in ``dtype`` (the input's
    dtype when None). ``device`` places the parameters; ``generator`` (a
    CPU ``torch.Generator``) draws them."""

    # Scales the card runs: every EDSR scale (x3's phase-dense conv is
    # 576 -> 32, on K2's general path).
    CARD_SCALES = (2, 3, 4, 8)

    def __init__(self, scale_factor: int = 4, channels: int = 3,
                 n_feats: int = 64, n_resblocks: int = 16,
                 res_scale: float = 1.0, dtype: torch.dtype | None = None,
                 *, device=None, generator: torch.Generator):
        super().__init__()
        self.scale_factor = scale_factor
        self.channels = channels
        self.dtype = dtype
        kw = dict(device=device, generator=generator)
        self.head = Conv2d(channels, n_feats, 3, **kw)
        self.trunk = Trunk(n_feats, n_resblocks, res_scale, **kw)
        self.tail = UpscaleTail(scale_factor, n_feats, channels, **kw)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """``plain=True`` runs every kernel's plain PyTorch version instead
        (the reference the kernels are held against on the card)."""
        dtype = self.dtype or x.dtype
        if self.channels == 3:
            x = mean_shift(x, sign=-1)
        x = self.head(x, dtype)
        x = self.trunk(x, dtype, plain)
        x = self.tail(x, dtype, plain)
        if self.channels == 3:
            x = mean_shift(x, sign=1)
        return x
