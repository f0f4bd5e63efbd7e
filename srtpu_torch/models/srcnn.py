"""SRCNN: a bicubic pre-upsample, then a 9-1-5 conv stack at the HR size
(srtpu/models/srcnn.py). The upsample is srtpu's two interpolation-matrix
matmuls in f32 (``bicubic_resize``, a = -0.75, no antialias: torch's
clamped borders); the three convs are the port's ``Conv2d`` in the
compute dtype, as srtpu rounds them. srtpu runs all of it in XLA, so no
kernel of the port runs here (cuDNN and a matmul on the card).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import Conv2d, bicubic_resize


class SRCNN(nn.Module):
    """NHWC images in [0, 1] -> NHWC SR images in ``dtype`` (the input's
    dtype when None). ``device`` places the parameters; ``generator`` (a
    CPU ``torch.Generator``) draws them in srtpu's order: conv1 (9x9, 64),
    conv2 (1x1, 32), conv3 (5x5, ``channels``)."""

    # Per pixel after the upsample: a padded or tiled image gives the same
    # values away from its borders.
    GLOBAL_POOLING = False
    # Scales the card runs: any, as no kernel is involved; these are the
    # scales srtpu's other families take.
    CARD_SCALES = (2, 3, 4, 8)

    def __init__(self, scale_factor: int = 4, channels: int = 3,
                 dtype: torch.dtype | None = None, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        self.scale_factor = scale_factor
        self.channels = channels
        self.dtype = dtype
        kw = dict(device=device, generator=generator)
        self.conv1 = Conv2d(channels, 64, 9, **kw)
        self.conv2 = Conv2d(64, 32, 1, **kw)
        self.conv3 = Conv2d(32, channels, 5, **kw)

    @classmethod
    def reaches_kernel(cls, scale: int, kw: dict) -> bool:
        """SRCNN runs no kernel of the port (srtpu leaves it to XLA)."""
        return False

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """``plain`` is accepted for the step functions' sake; no kernel
        runs here, so it changes nothing."""
        dtype = self.dtype or x.dtype
        _, h, w, _ = x.shape
        s = self.scale_factor
        x = bicubic_resize(x, (h * s, w * s), a=-0.75, antialias=False)
        x = F.relu(self.conv1(x, dtype))
        x = F.relu(self.conv2(x, dtype))
        return self.conv3(x, dtype)
