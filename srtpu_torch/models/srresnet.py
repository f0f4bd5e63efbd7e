"""SRResNet: a 9x9 head conv with PReLU, BatchNorm resblocks, the closing
conv + BN and the global skip, then the PReLU sub-pixel tail and a 9x9 HR
output conv (srtpu/models/srresnet.py). The flagship configuration is
SRResNet x4: 64 features, 16 resblocks, bf16 compute on f32 parameters.
No mean shift: srtpu's has none.

``use_pallas='cs'`` (srtpu's default) runs K4 in training and the tail
on K3 and K2, its 9x9 output conv as a 5x5 phase-dense coarse conv. Any
other value runs srtpu's XLA route (srtpu/models/srresnet.py:51-64) in
stock ops with srtpu's roundings: the blocks as srtpu's
``ResBlock(norm='batch', act=PReLU)`` and the close as its
``BasicBlock`` (:func:`~.common.xla_trunk`, in either mode), then
``UpscaleBlock(act=PReLU)`` and the 9x9 conv at HR
(:meth:`~.common.UpscaleTail.forward_stock`). Both routes keep one state
dict; srtpu's two trees both load into it.
"""

from __future__ import annotations

import torch
from torch import nn

from .common import BNTrunk, Conv2d, PReLU, UpscaleTail, route_of, xla_trunk


class SRResNet(nn.Module):
    """NHWC f32 images in [0, 1] -> NHWC SR images in ``dtype`` (the input's
    dtype when None). ``device`` places the parameters; ``generator`` (a
    CPU ``torch.Generator``) draws them. Batch norm follows the module's
    mode: ``train()`` normalises with batch statistics and updates the
    running ones, ``eval()`` reads the running ones (srtpu's ``train``).
    ``use_pallas``: srtpu's; 'cs' the kernel route, False or True its
    XLA route (see the module note)."""

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
        if use_pallas not in (False, True, 'cs'):
            raise ValueError(f"use_pallas must be False, True or 'cs', got "
                             f'{use_pallas!r}')
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

    @classmethod
    def reaches_kernel(cls, scale: int, kw: dict) -> bool:
        """Whether the route ``kw`` picks runs a kernel of the port at
        ``scale``: 'cs' alone."""
        return route_of(cls, kw) == 'cs'

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """``plain=True`` runs every kernel's plain PyTorch version instead
        (the reference the kernels are held against on the card); the XLA
        route has none and ignores it."""
        dtype = self.dtype or x.dtype
        x = self.head_act(self.head(x, dtype))
        if self.use_pallas != 'cs':
            return self.tail.forward_stock(xla_trunk(self.trunk, x, dtype),
                                           dtype)
        x = self.trunk(x, dtype, plain)
        return self.tail(x, dtype, plain)
