"""EDSR: mean shift, head conv, resblock trunk with a global skip, and
the sub-pixel tail (srtpu/models/edsr.py). The flagship configuration is
EDSR-baseline x4: 64 features, 16 resblocks, bf16 compute on f32
parameters.

Routes, as srtpu's ``use_pallas``, all on one set of parameters (one
state dict runs on each):

* ``'cs'`` (srtpu's default): the trunk on K1 and K2, the tail on K2 and
  K3 (``Trunk``, ``UpscaleTail``);
* ``True``: srtpu's fused NHWC blocks, K8a per block (``FusedResBlock``:
  h1 kept in f32 between the convs; the backward in stock ops from the
  saved bf16 h1, the weight grads rounded to bf16 as srtpu's); the close
  conv, the skip and the tail (``UpscaleBlock`` and the final conv)
  stock, as srtpu's XLA. srtpu runs its kernel only where its VMEM gate
  ``resblock_fits`` passes (training patches; not LR 128x128) and its
  XLA reference past it, whose backward reads the f32 h1 where the
  kernel's reads the bf16 one. That gate is VMEM, not math, so K8a runs
  at every size here (64 channels; other widths raise on the card,
  ROADMAP.md F4), and past srtpu's gate the weight grads read the bf16
  h1;
* ``False``: srtpu's ``ResBlock`` trunk, close and tail, every conv
  stock (cuDNN on the card).
"""

from __future__ import annotations

import torch
from torch import nn

from .common import Conv2d, Trunk, UpscaleTail, mean_shift, route_of


class EDSR(nn.Module):
    """NHWC f32 images in [0, 1] -> NHWC SR images in ``dtype`` (the input's
    dtype when None). ``device`` places the parameters; ``generator`` (a
    CPU ``torch.Generator``) draws them."""

    # Scales the card runs: every EDSR scale (x3's phase-dense conv is
    # 576 -> 32, on K2's general path).
    CARD_SCALES = (2, 3, 4, 8)

    def __init__(self, scale_factor: int = 4, channels: int = 3,
                 n_feats: int = 64, n_resblocks: int = 16,
                 res_scale: float = 1.0, use_pallas: bool | str = 'cs',
                 dtype: torch.dtype | None = None, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        if use_pallas not in (False, True, 'cs'):
            raise ValueError(f"use_pallas must be False, True or 'cs', got "
                             f'{use_pallas!r}')
        self.scale_factor = scale_factor
        self.channels = channels
        self.use_pallas = use_pallas
        self.n_feats, self.n_resblocks = n_feats, n_resblocks
        self.dtype = dtype
        kw = dict(device=device, generator=generator)
        self.head = Conv2d(channels, n_feats, 3, **kw)
        self.trunk = Trunk(n_feats, n_resblocks, res_scale, **kw)
        self.tail = UpscaleTail(scale_factor, n_feats, channels, **kw)

    @classmethod
    def reaches_kernel(cls, scale: int, kw: dict) -> bool:
        """Whether the route ``kw`` picks runs a kernel of the port: all
        but srtpu's stock ``use_pallas=False``."""
        return route_of(cls, kw) is not False

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """``plain=True`` runs every kernel's plain PyTorch version instead
        (the reference the kernels are held against on the card); it
        changes nothing on the ``False`` route."""
        dtype = self.dtype or x.dtype
        if self.channels == 3:
            x = mean_shift(x, sign=-1)
        x = self.head(x, dtype)
        if self.use_pallas == 'cs':
            x = self.tail(self.trunk(x, dtype, plain), dtype, plain)
        else:
            x = self.trunk.forward_nhwc(x, dtype, self.use_pallas is True,
                                        plain)
            x = self.tail.forward_stock(x, dtype)
        if self.channels == 3:
            x = mean_shift(x, sign=1)
        return x
