"""WDSR: wide-activation SR network with weight-normed convs
(srtpu/models/wdsr.py:21-193).

The DIV2K mean is subtracted; a learned 5x5 skip branch ``WNConv2d(3 ->
r*r*3)`` and the body (head ``WNConv2d(3 -> C)``, n_resblocks blocks,
tail ``WNConv2d(C -> r*r*3)``) each end in a pixel shuffle straight to
image space; their sum plus the mean is the image. Block A: a 3x3 conv to
4C, ReLU, a 3x3 conv back. Block B: a 1x1 conv to e = 6C, ReLU, a 1x1
linear bottleneck to L = int(0.8 C), a 3x3 conv back to C. Each block
ends in res * res_scale + x. srtpu's defaults: block B, 128 features, 16
blocks, x4, bf16 compute on f32 parameters.

Routes, as srtpu's ``use_pallas``:

* ``False`` (srtpu's default): every conv is a stock weight-normed conv
  (``WNConv2d``: cuDNN on the card, as XLA in srtpu);
* ``'cs'``, block B: each block's weight norm is taken in f32 under
  autograd and K7 runs the block (``ops.wdsr_block``). srtpu runs its XLA
  fallback on the same parameters where its VMEM plan fails (every
  predict size above about 32x32 LR) or its width gate does (n_feats % 64
  != 0); that limit is VMEM, not math, so on the card K7 runs at every
  size and every width it takes (C a multiple of 16 up to 128). Block A
  with ``'cs'`` runs its stock convs, as srtpu does;
* ``True`` (srtpu's legacy fused NHWC block, K8) is not ported and
  raises.

Both routes store the same parameters: per conv ``v``, ``g`` and
``bias`` (srtpu's 'cs' tree names them ``expand_*``, ``linear_*`` and
``conv_*``), so one state dict runs on either route.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.layout import pixel_shuffle
from ..ops.wdsr import wdsr_block
from .common import DIV2K_RGB_MEAN, WNConv2d

EXPAND, LINEAR = 6, 0.8


class _BlockA(nn.Module):
    def __init__(self, n: int, res_scale: float, **kw):
        super().__init__()
        self.res_scale = res_scale
        self.conv0 = WNConv2d(n, 4 * n, 3, **kw)
        self.conv1 = WNConv2d(4 * n, n, 3, **kw)

    def forward(self, x, dtype, plain: bool = False):
        res = self.conv1(torch.relu(self.conv0(x, dtype)), dtype)
        return res * self.res_scale + x


class _BlockB(nn.Module):
    def __init__(self, n: int, res_scale: float, kernel: bool, **kw):
        super().__init__()
        self.res_scale, self.kernel = res_scale, kernel
        self.expand = WNConv2d(n, n * EXPAND, 1, **kw)
        self.linear = WNConv2d(n * EXPAND, int(n * LINEAR), 1, **kw)
        self.conv = WNConv2d(int(n * LINEAR), n, 3, **kw)

    def forward(self, x, dtype, plain: bool = False):
        if self.kernel:
            return wdsr_block(x, self.expand.weight()[0, 0],
                              self.expand.bias, self.linear.weight()[0, 0],
                              self.linear.bias, self.conv.weight(),
                              self.conv.bias, self.res_scale, plain)
        res = torch.relu(self.expand(x, dtype))
        res = self.conv(self.linear(res, dtype), dtype)
        return res * self.res_scale + x


class WDSR(nn.Module):
    """NHWC f32 images in [0, 1] -> NHWC SR images (f32 when the mean is
    added back, as srtpu's; ``dtype`` is the compute type, the input's
    when None). Parameters: ``skip``, ``head``, ``blocks.{i}.{expand,
    linear, conv}`` (B) or ``blocks.{i}.{conv0, conv1}`` (A) and
    ``tail``, each a ``WNConv2d``. ``device`` places them; ``generator``
    (a CPU ``torch.Generator``) draws them."""

    # Scales the card runs: the tail is cuDNN, so every WDSR scale.
    CARD_SCALES = (2, 3, 4, 8)

    def __init__(self, scale_factor: int = 4, channels: int = 3,
                 block_type: str = 'B', n_feats: int = 128,
                 n_resblocks: int = 16, res_scale: float = 1.0,
                 use_pallas: bool | str = False,
                 dtype: torch.dtype | None = None, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        if scale_factor not in self.CARD_SCALES:
            raise ValueError('WDSR scale must be 2, 3, 4 or 8.')
        if block_type not in ('A', 'B'):
            raise ValueError(f"block_type must be 'A' or 'B', got "
                             f'{block_type!r}')
        if use_pallas is True:
            raise NotImplementedError(
                "WDSR use_pallas=True (srtpu's legacy fused NHWC block, K8) "
                'is not ported to srtpu_torch yet; see ROADMAP.md §2')
        if use_pallas not in (False, 'cs'):
            raise ValueError(f"use_pallas must be False, True or 'cs', got "
                             f'{use_pallas!r}')
        self.scale_factor, self.channels, self.dtype = (scale_factor,
                                                        channels, dtype)
        kw = dict(device=device, generator=generator)
        out = scale_factor * scale_factor * channels
        self.skip = WNConv2d(channels, out, 5, **kw)
        self.head = WNConv2d(channels, n_feats, 3, **kw)
        kernel = use_pallas == 'cs' and block_type == 'B'
        self.blocks = nn.ModuleList(
            _BlockA(n_feats, res_scale, **kw) if block_type == 'A'
            else _BlockB(n_feats, res_scale, kernel, **kw)
            for _ in range(n_resblocks))
        self.tail = WNConv2d(n_feats, out, 3, **kw)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """``plain=True`` runs K7's plain PyTorch version instead (the
        reference the kernels are held against on the card); it changes
        nothing on the stock route."""
        dtype = self.dtype or x.dtype
        r = self.scale_factor
        if self.channels == 3:
            mean = torch.tensor(DIV2K_RGB_MEAN, dtype=x.dtype,
                                device=x.device)
            x = x - mean
        s = pixel_shuffle(self.skip(x, dtype), r)
        # cuDNN may hand the head's output back in NCHW memory (a permuted
        # view); K7 reads dense NHWC
        y = self.head(x, dtype).contiguous()
        for blk in self.blocks:
            y = blk(y, dtype, plain)
        y = pixel_shuffle(self.tail(y, dtype), r) + s
        return y + mean if self.channels == 3 else y

