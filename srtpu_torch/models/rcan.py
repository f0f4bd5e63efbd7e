"""RCAN: residual groups of channel-attention blocks (srtpu/models/rcan.py).
Mean shift, head conv, n_resgroups residual groups (each closed by a conv
and a group skip), the trunk close conv and the global skip, then
srtpu's XLA tail: ``UpscaleBlock`` and a final 3x3 conv (cuDNN here).
The flagship is RCAN-10x16 x4: 64 features, 10 groups of 16 RCABs,
reduction 16, bf16 compute on f32 parameters.

Routes, as srtpu's ``use_pallas``, all on the same stacked parameters
(one state dict runs on each):

* ``'cs'`` (srtpu's default): K5 per RCAB, every close conv on K2, up
  to ``CS_MAX_FEATS`` (96) features. Past them srtpu's ``CSRCANTrunk``
  runs its groups' XLA math (``xla_apply``), and so does the port, in
  stock ops (``ops.rcab.resgroup_xla``, the trunk close conv as
  ``conv3x3_reference``): no kernel;
* ``True``: srtpu's ``ResidualGroup`` / ``RCAB`` path with the fused
  gate, K8b, in every RCAB (``CALayer(use_pallas=True)``: f32 pool, MLP
  and sigmoid, f32 weights); the RCAB convs and every close conv stock.
  srtpu's gate ``ca_layer_fits`` (VMEM, up to about LR 128x128) sends
  larger images to its XLA reference, the same f32 function; K8b runs at
  every size here;
* ``False``: the same path with srtpu's stock gate (mean, two 1x1 convs
  and the sigmoid in the compute dtype).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops import ca_gate, conv3x3, conv3x3_plain, resgroup, resgroup_xla
from .common import (CS_MAX_FEATS, Conv2d, UpscaleBlock, _conv, mean_shift,
                     route_of, uniform_param)


class ResidualGroup(nn.Module):
    """One residual group (srtpu ``CSResidualGroup``): L RCABs with
    stacked weights, HWIO conv weights w1, w2 (L, 3, 3, C, C), biases b1,
    b2 (L, C), the attention MLP wd (L, C, C/r), bd (L, C/r), wu (L, C/r,
    C), bu (L, C), and the close conv wc (3, 3, C, C), bc (C,); srtpu's
    init bounds. Past ``CS_MAX_FEATS`` features the ``'cs'`` route is
    srtpu's XLA group (``xla``)."""

    def __init__(self, n_feats: int = 64, reduction: int = 16,
                 n_resblocks: int = 16, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        n, nb, cr = n_feats, n_resblocks, n_feats // reduction
        self.xla = n > CS_MAX_FEATS
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

    def forward(self, x: torch.Tensor, plain: bool = False,
                use_pallas: bool | str = 'cs') -> torch.Tensor:
        """``'cs'``: K5 and K2 (``resgroup``), past ``CS_MAX_FEATS``
        srtpu's XLA group (``resgroup_xla``); ``True`` / ``False``:
        srtpu's ``RCAB`` path in x's dtype, the gate K8b / stock."""
        if use_pallas == 'cs':
            prm = (self.w1, self.b1, self.w2, self.b2, self.wd, self.bd,
                   self.wu, self.bu, self.wc, self.bc)
            if self.xla:
                return resgroup_xla(x, *prm)
            return resgroup(x, *prm, plain)
        dt, res = x.dtype, x
        for w1, b1, w2, b2, wd, bd, wu, bu in zip(*(t.unbind(0) for t in (
                self.w1, self.b1, self.w2, self.b2, self.wd, self.bd,
                self.wu, self.bu))):
            r = _conv(torch.relu(_conv(res, w1, b1, dt)), w2, b2, dt)
            r = (ca_gate(r, wd, bd, wu, bu, plain) if use_pallas
                 else ca_stock(r, wd, bd, wu, bu))
            res = r + res
        return _conv(res, self.wc, self.bc, dt) + x


def ca_stock(x, wd, bd, wu, bu) -> torch.Tensor:
    """srtpu's ``CALayer(use_pallas=False)`` in x's dtype: the mean over H
    W (f32 sums, rounded to x's dtype), a 1x1 conv to C/r, ReLU, a 1x1
    conv back, sigmoid, x * gate."""
    dt = x.dtype
    y = x.float().mean((1, 2), keepdim=True).to(dt)
    y = torch.relu(_conv(y, wd[None, None], bd, dt))
    return x * torch.sigmoid(_conv(y, wu[None, None], bu, dt))


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
                 use_pallas: bool | str = 'cs',
                 dtype: torch.dtype | None = None, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        if use_pallas not in (False, True, 'cs'):
            raise ValueError(f"use_pallas must be False, True or 'cs', got "
                             f'{use_pallas!r}')
        self.use_pallas = use_pallas
        self.n_feats, self.n_resblocks = n_feats, n_resblocks
        self.xla = n_feats > CS_MAX_FEATS
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

    @classmethod
    def reaches_kernel(cls, scale: int, kw: dict) -> bool:
        """Whether the route ``kw`` picks runs a kernel of the port: all
        but srtpu's stock ``use_pallas=False``."""
        return route_of(cls, kw) is not False

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """``plain=True`` runs every kernel's plain PyTorch version instead
        (the reference the kernels are held against on the card)."""
        dtype = self.dtype or x.dtype
        if self.channels == 3:
            x = mean_shift(x, sign=-1)
        x = self.head(x, dtype)
        res, route = x, self.use_pallas
        for group in self.groups:
            res = group(res, plain, route)
        if route == 'cs' and self.xla:
            # srtpu's conv3x3_reference on the weight rounded to dtype
            res = conv3x3_plain(res, self.trunk_close_weight.to(dtype),
                                self.trunk_close_bias.float())
        elif route == 'cs':
            res = conv3x3(res, self.trunk_close_weight,
                          self.trunk_close_bias, plain)
        else:
            res = _conv(res, self.trunk_close_weight, self.trunk_close_bias,
                        dtype)
        res = res + x
        x = self.final(self.upscale(res, dtype), dtype)
        if self.channels == 3:
            x = mean_shift(x, sign=1)
        return x
