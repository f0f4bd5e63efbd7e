"""DDBPN: dense deep back-projection network (srtpu/models/ddbpn.py,
use_pallas='cs').

Mean shift; the head, a 3x3 conv 3 -> n0 and a 1x1 conv n0 -> nr, each
with a per-channel PReLU (cuDNN and a matmul here, as srtpu leaves them
to XLA); then depth - 1 pairs of dense up and down projection units and
a last up unit, each reading the outputs of every earlier unit of the
other kind; the output conv over the depth HR outputs; the mean shift
back. The flagship is DDBPN x4 at srtpu's defaults: n0 = 128, nr = 32,
depth = 6 (11 units), bf16 compute on f32 parameters.

Everything runs at LR resolution, as srtpu's kernel path does
(ddbpn.py:155-192, :325-336): an HR tensor is a coarse NHWC tensor with
r*r*nr phase-major channels (``ops.ddbpn``), every projection conv is a
K2 launch on a coarse weight times its live-tap mask, and the output
conv, a fine 3x3 conv over the HR concat, is a sum of one phase-dense K2
conv per HR block (bias on block 0 only), added in the compute dtype in
srtpu's order. No concat is ever built: a unit's 1x1 bottleneck is one
matmul per input block (an HR block through its (..., r*r, nr) group
view).

Parameters are the coarse weights srtpu's 'cs' tree stores, in HWIO:
Adam on them steps element for element as srtpu's, since each fine
weight has one live slot and a dead slot's gradient is exactly 0.
The card runs x2 and x4, the scales of srtpu's kernel path (ddbpn.py:301-
303); x8 runs on the CPU (srtpu's XLA branch, the same coarse math) and
raises on the card (ROADMAP.md F4).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops import conv3x3
from ..ops.ddbpn import _PROJ_PARAMS, down_mask, final_mask, up_mask
from ..ops.layout import b_phase_dense, pm_to_nhwc
from .common import Conv2d, mean_shift, only_cs, prelu, uniform_param


def _alpha(n: int, device) -> nn.Parameter:
    return nn.Parameter(torch.full((n,), 0.25, device=device))


class DenseProjection(nn.Module):
    """One projection unit (srtpu ``CSDenseProjection``). ``up`` takes LR
    blocks (B, h, w, nr) and returns an HR phase-major block (B, h, w,
    r*r*nr); a down unit the reverse. a0 = P(x), b0 = Q(a0), a1 = P(b0 -
    x), out = a0 + a1, P the unit's projection and Q the other, each a K2
    conv then a PReLU. Parameters: a0_weight, b0_weight, a1_weight (HWIO
    coarse: up (3, 3, nr, r*r*nr), down (3, 3, r*r*nr, nr)), their biases
    and slopes (nr,), tiled over the phases where the output is HR; with
    ``bottleneck``, bneck_weight (n_blocks*nr, nr), bneck_bias and
    bneck_alpha (nr,)."""

    def __init__(self, nr: int, scale: int, up: bool, n_blocks: int,
                 bottleneck: bool, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        self.nr, self.r, self.up, self.bottleneck = nr, scale, up, bottleneck
        r2 = scale * scale
        bound = 1.0 / math.sqrt(nr * _PROJ_PARAMS[scale][0] ** 2)

        def u(name, shape, bnd):
            self.register_parameter(name, uniform_param(shape, bnd, device,
                                                        generator))

        if bottleneck:
            c_tot = n_blocks * nr
            u('bneck_weight', (c_tot, nr), 1.0 / math.sqrt(c_tot))
            u('bneck_bias', (nr,), 1.0 / math.sqrt(c_tot))
            self.bneck_alpha = _alpha(nr, device)
        up_shape, dn_shape = (3, 3, nr, r2 * nr), (3, 3, r2 * nr, nr)
        for name, is_up in (('a0', up), ('b0', not up), ('a1', up)):
            u(f'{name}_weight', up_shape if is_up else dn_shape, bound)
            u(f'{name}_bias', (nr,), bound)
            self.register_parameter(f'{name}_alpha', _alpha(nr, device))

    def _conv_act(self, x, name: str, is_up: bool, masks, plain: bool):
        """K2 on the masked coarse weight, then the PReLU; an up conv's
        (HR) bias and slope tiled over the r*r phases."""
        tile = self.r * self.r if is_up else 1
        w = getattr(self, f'{name}_weight') * masks[0 if is_up else 1]
        y = conv3x3(x, w, getattr(self, f'{name}_bias').repeat(tile), plain)
        return prelu(y, getattr(self, f'{name}_alpha').repeat(tile))

    def forward(self, xs: list, masks: tuple, plain: bool = False
                ) -> torch.Tensor:
        """``xs``: the unit's input blocks (LR for an up unit, HR
        phase-major for a down one); ``masks``: the (up, down) masks."""
        if self.bottleneck:
            acc = None
            for t, xt in enumerate(xs):
                wt = self.bneck_weight[t * self.nr:(t + 1) * self.nr] \
                    .to(xt.dtype)
                if xt.shape[-1] == self.nr:     # LR block
                    y = torch.matmul(xt, wt)
                else:                           # HR phase-major block
                    y = torch.matmul(xt.unflatten(-1, (-1, self.nr)), wt) \
                        .flatten(-2)
                acc = y if acc is None else acc + y
            tile = acc.shape[-1] // self.nr
            x = prelu(acc + self.bneck_bias.repeat(tile).to(acc.dtype),
                      self.bneck_alpha.repeat(tile))
        else:
            x = xs[0]
        a0 = self._conv_act(x, 'a0', self.up, masks, plain)
        e = self._conv_act(a0, 'b0', not self.up, masks, plain) - x
        return a0 + self._conv_act(e, 'a1', self.up, masks, plain)


class DDBPN(nn.Module):
    """NHWC f32 images in [0, 1] -> NHWC SR images in ``dtype`` (the input's
    dtype when None). Parameters: head0 (Conv2d 3x3, channels -> n0) and
    head_alpha0 (n0,), head1 (Conv2d 1x1, n0 -> nr) and head_alpha1 (nr,);
    units.{i} (:class:`DenseProjection`; even i up, odd i down, the last
    up); out_weight (depth, 3, 3, r*r*nr, CO), the phase-dense output conv
    per HR block with CO = 16 * ceil(r*r*channels / 16), and out_bias
    (channels,). The live-tap masks are buffers (not saved). ``device``
    places them; ``generator`` (a CPU ``torch.Generator``) draws the
    parameters at srtpu's init bounds. ``use_pallas``: srtpu's, 'cs'
    alone (any other value raises, F14)."""

    GLOBAL_POOLING = False
    # Scales the card runs: srtpu's kernel path covers x2 and x4; at x8 it
    # takes its XLA branch (ROADMAP.md F4)
    CARD_SCALES = (2, 4)

    def __init__(self, scale_factor: int = 4, channels: int = 3,
                 n0: int = 128, nr: int = 32, depth: int = 6,
                 use_pallas: bool | str = 'cs',
                 dtype: torch.dtype | None = None, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        only_cs('DDBPN', use_pallas, 21)
        if scale_factor not in _PROJ_PARAMS:
            raise ValueError(f'DDBPN scale must be 2, 4 or 8, got '
                             f'{scale_factor}')
        self.scale_factor, self.channels, self.dtype = (scale_factor,
                                                        channels, dtype)
        self.nr, self.depth, self.use_pallas = nr, depth, use_pallas
        r = scale_factor
        kw = dict(device=device, generator=generator)
        self.head0 = Conv2d(channels, n0, 3, **kw)
        self.head_alpha0 = _alpha(n0, device)
        self.head1 = Conv2d(n0, nr, 1, **kw)
        self.head_alpha1 = _alpha(nr, device)
        units = []
        for i in range(depth - 1):
            units.append(DenseProjection(nr, r, True, max(i, 1), i > 1, **kw))
            units.append(DenseProjection(nr, r, False, i + 1, i != 0, **kw))
        units.append(DenseProjection(nr, r, True, depth - 1, True, **kw))
        self.units = nn.ModuleList(units)
        co = -(-r * r * channels // 16) * 16
        bound_f = 1.0 / math.sqrt(9 * depth * nr)
        self.out_weight = uniform_param((depth, 3, 3, r * r * nr, co),
                                        bound_f, device, generator)
        self.out_bias = uniform_param((channels,), bound_f, device,
                                      generator)
        for name, m in (('m_up', up_mask(r, nr, nr)),
                        ('m_down', down_mask(r, nr, nr)),
                        ('m_out', final_mask(r, nr, channels))):
            self.register_buffer(name, m.to(device=device, copy=True),
                                 persistent=False)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """``plain=True`` runs every kernel's plain PyTorch version instead
        (the reference the kernels are held against on the card)."""
        r = self.scale_factor
        if x.device.type == 'cuda' and r not in self.CARD_SCALES:
            raise ValueError(
                f'DDBPN x{r} has no kernel path on CUDA (srtpu runs it on '
                f'XLA; ROADMAP.md F4): run it with --device cpu')
        dtype = self.dtype or x.dtype
        if self.channels == 3:
            x = mean_shift(x, sign=-1)
        x = prelu(self.head0(x, dtype), self.head_alpha0)
        # the 1x1 head conv: one matmul in the compute dtype, then its bias
        x = torch.matmul(x, self.head1.weight[0, 0].to(dtype)) \
            + self.head1.bias.to(dtype)
        x = prelu(x, self.head_alpha1).contiguous()
        masks = (self.m_up, self.m_down)
        units = iter(self.units)
        hs, ls = [], []
        for i in range(self.depth - 1):
            hs.append(next(units)(ls if i else [x], masks, plain))
            ls.append(next(units)(hs, masks, plain))
        hs.append(next(units)(ls, masks, plain))
        del ls, x
        bpd = b_phase_dense(self.out_bias, r, self.out_weight.shape[-1])
        acc = None
        for t, ht in enumerate(hs):
            y = conv3x3(ht, self.out_weight[t] * self.m_out,
                        bpd if t == 0 else torch.zeros_like(bpd), plain)
            acc = y if acc is None else acc + y
        out = pm_to_nhwc(acc, r, self.channels)
        if self.channels == 3:
            out = mean_shift(out, sign=1)
        return out
