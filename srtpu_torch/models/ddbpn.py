"""DDBPN: dense deep back-projection network (srtpu/models/ddbpn.py).

Mean shift; the head, a 3x3 conv 3 -> n0 and a 1x1 conv n0 -> nr, each
with a per-channel PReLU (cuDNN and a matmul here, as srtpu leaves them
to XLA); then depth - 1 pairs of dense up and down projection units and
a last up unit, each reading the outputs of every earlier unit of the
other kind; the output conv over the depth HR outputs; the mean shift
back. The flagship is DDBPN x4 at srtpu's defaults: n0 = 128, nr = 32,
depth = 6 (11 units), bf16 compute on f32 parameters.

``use_pallas='cs'`` (srtpu's default) runs everything at LR resolution,
as srtpu's kernel path does (ddbpn.py:155-192, :325-336): an HR tensor
is a coarse NHWC tensor with r*r*nr phase-major channels (``ops.ddbpn``),
every projection conv is a K2 launch on a coarse weight times its
live-tap mask, and the output conv, a fine 3x3 conv over the HR concat,
is a sum of one phase-dense K2 conv per HR block (bias on block 0 only),
added in the compute dtype in srtpu's order. No concat is ever built: a
unit's 1x1 bottleneck is one matmul per input block (an HR block through
its (..., r*r, nr) group view). Its parameters are the coarse weights
srtpu's 'cs' tree stores, in HWIO: Adam on them steps element for
element as srtpu's, since each fine weight has one live slot and a dead
slot's gradient is exactly 0. srtpu's kernel path covers x2 and x4; at
x8 it takes its XLA branch on the same coarse weights (ddbpn.py:301-303,
:337-345), and so does the port, on every device: each conv
:func:`~.common.conv_xla` (c_in 64 nr at the down convs), each
bottleneck one matmul over the concat of its blocks.

Any other ``use_pallas`` runs srtpu's XLA route (ddbpn.py:234-262) on its
own parameter tree (:class:`FineProjection`): the units' fine k x k
``ConvTranspose2d`` up and strided ``Conv2d`` down convs ((k, s, p) =
(6, 2, 2), (8, 4, 2), (12, 8, 2) at x2, x4, x8) with their PReLUs and 1x1
bottlenecks over the concat, and the fine 3x3 output conv over the h
concat, in stock ops with srtpu's roundings. It keeps srtpu's fine
kernels, since the 'cs' tree's phase-dense ``out_weight`` repeats each
fine output weight r*r times and cannot train as the one fine kernel
does.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops import conv3x3
from ..ops.ddbpn import _PROJ_PARAMS, down_mask, final_mask, up_mask
from ..ops.layout import b_phase_dense, pm_to_nhwc
from .common import (Conv2d, _conv, _conv_transpose, conv_xla, mean_shift,
                     prelu, route_of, uniform_param)


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

    def _conv_act(self, x, name: str, is_up: bool, masks, plain: bool,
                  stock: bool):
        """K2 (``stock``: :func:`~.common.conv_xla`) on the masked coarse
        weight, then the PReLU; an up conv's (HR) bias and slope tiled
        over the r*r phases."""
        tile = self.r * self.r if is_up else 1
        w = getattr(self, f'{name}_weight') * masks[0 if is_up else 1]
        b = getattr(self, f'{name}_bias').repeat(tile)
        y = conv_xla(x, w, b) if stock else conv3x3(x, w, b, plain)
        return prelu(y, getattr(self, f'{name}_alpha').repeat(tile))

    def _bneck(self, xs: list, stock: bool) -> torch.Tensor:
        """The 1x1 bottleneck over the unit's blocks, then its PReLU: one
        matmul per block summed in the compute dtype (srtpu's kernel
        path), or with ``stock`` one over their concat, rounded once
        (its XLA branch); an HR block through its (..., r*r, nr) group
        view."""
        nr = self.nr
        hr = xs[0].shape[-1] != nr
        if stock:
            x = torch.cat([xt.unflatten(-1, (-1, nr)) if hr else xt
                           for xt in xs], -1)
            acc = torch.matmul(x.float(), self.bneck_weight.to(x.dtype)
                               .float()).to(x.dtype)
            acc = acc.flatten(-2) if hr else acc
        else:
            acc = None
            for t, xt in enumerate(xs):
                wt = self.bneck_weight[t * nr:(t + 1) * nr].to(xt.dtype)
                if hr:
                    y = torch.matmul(xt.unflatten(-1, (-1, nr)), wt) \
                        .flatten(-2)
                else:
                    y = torch.matmul(xt, wt)
                acc = y if acc is None else acc + y
        tile = acc.shape[-1] // nr
        return prelu(acc + self.bneck_bias.repeat(tile).to(acc.dtype),
                     self.bneck_alpha.repeat(tile))

    def forward(self, xs: list, masks: tuple, plain: bool = False,
                stock: bool = False) -> torch.Tensor:
        """``xs``: the unit's input blocks (LR for an up unit, HR
        phase-major for a down one); ``masks``: the (up, down) masks;
        ``stock``: srtpu's XLA branch (x8) in place of K2."""
        x = self._bneck(xs, stock) if self.bottleneck else xs[0]
        a0 = self._conv_act(x, 'a0', self.up, masks, plain, stock)
        e = self._conv_act(a0, 'b0', not self.up, masks, plain, stock) - x
        return a0 + self._conv_act(e, 'a1', self.up, masks, plain, stock)


class FineProjection(nn.Module):
    """One projection unit of srtpu's XLA route (srtpu ``DenseProjection``
    with its ``_ProjectionConv``s, ddbpn.py:31-68), on fine NHWC tensors.
    a0 = P(x), b0 = Q(a0), a1 = P(b0 - x), out = a0 + a1, P the unit's
    projection and Q the other, each conv then a per-channel PReLU; an up
    projection is a ``ConvTranspose2d`` (:func:`~.common._conv_transpose`,
    its HWOI kernel), a down one a strided ``Conv2d``, with (k, s, p) from
    ``_PROJ_PARAMS``. Parameters, srtpu's tree one to one: a0_weight,
    b0_weight, a1_weight (k, k, nr, nr) (HWOI up, HWIO down) at bound
    1/sqrt(nr k^2), their biases and slopes (nr,); with ``bottleneck``,
    a 1x1 conv over the concat of the unit's n_blocks inputs first:
    bneck_weight (1, 1, n_blocks nr, nr), bneck_bias, bneck_alpha."""

    def __init__(self, nr: int, scale: int, up: bool, n_blocks: int,
                 bottleneck: bool, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        self.up, self.bottleneck = up, bottleneck
        self.k, self.s, self.p = _PROJ_PARAMS[scale]
        bound = 1.0 / math.sqrt(nr * self.k ** 2)

        def u(name, shape, bnd):
            self.register_parameter(name, uniform_param(shape, bnd, device,
                                                        generator))

        if bottleneck:
            c_tot = n_blocks * nr
            u('bneck_weight', (1, 1, c_tot, nr), 1.0 / math.sqrt(c_tot))
            u('bneck_bias', (nr,), 1.0 / math.sqrt(c_tot))
            self.bneck_alpha = _alpha(nr, device)
        for name in ('a0', 'b0', 'a1'):
            u(f'{name}_weight', (self.k, self.k, nr, nr), bound)
            u(f'{name}_bias', (nr,), bound)
            self.register_parameter(f'{name}_alpha', _alpha(nr, device))

    def _proj(self, x, name: str, is_up: bool, dtype) -> torch.Tensor:
        w, b = getattr(self, f'{name}_weight'), getattr(self, f'{name}_bias')
        y = (_conv_transpose(x, w, b, dtype, self.s, self.p) if is_up else
             _conv(x, w, b, dtype, stride=self.s, padding=self.p))
        return prelu(y, getattr(self, f'{name}_alpha'))

    def forward(self, xs: list, dtype) -> torch.Tensor:
        x = torch.cat(xs, -1) if len(xs) > 1 else xs[0]
        if self.bottleneck:
            x = prelu(_conv(x, self.bneck_weight, self.bneck_bias, dtype),
                      self.bneck_alpha)
        a0 = self._proj(x, 'a0', self.up, dtype)
        e = self._proj(a0, 'b0', not self.up, dtype) - x
        return a0 + self._proj(e, 'a1', self.up, dtype)


class DDBPN(nn.Module):
    """NHWC f32 images in [0, 1] -> NHWC SR images in ``dtype`` (the input's
    dtype when None). ``use_pallas``: srtpu's (see the module note).
    Parameters of the 'cs' route: head0 (Conv2d 3x3, channels -> n0) and
    head_alpha0 (n0,), head1 (Conv2d 1x1, n0 -> nr) and head_alpha1
    (nr,); units.{i} (:class:`DenseProjection`; even i up, odd i down,
    the last up); out_weight (depth, 3, 3, r*r*nr, CO), the phase-dense
    output conv per HR block with CO = 16 * ceil(r*r*channels / 16), and
    out_bias (channels,). The live-tap masks are buffers (not saved).
    Off 'cs' the same head, units.{i} as :class:`FineProjection` and the
    fine output conv out_weight (3, 3, depth*nr, channels), out_bias.
    ``device`` places them; ``generator`` (a CPU ``torch.Generator``)
    draws the parameters at srtpu's init bounds."""

    GLOBAL_POOLING = False
    # Scales the card runs: every one (x8's 'cs' route is srtpu's XLA
    # branch in stock convs, as on the CPU)
    CARD_SCALES = (2, 4, 8)

    def __init__(self, scale_factor: int = 4, channels: int = 3,
                 n0: int = 128, nr: int = 32, depth: int = 6,
                 use_pallas: bool | str = 'cs',
                 dtype: torch.dtype | None = None, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        if use_pallas not in (False, True, 'cs'):
            raise ValueError(f"use_pallas must be False, True or 'cs', got "
                             f'{use_pallas!r}')
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
        unit = DenseProjection if use_pallas == 'cs' else FineProjection
        units = []
        for i in range(depth - 1):
            units.append(unit(nr, r, True, max(i, 1), i > 1, **kw))
            units.append(unit(nr, r, False, i + 1, i != 0, **kw))
        units.append(unit(nr, r, True, depth - 1, True, **kw))
        self.units = nn.ModuleList(units)
        bound_f = 1.0 / math.sqrt(9 * depth * nr)
        if use_pallas != 'cs':
            self.out_weight = uniform_param((3, 3, depth * nr, channels),
                                            bound_f, device, generator)
            self.out_bias = uniform_param((channels,), bound_f, device,
                                          generator)
            return
        co = -(-r * r * channels // 16) * 16
        self.out_weight = uniform_param((depth, 3, 3, r * r * nr, co),
                                        bound_f, device, generator)
        self.out_bias = uniform_param((channels,), bound_f, device,
                                      generator)
        for name, m in (('m_up', up_mask(r, nr, nr)),
                        ('m_down', down_mask(r, nr, nr)),
                        ('m_out', final_mask(r, nr, channels))):
            self.register_buffer(name, m.to(device=device, copy=True),
                                 persistent=False)

    @classmethod
    def reaches_kernel(cls, scale: int, kw: dict) -> bool:
        """Whether the route ``kw`` picks runs a kernel of the port at
        ``scale``: 'cs' at x2 and x4 (srtpu's kernel path)."""
        return route_of(cls, kw) == 'cs' and scale in (2, 4)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """``plain=True`` runs every kernel's plain PyTorch version instead
        (the reference the kernels are held against on the card); the
        routes without a kernel ignore it."""
        dtype = self.dtype or x.dtype
        if self.channels == 3:
            x = mean_shift(x, sign=-1)
        x = prelu(self.head0(x, dtype), self.head_alpha0)
        if self.use_pallas != 'cs':
            out = self._forward_fine(x, dtype)
        else:
            # the 1x1 head conv: one matmul in the compute dtype, then its
            # bias
            x = torch.matmul(x, self.head1.weight[0, 0].to(dtype)) \
                + self.head1.bias.to(dtype)
            out = self._forward_coarse(prelu(x, self.head_alpha1)
                                       .contiguous(), plain)
        if self.channels == 3:
            out = mean_shift(out, sign=1)
        return out

    def _forward_coarse(self, x: torch.Tensor, plain: bool) -> torch.Tensor:
        """The 'cs' body at LR resolution: K2 at x2 and x4, srtpu's XLA
        branch (:func:`~.common.conv_xla`) at x8."""
        r = self.scale_factor
        stock = r not in (2, 4)
        masks = (self.m_up, self.m_down)
        units = iter(self.units)
        hs, ls = [], []
        for i in range(self.depth - 1):
            hs.append(next(units)(ls if i else [x], masks, plain, stock))
            ls.append(next(units)(hs, masks, plain, stock))
        hs.append(next(units)(ls, masks, plain, stock))
        del ls, x
        bpd = b_phase_dense(self.out_bias, r, self.out_weight.shape[-1])
        acc = None
        for t, ht in enumerate(hs):
            b = bpd if t == 0 else torch.zeros_like(bpd)
            w = self.out_weight[t] * self.m_out
            y = conv_xla(ht, w, b) if stock else conv3x3(ht, w, b, plain)
            acc = y if acc is None else acc + y
        return pm_to_nhwc(acc, r, self.channels)

    def _forward_fine(self, x: torch.Tensor, dtype) -> torch.Tensor:
        """srtpu's XLA route (ddbpn.py:234-262) after the 3x3 head: the
        1x1 head conv, the fine units over concats, the output conv."""
        x = prelu(self.head1(x, dtype), self.head_alpha1)
        units = iter(self.units)
        hs, ls = [], []
        for i in range(self.depth - 1):
            hs.append(next(units)(ls if i else [x], dtype))
            ls.append(next(units)(hs, dtype))
        hs.append(next(units)(ls, dtype))
        return _conv(torch.cat(hs, -1), self.out_weight, self.out_bias,
                     dtype)
