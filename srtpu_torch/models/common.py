"""Building blocks of the models (NHWC, HWIO weights).

Counterparts of ``srtpu/models/common.py``: ``Conv2d`` (torch-default
init), ``WNConv2d`` (weight-normed, WDSR's), ``PReLU``, ``mean_shift``,
``pixel_shuffle``, ``Trunk`` (``CSTrunk``), ``BNTrunk`` (``CSBNTrunk``),
``UpscaleTail`` (``CSUpscaleTail``) and ``UpscaleBlock`` (the XLA
sub-pixel upscaler). ``Trunk.forward_nhwc`` and
``UpscaleTail.forward_stock`` run srtpu's other EDSR routes (the fused
NHWC blocks, K8a, or stock ``ResBlock``s; the XLA tail) on the same
parameters; :func:`xla_trunk` runs srtpu's XLA BN blocks (SRResNet's and
SRGAN's routes off 'cs', flax's :func:`batch_norm`) on ``BNTrunk``'s.
``_conv``, ``_conv_transpose`` and :func:`conv_xla` are srtpu's XLA
convs with its roundings (``Conv2d``, ``ConvTranspose2d``,
``conv3x3_reference``), stock ``F.conv2d`` (the transposed conv as one
forward conv per output phase and a pixel shuffle);
each model class's ``reaches_kernel`` says which routes run a kernel
(:func:`route_of` reads the route). ``resize_matrix`` /
``bicubic_resize`` are srtpu's bicubic matrices and their two f32 matmuls (SRCNN's pre-upsample). Past 96
features ``Trunk`` and ``UpscaleTail`` take srtpu's XLA fallbacks of
its CS modules (stock ops, no kernel), as srtpu does.
Parameters are f32; ``dtype`` is the compute type (bf16 on the card).
The kernel ops take the f32 parameters and cast inside, so under
autograd their weight grads come back in f32 (as srtpu's ``custom_vjp``s
do); the tail's weight rewrites (``w_pm_hwio``, ``w_phase_dense``) stay
f32 and differentiable. Every module's ``forward`` takes ``plain=False``:
True runs the kernels' plain PyTorch versions on any device, which is
how a run on the card is held against the kernels.
"""

from __future__ import annotations

import inspect
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv3x3, resblock_fused_trunk, trunk, upsample
from ..ops.bn_block import bn_close_ref, bn_resblock_ref, bn_trunk
from ..ops.conv import conv3x3_plain, conv_f32
from ..ops.layout import (b_phase_dense, b_pm, pixel_shuffle, pm_to_nhwc,
                          reflect_pad, w_phase_dense, w_pm_hwio)
from ..ops.trunk import trunk_xla

# DIV2K training-set RGB statistics (srtpu/models/common.py:29-30)
DIV2K_RGB_MEAN = (0.4488, 0.4371, 0.4040)

__all__ = ['DIV2K_RGB_MEAN', 'BNTrunk', 'Conv2d', 'PReLU', 'Trunk',
           'UpscaleBlock', 'UpscaleTail', 'WNConv2d', 'batch_norm',
           'bicubic_resize', 'conv_xla', 'device_const', 'mean_shift',
           'pixel_shuffle', 'prelu', 'resize_matrix', 'route_of',
           'uniform_param', 'xla_trunk']

_CONSTS: dict[tuple, torch.Tensor] = {}


def device_const(key: tuple, make) -> torch.Tensor:
    """The constant ``make()`` (a tensor on its device) under ``key``,
    made at its first use and kept: a forward makes no host-to-device
    copy a call, which a CUDA graph of the train step could not capture.
    Made outside inference mode, so a training step may save it; under
    ``torch.export``'s tracing made anew (a traced value is no
    constant to keep)."""
    if torch.compiler.is_compiling():
        return make()
    t = _CONSTS.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = _CONSTS[key] = make()
    return t


def uniform_param(shape, bound: float, device, generator: torch.Generator
                  ) -> nn.Parameter:
    """f32 parameter drawn from U(-bound, bound) (torch's Conv2d default
    for kernel and bias, srtpu ``torch_uniform_init``). ``generator`` is a
    CPU generator, so a seed gives the same weights on every device."""
    t = torch.empty(shape).uniform_(-bound, bound, generator=generator)
    return nn.Parameter(t.to(device))


def mean_shift(x: torch.Tensor, sign: int, rgb_range: float = 1.0,
               rgb_mean: Sequence[float] = DIV2K_RGB_MEAN,
               rgb_std: Sequence[float] = (1.0, 1.0, 1.0)) -> torch.Tensor:
    """Frozen DIV2K mean shift in x's dtype: sign=-1 subtracts the mean,
    +1 adds it back (srtpu/models/common.py:206-216)."""
    mean, std = (device_const(
        ('rgb', tuple(v), x.dtype, x.device),
        lambda v=v: torch.tensor(v, dtype=x.dtype, device=x.device))
        for v in (rgb_mean, rgb_std))
    return x / std + sign * rgb_range * mean / std


class Conv2d(nn.Module):
    """'same' k x k conv on NHWC with an HWIO weight. In the compute dtype
    as srtpu's ``Conv2d``: the conv's result rounds to ``dtype``, then the
    bias (cast to ``dtype``) is added. ``padding='reflect'`` pads k // 2
    mirrored pixels instead of zeros (srtpu's ``_reflect_pad`` before a
    'valid' conv: SRGAN's 9x9 head and output); ``stride`` as srtpu's
    ``strides`` at padding k // 2 (SRGAN's discriminator). A plain
    ``F.conv2d``: srtpu leaves these convs (the 3 -> C head) to XLA, not
    to a kernel."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, *,
                 padding: str = 'same', stride: int = 1, device=None,
                 generator: torch.Generator):
        super().__init__()
        if padding not in ('same', 'reflect'):
            raise ValueError(f"padding must be 'same' or 'reflect', got "
                             f"{padding!r}")
        self.reflect, self.stride = padding == 'reflect', stride
        bound = 1.0 / math.sqrt(kernel_size * kernel_size * in_ch)
        self.weight = uniform_param(
            (kernel_size, kernel_size, in_ch, out_ch), bound, device,
            generator)
        self.bias = uniform_param((out_ch,), bound, device, generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return _conv(x, self.weight, self.bias, dtype, self.reflect,
                     self.stride)


def _conv(x, w, b, dtype, reflect: bool = False, stride: int = 1,
          padding: int | None = None):
    """'same' (or reflect-padded) conv of NHWC x with HWIO w in ``dtype``:
    the result rounds to ``dtype``, then b (cast to ``dtype``) is
    added. ``padding`` (zeros on each side) replaces the k // 2 of
    'same' (DDBPN's strided projections)."""
    w = w.to(dtype)
    p = w.shape[0] // 2 if padding is None else padding
    xc = x.to(dtype).permute(0, 3, 1, 2).float()
    if reflect:
        xc, p = reflect_pad(xc, p), 0
    y = F.conv2d(xc, w.permute(3, 2, 0, 1).float(), stride=stride, padding=p)
    return y.permute(0, 2, 3, 1).to(dtype) + b.to(dtype)


def _conv_transpose(x, w, b, dtype, stride: int, padding: int):
    """srtpu ``ConvTranspose2d`` (torch's geometry, here k = stride + 2
    padding: out = stride in) of NHWC x with its HWOI kernel w in
    ``dtype``: the f32 product sum of the rounded operands rounds to
    ``dtype``, then b (cast to ``dtype``) is added. srtpu states it as an
    input-dilated conv with the flipped kernel; this runs the same sums as
    one forward conv over the LR grid, each output phase (a, b) of the s x
    s block its own channels (:func:`phase_kernel`), then a pixel shuffle.
    A forward conv repeats on cuDNN (F.conv_transpose2d is cuDNN's data
    gradient, whose default algorithms add with atomics: one input gave
    images a bf16 step apart from call to call); the backward follows the
    caller's ``torch.backends.cudnn.deterministic``."""
    k = w.shape[0]
    if k != stride + 2 * padding:
        raise ValueError(f'transposed conv needs k = stride + 2 padding, got '
                         f'k {k}, stride {stride}, padding {padding}')
    wp, lo, hi = phase_kernel(w.to(dtype).float(), stride, padding)
    xc = F.pad(x.to(dtype).permute(0, 3, 1, 2).float(), (lo, hi, lo, hi))
    y = F.pixel_shuffle(F.conv2d(xc, wp), stride)
    return y.permute(0, 2, 3, 1).to(dtype) + b.to(dtype)


def phase_kernel(w: torch.Tensor, stride: int, padding: int):
    """The forward-conv form of a transposed conv's HWOI kernel w (k, k,
    O, I): output pixel s i + a takes x[i + d] w[a + p - s d] over the
    offsets d whose tap lies in [0, k). Returns the OIHW weight (O s s, I,
    n, n), channel (o, a, b) in ``F.pixel_shuffle``'s order, and the LR
    zero padding (lo, hi) before and after, n = lo + hi + 1; the taps
    outside the kernel are 0. Differentiable in w."""
    k, s, p = w.shape[0], stride, padding
    lo = max((k - 1 - a - p) // s for a in range(s))
    hi = max((a + p) // s for a in range(s))
    d = torch.arange(-lo, hi + 1, device=w.device)
    tap = torch.arange(s, device=w.device)[:, None] + p - s * d  # (s, n)
    live = (tap >= 0) & (tap < k)
    idx = tap.clamp(0, k - 1)
    g = w[idx][:, :, idx]                       # (a, dy, b, dx, O, I)
    g = g * (live[:, :, None, None] & live[None, None]).to(w.dtype)[
        ..., None, None]
    n = lo + hi + 1
    return (g.permute(4, 0, 2, 5, 1, 3).reshape(-1, w.shape[3], n, n),
            lo, hi)


def conv_xla(x, w, b):
    """srtpu ``conv3x3_reference``, which its kernel routes run where the
    kernels do not (DDBPN x8's coarse branch): the 'same' conv of NHWC x
    with HWIO w (cast to x's dtype) in f32, plus b in f32, rounded once
    to x's dtype. Stock ``F.conv2d`` (cuDNN on the card)."""
    y = F.conv2d(x.permute(0, 3, 1, 2).float(),
                 w.to(x.dtype).permute(3, 2, 0, 1).float(),
                 padding=w.shape[0] // 2)
    return (y.permute(0, 2, 3, 1) + b.float()).to(x.dtype)


def route_of(cls, kw: dict, name: str = 'use_pallas'):
    """The ``use_pallas`` (or keyword ``name``) a model class builds from
    the keywords ``kw``: the given one, else the class's default (None
    for a class without one)."""
    param = inspect.signature(cls).parameters.get(name)
    return kw.get(name, None if param is None else param.default)


class WNConv2d(nn.Module):
    """Weight-normed 'same' k x k conv (srtpu ``WNConv2d``,
    srtpu/models/common.py:142-188): parameters ``v`` (HWIO), ``g``
    (C_out) and ``bias``; the weight w = v g / sqrt(sum_{h,w,i} v^2 +
    1e-12) in f32. v and the bias draw from U(+-1/sqrt(fan_in)), and g
    starts at ||v||, so the first forward is the plain conv's. The conv
    runs as ``Conv2d``'s: stock ``F.conv2d`` (srtpu leaves it to XLA)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, *,
                 device=None, generator: torch.Generator):
        super().__init__()
        bound = 1.0 / math.sqrt(kernel_size * kernel_size * in_ch)
        self.v = uniform_param((kernel_size, kernel_size, in_ch, out_ch),
                               bound, device, generator)
        self.g = nn.Parameter(self.v.detach().reshape(-1, out_ch).norm(dim=0))
        self.bias = uniform_param((out_ch,), bound, device, generator)

    def weight(self) -> torch.Tensor:
        """The materialised f32 weight, differentiable in v and g."""
        norm = torch.sqrt(self.v.square().sum((0, 1, 2)) + 1e-12)
        return self.v * (self.g / norm)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return _conv(x, self.weight(), self.bias, dtype)


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """PReLU with one slope, applied in x's dtype (srtpu ``PReLU``: the
    slope is cast to x's dtype)."""
    return torch.where(x >= 0, x, alpha.to(x.dtype) * x)


class PReLU(nn.Module):
    """torch ``nn.PReLU()`` semantics: one scalar slope ``alpha``, f32,
    initialised to 0.25 (srtpu/models/common.py:191-203)."""

    def __init__(self, init: float = 0.25, *, device=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1,), init, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return prelu(x, self.alpha)


# srtpu's CSTrunk runs its CS kernels up to 96 features and XLA convs past
# them (srtpu/models/common.py:387-392: the CS layout wins only while C
# under-fills the TPU's 128 lanes); the port takes the same gate, so past
# 96 features it computes srtpu's XLA math. At or below it srtpu also
# switches its backward form by a TPU VMEM budget (_MEGA_ACC_BUDGET);
# K1 keeps no such accumulators and computes both forms' function, so
# the port has one route there.
CS_MAX_FEATS = 96


class Trunk(nn.Module):
    """EDSR trunk: n_resblocks resblocks, the close conv and the global
    skip (srtpu ``CSTrunk``). Block weights are stacked HWIO: w1, w2 (L,
    3, 3, C, C); b1, b2 (L, C). K1 and K2 up to CS_MAX_FEATS features
    (64 on the card; other widths raise there, ROADMAP.md F4), srtpu's
    XLA math in stock ops past them (``ops.trunk.trunk_xla``: h1 kept in
    f32, no kernel)."""

    def __init__(self, n_feats: int = 64, n_resblocks: int = 16,
                 res_scale: float = 1.0, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        self.res_scale = res_scale
        n, nb = n_feats, n_resblocks
        self.xla = n > CS_MAX_FEATS
        bound = 1.0 / math.sqrt(9 * n)
        self.w1 = uniform_param((nb, 3, 3, n, n), bound, device, generator)
        self.b1 = uniform_param((nb, n), bound, device, generator)
        self.w2 = uniform_param((nb, 3, 3, n, n), bound, device, generator)
        self.b2 = uniform_param((nb, n), bound, device, generator)
        self.close_weight = uniform_param((3, 3, n, n), bound, device,
                                          generator)
        self.close_bias = uniform_param((n,), bound, device, generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                plain: bool = False) -> torch.Tensor:
        xd = x.to(dtype)
        if self.xla:
            return trunk_xla(xd, self.w1, self.b1, self.w2, self.b2,
                             self.res_scale, self.close_weight,
                             self.close_bias)
        res = trunk(xd, self.w1, self.b1, self.w2, self.b2, self.res_scale,
                    plain)
        res = conv3x3(res, self.close_weight, self.close_bias, plain)
        return res + xd       # the skip is one more rounding, as in srtpu

    def forward_nhwc(self, x: torch.Tensor, dtype: torch.dtype,
                     fused: bool, plain: bool = False) -> torch.Tensor:
        """srtpu's NHWC routes on these parameters: ``fused`` runs K8a's
        trunk op (srtpu's ``FusedResBlock`` block after block: f32 h1,
        bf16 weight grads; one host call forward), else srtpu's
        ``ResBlock`` (stock convs, ``res * res_scale + x`` in ``dtype``);
        both close with a stock conv and the global skip, as srtpu's XLA.
        ``plain`` runs K8a's plain version."""
        xd = x.to(dtype)
        if fused:
            res = resblock_fused_trunk(xd, self.w1, self.b1, self.w2,
                                       self.b2, self.res_scale, plain)
        else:
            res = xd
            for w1, b1, w2, b2 in zip(*(t.unbind(0) for t in (
                    self.w1, self.b1, self.w2, self.b2))):
                r = _conv(torch.relu(_conv(res, w1, b1, dtype)), w2, b2,
                          dtype)
                res = r * self.res_scale + res
        return _conv(res, self.close_weight, self.close_bias, dtype) + xd


class BNTrunk(nn.Module):
    """SRResNet trunk (srtpu ``CSBNTrunk``): n_resblocks BatchNorm
    resblocks (conv - BN - PReLU - conv - BN + skip), the closing conv +
    BN and the global skip. Weights stacked HWIO: w1, w2 (L, 3, 3, C, C);
    b1, b2, bn{1,2}_scale, bn{1,2}_bias (L, C); alpha (L, 1); the close
    conv close_w (3, 3, C, C), close_b, close_bn_scale, close_bn_bias
    (C,). Running statistics are buffers: mean1, var1, mean2, var2 (L, C),
    mean_close, var_close (C,) (srtpu's ``batch_stats``).

    Train mode runs K4 on batch statistics, the whole trunk in one host
    call each way (:func:`bn_trunk`), and then updates the running
    statistics once (:meth:`update_running`). Eval mode normalises with the running
    statistics on stock PyTorch convs (:func:`bn_resblock_ref`), as srtpu
    runs eval on XLA; ``plain`` changes nothing there. ``reflect`` gives
    every conv REFLECT boundaries (SRGAN's generator): K4r in train mode,
    reflect-padded stock convs in eval mode. K4's kernels take 64
    channels: other widths run train mode on the CPU only."""

    MOMENTUM = 0.9

    def __init__(self, n_feats: int = 64, n_resblocks: int = 16,
                 reflect: bool = False, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        self.reflect = reflect
        n, nb = n_feats, n_resblocks
        bound = 1.0 / math.sqrt(9 * n)

        def const(shape, v):
            return nn.Parameter(torch.full(shape, v, device=device))

        self.w1 = uniform_param((nb, 3, 3, n, n), bound, device, generator)
        self.b1 = uniform_param((nb, n), bound, device, generator)
        self.bn1_scale, self.bn1_bias = const((nb, n), 1.0), const((nb, n), 0.)
        self.alpha = const((nb, 1), 0.25)
        self.w2 = uniform_param((nb, 3, 3, n, n), bound, device, generator)
        self.b2 = uniform_param((nb, n), bound, device, generator)
        self.bn2_scale, self.bn2_bias = const((nb, n), 1.0), const((nb, n), 0.)
        self.close_w = uniform_param((3, 3, n, n), bound, device, generator)
        self.close_b = uniform_param((n,), bound, device, generator)
        self.close_bn_scale = const((n,), 1.0)
        self.close_bn_bias = const((n,), 0.0)
        for name, shape, v in (('mean1', (nb, n), 0.0), ('var1', (nb, n), 1.0),
                               ('mean2', (nb, n), 0.0), ('var2', (nb, n), 1.0),
                               ('mean_close', (n,), 0.0),
                               ('var_close', (n,), 1.0)):
            self.register_buffer(name, torch.full(shape, v, device=device))

    def _blocks(self):
        """Each block's parameters; one unbind per stack, so the backward
        stacks each parameter's grads once instead of adding L
        zero-padded copies."""
        return list(zip(*(t.unbind(0) for t in (
            self.w1, self.b1, self.bn1_scale, self.bn1_bias, self.alpha,
            self.w2, self.b2, self.bn2_scale, self.bn2_bias))))

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                plain: bool = False) -> torch.Tensor:
        xd = x.to(dtype).contiguous()
        close = (self.close_w, self.close_b, self.close_bn_scale,
                 self.close_bn_bias)
        rf = self.reflect
        if not self.training:
            u = xd
            for i, prm in enumerate(self._blocks()):
                u = bn_resblock_ref(u, *prm, self.mean1[i], self.var1[i],
                                    self.mean2[i], self.var2[i], rf)
            return bn_close_ref(u, xd, *close, self.mean_close,
                                self.var_close, rf)
        if xd.is_cuda and not plain and xd.shape[-1] != 64:
            raise ValueError(
                f'BNTrunk: K4 takes 64 channels on CUDA, got '
                f'{xd.shape[-1]} (train mode; eval mode runs any width)')
        out, sts = bn_trunk(xd, self.w1, self.b1, self.bn1_scale,
                            self.bn1_bias, self.alpha, self.w2, self.b2,
                            self.bn2_scale, self.bn2_bias, *close,
                            plain=plain, reflect=rf)
        c = sts.shape[0] - 1
        self.update_running(sts[0:c:2, 0], sts[0:c:2, 1], sts[1:c:2, 0],
                            sts[1:c:2, 1], sts[c, 0], sts[c, 1])
        return out

    @torch.no_grad()
    def update_running(self, mean1, var1, mean2, var2, mean_close,
                       var_close) -> None:
        """ra <- 0.9 ra + 0.1 batch for each running statistic, from the
        batch means and biased variances in the buffers' shapes (srtpu's
        BatchNorm, momentum 0.9)."""
        mom = self.MOMENTUM
        for name, b in zip(('mean1', 'var1', 'mean2', 'var2', 'mean_close',
                            'var_close'),
                           (mean1, var1, mean2, var2, mean_close, var_close)):
            ra = getattr(self, name)
            ra.copy_(mom * ra + (1 - mom) * b)


MOMENTUM, EPS = 0.9, 1e-5     # flax nn.BatchNorm(momentum=0.9, epsilon=1e-5)


def batch_norm(x: torch.Tensor, scale, bias, mean, var,
               training: bool) -> torch.Tensor:
    """flax 0.12 ``nn.BatchNorm`` on NHWC x: in training, the batch's mean
    and E[x^2] - mean^2 (clamped at 0) in f32, and the running statistics
    ``mean``, ``var`` (updated in place) move ra <- 0.9 ra + 0.1 batch
    with that biased variance; else those running statistics. y = (x -
    mean) * (scale * rsqrt(var + 1e-5)) + bias in f32, rounded to x's
    dtype once."""
    xf = x.float()
    if training:
        dims = tuple(range(x.dim() - 1))
        bm = xf.mean(dims)
        bv = ((xf * xf).mean(dims) - bm * bm).clamp_min(0.0)
        with torch.no_grad():
            mean.copy_(MOMENTUM * mean + (1 - MOMENTUM) * bm)
            var.copy_(MOMENTUM * var + (1 - MOMENTUM) * bv)
        mean, var = bm, bv
    y = (xf - mean) * (scale * torch.rsqrt(var + EPS))
    return (y + bias).to(x.dtype)


def xla_trunk(trunk: BNTrunk, x: torch.Tensor, dtype) -> torch.Tensor:
    """srtpu's BN trunk off its 'cs' route, in stock ops on ``trunk``'s
    stacked parameters: per block a 3x3 conv (srtpu's ``Conv2d``: the
    conv rounds to ``dtype``, then the bias in ``dtype`` is added),
    :func:`batch_norm`, PReLU (the slope in x's dtype), the second conv
    and batch norm, and the skip x + res in ``dtype``; then the closing
    conv + batch norm and the global skip. A ``reflect`` trunk pads
    every conv by mirroring, as SRGAN's ``_SRGANBlock`` and its close
    (srtpu/models/srgan.py:25-41, :87-93); with zeros the blocks are
    srtpu's ``ResBlock(norm='batch', act=PReLU)``
    (srtpu/models/common.py:269-296) and the close its ``BasicBlock``
    (:241-266), SRResNet's. In the trunk's train mode each batch norm
    normalises with the batch statistics and moves its running ones, in
    eval mode it reads them. No kernel of the port runs here."""
    rf, tr = trunk.reflect, trunk.training
    xd = x.to(dtype)
    res = xd
    for i, (w1, b1, ga1, be1, alpha, w2, b2, ga2, be2) in enumerate(
            trunk._blocks()):
        h = batch_norm(_conv(res, w1, b1, dtype, reflect=rf), ga1, be1,
                       trunk.mean1[i], trunk.var1[i], tr)
        h = batch_norm(_conv(prelu(h, alpha), w2, b2, dtype, reflect=rf),
                       ga2, be2, trunk.mean2[i], trunk.var2[i], tr)
        res = res + h
    h = batch_norm(_conv(res, trunk.close_w, trunk.close_b, dtype,
                         reflect=rf), trunk.close_bn_scale,
                   trunk.close_bn_bias, trunk.mean_close, trunk.var_close, tr)
    return xd + h


class UpscaleTail(nn.Module):
    """Sub-pixel upscaler + final conv (srtpu ``CSUpscaleTail``). EDSR's:
    act=None, final_ksize=3 (reference UpscaleBlock + Conv2d); SRResNet's:
    act='prelu', final_ksize=9 (a PReLU after every stage, with its own
    slope up{i}_alpha, and a 9x9 HR output conv).

    Stages are x2 (log2(scale) of them) or one x3. Every stage but the
    last runs K3 (conv + shuffle). The last stays phase-major at coarse
    resolution (K2 with ``w_pm_hwio``; a scalar-slope PReLU is exact on
    phase-major channels), and the final conv runs as a phase-dense
    coarse conv over its r*r*C channels (K2 with ``w_phase_dense``, c_out
    padded to 16): 3x3 for final_ksize 3, 5x5 for 9 at r = 2;
    ``pm_to_nhwc`` then gives the fine image. Past 96 features the tail
    is srtpu's XLA fallback instead (:meth:`forward_xla`). Weights are
    stored as the plain tail's: up{i}_weight HWIO (3, 3, C, r*r*C) and
    up{i}_bias in PixelShuffle order, final_weight (k, k, C, ch)."""

    def __init__(self, scale_factor: int = 4, n_feats: int = 64,
                 channels: int = 3, act: str | None = None,
                 final_ksize: int = 3, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        if scale_factor not in (2, 3, 4, 8):
            raise ValueError(f'scale_factor must be 2, 3, 4 or 8, got '
                             f'{scale_factor}')
        if act not in (None, 'prelu'):
            raise ValueError(f"act must be None or 'prelu', got {act!r}")
        self.rs = [3] if scale_factor == 3 else \
            [2] * int(math.log2(scale_factor))
        self.channels = channels
        self.act = act
        self.n_feats = n_feats
        n = n_feats
        bound = 1.0 / math.sqrt(9 * n)
        for i, r in enumerate(self.rs):
            self.register_parameter(f'up{i}_weight', uniform_param(
                (3, 3, n, r * r * n), bound, device, generator))
            self.register_parameter(f'up{i}_bias', uniform_param(
                (r * r * n,), bound, device, generator))
            if act:
                self.register_parameter(f'up{i}_alpha', nn.Parameter(
                    torch.full((1,), 0.25, device=device)))
        bound_f = 1.0 / math.sqrt(final_ksize * final_ksize * n)
        self.final_weight = uniform_param(
            (final_ksize, final_ksize, n, channels), bound_f, device,
            generator)
        self.final_bias = uniform_param((channels,), bound_f, device,
                                        generator)

    def _act(self, y: torch.Tensor, i: int) -> torch.Tensor:
        return prelu(y, getattr(self, f'up{i}_alpha')) if self.act else y

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                plain: bool = False) -> torch.Tensor:
        if self.n_feats > CS_MAX_FEATS:
            return self.forward_xla(x, dtype)
        y = x.to(dtype)
        for i, r in enumerate(self.rs[:-1]):
            y = self._act(upsample(y, getattr(self, f'up{i}_weight'),
                                   getattr(self, f'up{i}_bias'), r, plain), i)
        r, last = self.rs[-1], len(self.rs) - 1
        y = conv3x3(y, w_pm_hwio(getattr(self, f'up{last}_weight'), r),
                    b_pm(getattr(self, f'up{last}_bias'), r), plain)
        y = self._act(y, last)
        wpd = w_phase_dense(self.final_weight, r)
        bpd = b_phase_dense(self.final_bias, r, wpd.shape[-1])
        y = conv3x3(y, wpd, bpd, plain)
        return pm_to_nhwc(y, r, self.channels)

    def forward_xla(self, x: torch.Tensor, dtype: torch.dtype
                    ) -> torch.Tensor:
        """srtpu ``CSUpscaleTail``'s XLA fallback, which it takes past 96
        features (srtpu/models/common.py:525, :574-583), in stock ops:
        each stage ``_xla_upstage`` (the conv rounded to ``dtype``, its
        f32 bias added and rounded again, ``pixel_shuffle``, the PReLU
        when ``act``), then ``conv3x3_reference`` (f32 conv + f32 bias,
        one rounding). No kernel of the port runs here."""
        y = x.to(dtype)
        for i, r in enumerate(self.rs):
            w = getattr(self, f'up{i}_weight').to(dtype)
            y = (conv_f32(y, w).to(dtype).float()
                 + getattr(self, f'up{i}_bias').float()).to(dtype)
            y = self._act(pixel_shuffle(y, r), i)
        return conv3x3_plain(y, self.final_weight.to(dtype),
                             self.final_bias.float())

    def forward_stock(self, x: torch.Tensor, dtype: torch.dtype
                      ) -> torch.Tensor:
        """srtpu's XLA tail on these weights (``UpscaleBlock`` and the
        final ``Conv2d``): each stage a stock conv and ``pixel_shuffle``
        (with its PReLU when ``act``), then the final conv, stock."""
        y = x.to(dtype)
        for i, r in enumerate(self.rs):
            y = self._act(pixel_shuffle(_conv(
                y, getattr(self, f'up{i}_weight'),
                getattr(self, f'up{i}_bias'), dtype), r), i)
        return _conv(y, self.final_weight, self.final_bias, dtype)


class UpscaleBlock(nn.Module):
    """Sub-pixel upscaler (srtpu ``UpscaleBlock``): log2(scale) stages
    (one at x3) of a 3x3 conv C -> r*r*C, r = 3 at x3 and 2 otherwise,
    then ``pixel_shuffle``; with ``act='prelu'`` (SRGAN's) a PReLU after
    each stage's shuffle, one slope per stage (``acts``); ``in_feats``
    (default ``n_feats``) is the first conv's input width (RDN's G0 where
    its growth G differs). srtpu runs it
    in XLA, outside any Pallas kernel, so each conv is the port's
    ``Conv2d`` (cuDNN on the card); ``plain`` changes nothing here."""

    def __init__(self, scale_factor: int = 4, n_feats: int = 64,
                 act: str | None = None, *, in_feats: int | None = None,
                 device=None, generator: torch.Generator):
        super().__init__()
        if scale_factor not in (2, 3, 4, 8):
            raise ValueError(f'scale_factor must be 2, 3, 4 or 8, got '
                             f'{scale_factor}')
        if act not in (None, 'prelu'):
            raise ValueError(f"act must be None or 'prelu', got {act!r}")
        self.r = 3 if scale_factor == 3 else 2
        stages = int(math.log2(scale_factor))
        self.convs = nn.ModuleList(
            Conv2d((in_feats or n_feats) if i == 0 else n_feats,
                   n_feats * self.r * self.r, 3, device=device,
                   generator=generator) for i in range(stages))
        self.acts = nn.ModuleList(
            PReLU(device=device) for _ in range(stages if act else 0))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        for i, conv in enumerate(self.convs):
            x = pixel_shuffle(conv(x, dtype), self.r)
            if self.acts:
                x = self.acts[i](x)
        return x


def _cubic_kernel(t: np.ndarray, a: float) -> np.ndarray:
    """Keys cubic convolution kernel with free parameter a
    (srtpu/models/common.py:664-671)."""
    t = np.abs(t)
    t2, t3 = t * t, t * t * t
    return np.where(t <= 1, (a + 2) * t3 - (a + 3) * t2 + 1,
                    np.where(t < 2, a * t3 - 5 * a * t2 + 8 * a * t - 4 * a,
                             0.0))


def resize_matrix(in_size: int, out_size: int, a: float = -0.75,
                  antialias: bool = True) -> np.ndarray:
    """Dense (out_size, in_size) f32 bicubic interpolation matrix, srtpu's
    numpy construction (srtpu/models/common.py:674-705): a = -0.75 is
    ``F.interpolate(mode='bicubic', align_corners=False)``'s kernel;
    ``antialias`` widens the support on a downscale and renormalises
    over the in-range taps (PIL's border), otherwise out-of-range taps
    clamp to the edge pixel (torch's border)."""
    scale = out_size / in_size
    support_scale = max(1.0 / scale, 1.0) if antialias and scale < 1 else 1.0
    support = 2.0 * support_scale
    out_coords = (np.arange(out_size) + 0.5) / scale - 0.5
    left = np.floor(out_coords - support).astype(np.int64) + 1
    n_taps = int(np.ceil(support)) * 2 + 2
    idx = left[:, None] + np.arange(n_taps)[None, :]
    weights = _cubic_kernel((out_coords[:, None] - idx) / support_scale, a)
    if antialias:
        weights = np.where((idx >= 0) & (idx < in_size), weights, 0.0)
    weights = weights / np.maximum(weights.sum(axis=1, keepdims=True), 1e-12)
    idx = np.clip(idx, 0, in_size - 1)
    mat = np.zeros((out_size, in_size), dtype=np.float32)
    np.add.at(mat, (np.repeat(np.arange(out_size), n_taps), idx.ravel()),
              weights.ravel().astype(np.float32))
    return mat


def bicubic_resize(x: torch.Tensor, out_hw: tuple[int, int],
                   a: float = -0.75, antialias: bool = True) -> torch.Tensor:
    """Bicubic resize of NHWC ``x`` to ``out_hw``: two f32 matmuls with
    :func:`resize_matrix` (rows, then columns), cast back to x's dtype
    (srtpu/models/common.py:708-717). srtpu computes it outside any Pallas
    kernel, so it is a plain matmul here; TF32 stays off (PyTorch's
    default for ``matmul``)."""
    h, w = x.shape[1], x.shape[2]
    oh, ow = out_hw
    mh, mw = (device_const(
        ('bicubic', n, on, a, antialias, x.device),
        lambda n=n, on=on: torch.from_numpy(resize_matrix(
            n, on, a, antialias)).to(x.device))
        for n, on in ((h, oh), (w, ow)))
    y = torch.einsum('oh,bhwc->bowc', mh, x.float())
    y = torch.einsum('pw,bhwc->bhpc', mw, y)
    return y.to(x.dtype)
