"""Building blocks of the models (NHWC, HWIO weights).

Counterparts of ``srtpu/models/common.py``: ``Conv2d`` (torch-default
init), ``WNConv2d`` (weight-normed, WDSR's), ``PReLU``, ``mean_shift``,
``pixel_shuffle``, ``Trunk`` (``CSTrunk``), ``BNTrunk`` (``CSBNTrunk``),
``UpscaleTail`` (``CSUpscaleTail``) and ``UpscaleBlock`` (the XLA
sub-pixel upscaler).
Parameters are f32; ``dtype`` is the compute type (bf16 on the card).
The kernel ops take the f32 parameters and cast inside, so under
autograd their weight grads come back in f32 (as srtpu's ``custom_vjp``s
do); the tail's weight rewrites (``w_pm_hwio``, ``w_phase_dense``) stay
f32 and differentiable. Every module's ``forward`` takes ``plain=False``:
True runs the kernels' plain PyTorch versions on any device, which is
how a run on the card is held against the kernels.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv3x3, trunk, upsample
from ..ops.bn_block import bn_close, bn_close_ref, bn_resblock, bn_resblock_ref
from ..ops.layout import (b_phase_dense, b_pm, pixel_shuffle, pm_to_nhwc,
                          w_phase_dense, w_pm_hwio)

# DIV2K training-set RGB statistics (srtpu/models/common.py:29-30)
DIV2K_RGB_MEAN = (0.4488, 0.4371, 0.4040)

__all__ = ['DIV2K_RGB_MEAN', 'BNTrunk', 'Conv2d', 'PReLU', 'Trunk',
           'UpscaleBlock', 'UpscaleTail', 'WNConv2d', 'mean_shift',
           'pixel_shuffle', 'prelu', 'uniform_param']


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
    mean = torch.tensor(rgb_mean, dtype=x.dtype, device=x.device)
    std = torch.tensor(rgb_std, dtype=x.dtype, device=x.device)
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


def _conv(x, w, b, dtype, reflect: bool = False, stride: int = 1):
    """'same' (or reflect-padded) conv of NHWC x with HWIO w in ``dtype``:
    the result rounds to ``dtype``, then b (cast to ``dtype``) is
    added."""
    w = w.to(dtype)
    p = w.shape[0] // 2
    xc = x.to(dtype).permute(0, 3, 1, 2).float()
    if reflect:
        xc, p = F.pad(xc, (p, p, p, p), mode='reflect'), 0
    y = F.conv2d(xc, w.permute(3, 2, 0, 1).float(), stride=stride, padding=p)
    return y.permute(0, 2, 3, 1).to(dtype) + b.to(dtype)


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


class Trunk(nn.Module):
    """EDSR trunk: n_resblocks resblocks (K1), the close conv (K2) and the
    global skip (srtpu ``CSTrunk``). Block weights are stacked HWIO:
    w1, w2 (L, 3, 3, C, C); b1, b2 (L, C)."""

    def __init__(self, n_feats: int = 64, n_resblocks: int = 16,
                 res_scale: float = 1.0, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        self.res_scale = res_scale
        n, nb = n_feats, n_resblocks
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
        res = trunk(xd, self.w1, self.b1, self.w2, self.b2, self.res_scale,
                    plain)
        res = conv3x3(res, self.close_weight, self.close_bias, plain)
        return res + xd       # the skip is one more rounding, as in srtpu


class BNTrunk(nn.Module):
    """SRResNet trunk (srtpu ``CSBNTrunk``): n_resblocks BatchNorm
    resblocks (conv - BN - PReLU - conv - BN + skip), the closing conv +
    BN and the global skip. Weights stacked HWIO: w1, w2 (L, 3, 3, C, C);
    b1, b2, bn{1,2}_scale, bn{1,2}_bias (L, C); alpha (L, 1); the close
    conv close_w (3, 3, C, C), close_b, close_bn_scale, close_bn_bias
    (C,). Running statistics are buffers: mean1, var1, mean2, var2 (L, C),
    mean_close, var_close (C,) (srtpu's ``batch_stats``).

    Train mode runs K4 (:func:`bn_resblock` per block, :func:`bn_close`)
    on batch statistics and then updates the running statistics once,
    ra <- 0.9 ra + 0.1 batch with the biased batch variance (srtpu's
    BatchNorm, momentum 0.9). Eval mode normalises with the running
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
        u, stats = xd, []
        for prm in self._blocks():
            u, st = bn_resblock(u, *prm, plain=plain, reflect=rf)
            stats.append(st)
        out, (mc, vc) = bn_close(u, xd, *close, plain=plain, reflect=rf)
        with torch.no_grad():
            mom = self.MOMENTUM
            for name, batch in zip(('mean1', 'var1', 'mean2', 'var2'),
                                   (torch.stack(s) for s in zip(*stats))):
                ra = getattr(self, name)
                ra.copy_(mom * ra + (1 - mom) * batch)
            for ra, batch in ((self.mean_close, mc), (self.var_close, vc)):
                ra.copy_(mom * ra + (1 - mom) * batch)
        return out


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
    ``pm_to_nhwc`` then gives the fine image. Weights are stored as the
    plain tail's: up{i}_weight HWIO (3, 3, C, r*r*C) and up{i}_bias in
    PixelShuffle order, final_weight (k, k, C, ch)."""

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


class UpscaleBlock(nn.Module):
    """Sub-pixel upscaler (srtpu ``UpscaleBlock``): log2(scale) stages
    (one at x3) of a 3x3 conv C -> r*r*C, r = 3 at x3 and 2 otherwise,
    then ``pixel_shuffle``; with ``act='prelu'`` (SRGAN's) a PReLU after
    each stage's shuffle, one slope per stage (``acts``). srtpu runs it
    in XLA, outside any Pallas kernel, so each conv is the port's
    ``Conv2d`` (cuDNN on the card); ``plain`` changes nothing here."""

    def __init__(self, scale_factor: int = 4, n_feats: int = 64,
                 act: str | None = None, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        if scale_factor not in (2, 3, 4, 8):
            raise ValueError(f'scale_factor must be 2, 3, 4 or 8, got '
                             f'{scale_factor}')
        if act not in (None, 'prelu'):
            raise ValueError(f"act must be None or 'prelu', got {act!r}")
        self.r = 3 if scale_factor == 3 else 2
        stages = int(math.log2(scale_factor))
        self.convs = nn.ModuleList(
            Conv2d(n_feats, n_feats * self.r * self.r, 3, device=device,
                   generator=generator) for _ in range(stages))
        self.acts = nn.ModuleList(
            PReLU(device=device) for _ in range(stages if act else 0))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        for i, conv in enumerate(self.convs):
            x = pixel_shuffle(conv(x, dtype), self.r)
            if self.acts:
                x = self.acts[i](x)
        return x
