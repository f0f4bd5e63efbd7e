"""K3: one sub-pixel upscale stage, 3x3 conv C -> r*r*C + bias with the
pixel shuffle folded into the store, and its backward.

Replaces ``srtpu/ops/cs_conv.py:upsample_cs_fwd`` and
``upsample_cs_bwd`` (``_ups_deint_kernel`` + ``_ups_conv_bwd_kernel``).
The kernels are ``csrc/upsample.cu`` (the forward, and the backward's dx
with the de-interleave folded into its load) and the weight-grad kernel
(:mod:`.wgrad`, gathering the same way); the head notes say what bounds
them on the H100. :func:`upsample_fwd` and :func:`upsample_bwd` launch
the kernels for CUDA tensors and take the plain versions only for CPU
tensors. :func:`upsample` is the differentiable op (:class:`UpsampleFn`).
"""

from __future__ import annotations

import torch

from . import _build
from .conv import conv3x3_plain, conv_f32
from .layout import (b_pm, b_ps_from_pm, pixel_shuffle, pm_from_fine, w_pm_hwio,
                     w_ps_from_pm, w_t)
from .wgrad import conv_wgrad, conv_wgrad_plain


def upsample_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   r: int) -> torch.Tensor:
    """Plain version: bf16(conv + bias) in PixelShuffle channel order,
    then the shuffle (exact: a permutation)."""
    return pixel_shuffle(conv3x3_plain(x, w, b), r).contiguous()


def upsample_bwd_plain(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                       r: int) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain backward, rounding where the Pallas kernels do: the fine
    cotangent g read phase-major (exact); dx = ONE rounding of the f32
    sum over all r*r phases of their transposed convs; dW and db per
    phase in f32, returned in PixelShuffle order like w and b."""
    w_pm = w_pm_hwio(w, r)
    dx = conv_f32(pm_from_fine(g, r), w_t(w_pm)).to(x.dtype).contiguous()
    dw_pm, db_pm = conv_wgrad_plain(x, g, r=r)
    return dx, w_ps_from_pm(dw_pm, r), b_ps_from_pm(db_pm, r)


def _check(name: str, x: torch.Tensor, r: int, for_bwd: bool) -> None:
    if x.device.type != 'cuda':
        raise ValueError(f'{name}: no kernel for device {x.device}')
    c = x.shape[-1]
    if c != 64 or r < 2 or (for_bwd and r != 2):
        raise ValueError(f'{name}: no kernel for C={c}, r={r}')


def upsample_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 r: int) -> torch.Tensor:
    """x (B, H, W, C) bf16; w HWIO (3, 3, C, r*r*C) bf16 and b (r*r*C,) f32,
    both in PixelShuffle channel order -> (B, r*H, r*W, C) bf16. On CUDA:
    C = 64."""
    if x.device.type == 'cpu':
        return upsample_plain(x, w, b, r)
    _check('upsample_fwd', x, r, False)
    bsz, h, wd, c = x.shape
    dev = x.device
    _build.expect(x, 'x', torch.bfloat16, (bsz, h, wd, c), dev)
    _build.expect(w, 'w', torch.bfloat16, (3, 3, c, r * r * c), dev)
    _build.expect(b, 'b', torch.float32, (r * r * c,), dev)
    w_pm = w_pm_hwio(w, r).contiguous()
    bias = b_pm(b, r).contiguous()
    out = torch.empty((bsz, r * h, r * wd, c), dtype=torch.bfloat16,
                      device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.srt_upsample_fwd(x.data_ptr(), w_pm.data_ptr(),
                                   bias.data_ptr(), out.data_ptr(), bsz, h,
                                   wd, c, r, _build.stream(dev))
    _build.check(err, 'srt_upsample_fwd')
    upsample_fwd.launches += 1
    return out


def upsample_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, r: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, H, W, C) bf16; w (3, 3, C, r*r*C) bf16 in PixelShuffle order;
    g (B, r*H, r*W, C) bf16 -> dx bf16, dW and db f32 in PixelShuffle
    order. On CUDA: C = 64, r = 2."""
    if x.device.type == 'cpu':
        return upsample_bwd_plain(x, w, g, r)
    _check('upsample_bwd', x, r, True)
    bsz, h, wd, c = x.shape
    dev = x.device
    _build.expect(x, 'x', torch.bfloat16, (bsz, h, wd, c), dev)
    _build.expect(w, 'w', torch.bfloat16, (3, 3, c, r * r * c), dev)
    _build.expect(g, 'g', torch.bfloat16, (bsz, r * h, r * wd, c), dev)
    wt = w_t(w_pm_hwio(w, r)).contiguous()
    dx = torch.empty_like(x)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.srt_upsample_bwd_dx(g.data_ptr(), wt.data_ptr(),
                                      dx.data_ptr(), bsz, h, wd, c, r,
                                      _build.stream(dev))
    _build.check(err, 'srt_upsample_bwd_dx')
    upsample_bwd.launches += 1
    dw_pm, db_pm = conv_wgrad(x, g, r=r)
    return dx, w_ps_from_pm(dw_pm, r), b_ps_from_pm(db_pm, r)


upsample_fwd.launches = 0
upsample_bwd.launches = 0


class UpsampleFn(torch.autograd.Function):
    """Differentiable K3 (srtpu ``upsample_cs``): f32 weight and bias in,
    the weight cast to x's dtype inside, (x, weight) saved, f32 dW and db
    out."""

    @staticmethod
    def forward(ctx, x, w, b, r: int, plain: bool):
        wd = w.to(x.dtype).contiguous()
        y = (upsample_plain if plain else upsample_fwd)(
            x, wd, b.float().contiguous(), r)
        ctx.save_for_backward(x, wd)
        ctx.r, ctx.plain, ctx.dtypes = r, plain, (w.dtype, b.dtype)
        return y

    @staticmethod
    def backward(ctx, g):
        x, wd = ctx.saved_tensors
        dx, dw, db = (upsample_bwd_plain if ctx.plain else upsample_bwd)(
            x, wd, g.contiguous(), ctx.r)
        return dx, dw.to(ctx.dtypes[0]), db.to(ctx.dtypes[1]), None, None


def upsample(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, r: int,
             plain: bool = False) -> torch.Tensor:
    """One upscale stage in x's dtype from f32 (or any) parameters in
    PixelShuffle order: the autograd op when a gradient is wanted, else
    the forward alone."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or b.requires_grad):
        return UpsampleFn.apply(x, w, b, r, plain)
    return (upsample_plain if plain else upsample_fwd)(
        x, w.to(x.dtype).contiguous(), b.float().contiguous(), r)
