"""K3: one sub-pixel upscale stage, 3x3 conv C -> r*r*C + bias with the
pixel shuffle folded into the store, and its backward.

Replaces ``srtpu/ops/cs_conv.py:upsample_cs_fwd`` and
``upsample_cs_bwd`` (``_ups_deint_kernel`` + ``_ups_conv_bwd_kernel``).
The kernels are ``csrc/upsample.cu`` (K2's wgmma engine at K3's own
epilogues: the forward with the pixel shuffle in its store, and the
backward's dx reading the fine cotangent phase-major through a 5-D
tensor map, the forward's phase-major weight as it lies) and the
weight-grad kernel (:mod:`.wgrad`, gathering the same way); the head
notes say what bounds them on the H100. :func:`upsample_fwd` and
:func:`upsample_bwd` launch the kernels for CUDA tensors and take the
plain versions only for CPU tensors (:func:`upsample_dx` is the dx
alone). :func:`fwd_plan` and :func:`bwd_plan` say in plain Python what
they launch. :func:`upsample` is the differentiable op
(:class:`UpsampleFn`).
"""

from __future__ import annotations

import torch

from . import _build
from .conv import conv3x3_plain, conv_f32
from .layout import (b_pm, b_ps_from_pm, pixel_shuffle, pm_from_fine, w_pm_hwio,
                     w_ps_from_pm, w_t)
from .wgrad import conv_wgrad, conv_wgrad_plain

EPI_SHUFFLE, EPI_FINE = 13, 14   # the engine's epilogues K3 launches
SMS = 132               # the H100's SMs, which K2's split rule counts
TH, TW = 8, 16          # K2's engine's pixel tile


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


def phases(r: int) -> int:
    """Phases a forward block writes: 3, 2 or 1, the widest that divides
    r (``k3_phases`` in ``csrc/conv_sm90.cuh``)."""
    return 3 if r % 3 == 0 else 2 if r % 2 == 0 else 1


def fwd_plan(r: int, c: int = 64) -> tuple:
    """upsample.cu's launch for a forward, as (kernel, EPI, k, cin, cout,
    transposed, N a block, split, what it writes): K2's engine at EPI 13,
    c -> r*r*c on the phase-major weight, N = 64 d (:func:`phases`), no
    split."""
    return (('engine', EPI_SHUFFLE, 3, c, r * r * c, False, 64 * phases(r),
             1, ('out',)),)


def bwd_plan(r: int, bsz: int, h: int, w: int, c: int = 64) -> tuple:
    """upsample.cu's and wgrad.cu's launches for a backward at a (bsz, h,
    w) LR, as :func:`fwd_plan`: the dx on K2's transposed engine at EPI
    14, r*r*c -> c over the fine cotangent's 5-D map, N = 64, split over a
    2-block cluster where K2's ``split_cin`` splits (fewer blocks than
    twice the SMs); then W's dW and db (the r = 2 gather)."""
    cin = r * r * c
    blocks = -(-w // TW) * -(-h // TH) * bsz
    split = 2 if cin % 64 == 0 and cin >= 256 and blocks < 2 * SMS else 1
    return (('engine', EPI_FINE, 3, cin, c, True, 64, split, ('dx',)),
            ('wgrad', None, 3, c, cin, False, None, None, ('dw', 'db')))


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
    C = 64. The registered operator ``srtpu::upsample_fwd``
    (:mod:`._library`)."""
    if x.device.type not in _build.OP_DEVICES:
        return upsample_fwd_cuda(x, w, b, r)
    return torch.ops.srtpu.upsample_fwd.default(x, w, b, r)


def upsample_fwd_cuda(x, w, b, r: int) -> torch.Tensor:
    """``srtpu::upsample_fwd`` on CUDA: the checks, the phase-major weight
    and bias, one ``srt_upsample_fwd`` call, the count."""
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
    with _build.on(dev):
        err = lib.srt_upsample_fwd(x.data_ptr(), w_pm.data_ptr(),
                                   bias.data_ptr(), out.data_ptr(), bsz, h,
                                   wd, c, r, _build.stream(dev))
    _build.check(err, 'srt_upsample_fwd')
    upsample_fwd.launches += 1
    return out


def upsample_dx(g: torch.Tensor, w_pm: torch.Tensor, r: int
                ) -> torch.Tensor:
    """K3's dx alone, on CUDA: g (B, r*H, r*W, C) bf16, w_pm (3, 3, C,
    r*r*C) bf16 the phase-major weight (``w_pm_hwio``) as the forward
    reads it -> dx (B, H, W, C) bf16, one launch (:func:`upsample_bwd`
    counts the backward)."""
    _check('upsample_dx', g, r, True)
    bsz, fh, fw, c = g.shape
    h, wd, dev = fh // r, fw // r, g.device
    _build.expect(g, 'g', torch.bfloat16, (bsz, r * h, r * wd, c), dev)
    _build.expect(w_pm, 'w_pm', torch.bfloat16, (3, 3, c, r * r * c), dev)
    dx = torch.empty((bsz, h, wd, c), dtype=torch.bfloat16, device=dev)
    with _build.on(dev):
        err = _build.library().srt_upsample_bwd_dx(
            g.data_ptr(), w_pm.data_ptr(), dx.data_ptr(), bsz, h, wd, c, r,
            _build.stream(dev))
    _build.check(err, 'srt_upsample_bwd_dx')
    return dx


def upsample_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, r: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, H, W, C) bf16; w (3, 3, C, r*r*C) bf16 in PixelShuffle order;
    g (B, r*H, r*W, C) bf16 -> dx bf16, dW and db f32 in PixelShuffle
    order. On CUDA: C = 64, r = 2; the dx (:func:`upsample_dx`) reads the
    phase-major weight as it lies (no transposed copy)."""
    if x.device.type == 'cpu':
        return upsample_bwd_plain(x, w, g, r)
    _check('upsample_bwd', x, r, True)
    bsz, h, wd, c = x.shape
    dev = x.device
    _build.expect(x, 'x', torch.bfloat16, (bsz, h, wd, c), dev)
    _build.expect(w, 'w', torch.bfloat16, (3, 3, c, r * r * c), dev)
    _build.expect(g, 'g', torch.bfloat16, (bsz, r * h, r * wd, c), dev)
    dx = upsample_dx(g, w_pm_hwio(w, r).contiguous(), r)
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
