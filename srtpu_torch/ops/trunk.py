"""K1: the EDSR resblock chain, one fused-block kernel per block, and its
backward.

Replaces ``srtpu/ops/cs_conv.py:trunk_fwd_mega`` and ``trunk_bwd_mega``
(behind ``trunk_cs_mega``), and with them srtpu's per-block forms of the
same block: ``_rb_fwd_call_stk`` / ``_rb_bwd_call_stk`` (behind
``trunk_cs``, which srtpu's ``CSTrunk`` takes once the mega backward's
dW accumulators pass its TPU VMEM budget) and ``resblock_cs_fwd_h1`` /
``resblock_cs_bwd`` (behind ``resblock_cs``, one block on HWIO weights).
Those compute what K1 computes, block by block; K1 already launches one
kernel per block and keeps no such accumulators, so one route serves
every depth, and :func:`resblock_cs` is :func:`trunk` at L = 1. srtpu's
``s_valid`` (the dead lanes of a padded CS packing) has no counterpart:
NHWC has no dead lanes.

The kernels are ``csrc/trunk.cu``, whose head notes say what bounds them
on the H100, how their design answers that, and why the loop over blocks
runs here on the host. The backward's weight grads come from the
weight-grad kernel (:mod:`.wgrad`), one launch per conv for all blocks.
:func:`trunk_fwd` and :func:`trunk_bwd` launch the kernels for CUDA
tensors and take the plain versions only for CPU tensors. :func:`trunk`
is the differentiable op (:class:`TrunkFn`). :func:`trunk_xla` is
srtpu's XLA trunk past 96 features, in stock ops (no kernel).
"""

from __future__ import annotations

import torch

from . import _build
from .conv import conv3x3_plain, conv_f32
from .layout import w_t
from .resblock import resblock_fused_plain
from .wgrad import conv_wgrad, conv_wgrad_plain

KERNEL_C = 64           # the kernels' one width (EDSR-baseline's)


def trunk_plain(x: torch.Tensor, w1s: torch.Tensor, b1s: torch.Tensor,
                w2s: torch.Tensor, b2s: torch.Tensor, res_scale: float,
                save: bool = False):
    """Plain version, rounding where the kernel does: h1 to x.dtype after
    bias + ReLU, the block output to x.dtype after ``h2 * res_scale + x``
    in f32. ``save`` returns ``(out, xs, h1s)``: every block's input and
    h1, stacked (L, B, H, W, C), as the backward needs."""
    xs, h1s = [], []
    for w1, b1, w2, b2 in zip(w1s, b1s, w2s, b2s):
        h1 = conv3x3_plain(x, w1, b1, relu=True)
        xs.append(x)
        h1s.append(h1)
        x = (conv_f32(h1, w2, b2) * res_scale + x.float()).to(x.dtype)
    x = x.contiguous()
    return (x, torch.stack(xs), torch.stack(h1s)) if save else x


def trunk_bwd_plain(xs: torch.Tensor, h1s: torch.Tensor, g: torch.Tensor,
                    w1s: torch.Tensor, w2s: torch.Tensor, res_scale: float):
    """Plain backward, rounding where ``_trunk_bwd_kernel_mega`` does, per
    block in reverse:
      gs = bf16(g * res_scale); dh1 = bf16(h1 > 0 ? convT(gs, W2) : 0);
      dx = bf16(convT(dh1, W1) + g);
      dW2 = corr(h1, gs), db2 = sum(gs); dW1 = corr(x, dh1), db1 = sum(dh1)
    (bf16 meaning x's dtype; sums in f32). Returns dx and the stacked
    f32 (dW1, db1, dW2, db2)."""
    dt = xs.dtype
    g_all, dh1_all = [], []
    for l in reversed(range(xs.shape[0])):
        gs = (g.float() * res_scale).to(dt)
        dh1 = torch.where(h1s[l].float() > 0, conv_f32(gs, w_t(w2s[l])),
                          0.0).to(dt)
        g_all.append(g)
        g = (conv_f32(dh1, w_t(w1s[l])) + g.float()).to(dt)
        dh1_all.append(dh1)
    # gs again as the kernel path reads it: bf16(res_scale * g)
    dw2, db2 = conv_wgrad_plain(h1s, torch.stack(g_all[::-1]),
                                gscale=res_scale)
    dw1, db1 = conv_wgrad_plain(xs, torch.stack(dh1_all[::-1]))
    return g.contiguous(), dw1, db1, dw2, db2


def _check(name: str, x: torch.Tensor) -> None:
    if x.device.type != 'cuda':
        raise ValueError(f'{name}: no kernel for device {x.device}')
    if x.shape[-1] != KERNEL_C:
        raise ValueError(f'{name}: no kernel for C={x.shape[-1]} (K1 takes '
                         f'{KERNEL_C} channels; ROADMAP.md F4)')


def trunk_fwd(x: torch.Tensor, w1s: torch.Tensor, b1s: torch.Tensor,
              w2s: torch.Tensor, b2s: torch.Tensor, res_scale: float,
              save: bool = False):
    """x (B, H, W, C) bf16; w1s, w2s (L, 3, 3, C, C) bf16 HWIO stacks;
    b1s, b2s (L, C) f32 -> (B, H, W, C) bf16 after L resblocks, or with
    ``save`` ``(out, xs, h1s)`` as :func:`trunk_plain`. On CUDA: C = 64;
    one launch per block."""
    if x.device.type == 'cpu':
        return trunk_plain(x, w1s, b1s, w2s, b2s, res_scale, save)
    _check('trunk_fwd', x)
    bsz, h, wd, c = x.shape
    n_blocks = w1s.shape[0]
    dev = x.device
    _build.expect(x, 'x', torch.bfloat16, (bsz, h, wd, c), dev)
    for name, t in (('w1s', w1s), ('w2s', w2s)):
        _build.expect(t, name, torch.bfloat16, (n_blocks, 3, 3, c, c), dev)
    for name, t in (('b1s', b1s), ('b2s', b2s)):
        _build.expect(t, name, torch.float32, (n_blocks, c), dev)
    if save:    # every block's input and h1 stay for the backward
        xs = torch.empty((n_blocks, *x.shape), dtype=x.dtype, device=dev)
        xs[0].copy_(x)
        h1s = torch.empty_like(xs)
        out = torch.empty_like(x)
        dsts = [*xs[1:], out]
    else:       # ping-pong: a block never reads its output
        bufs = [torch.empty_like(x) for _ in range(min(n_blocks, 2))]
        dsts = [bufs[i % 2] for i in range(n_blocks)]
    lib = _build.library()
    src = x
    with torch.cuda.device(dev):
        s = _build.stream(dev)
        for i, dst in enumerate(dsts):
            err = lib.srt_resblock_fwd(
                src.data_ptr(), w1s[i].data_ptr(), b1s[i].data_ptr(),
                w2s[i].data_ptr(), b2s[i].data_ptr(), float(res_scale),
                dst.data_ptr(), h1s[i].data_ptr() if save else None, bsz, h,
                wd, c, s)
            _build.check(err, 'srt_resblock_fwd')
            trunk_fwd.launches += 1
            src = dst
    return (src, xs, h1s) if save else src


def trunk_bwd(xs: torch.Tensor, h1s: torch.Tensor, g: torch.Tensor,
              w1s: torch.Tensor, w2s: torch.Tensor, res_scale: float):
    """xs, h1s (L, B, H, W, C) bf16 from ``trunk_fwd(save=True)``; g
    (B, H, W, C) bf16; w1s, w2s (L, 3, 3, C, C) bf16 -> as
    :func:`trunk_bwd_plain`. On CUDA: C = 64; one dx-chain launch per
    block, in reverse, then one weight-grad launch per conv."""
    if g.device.type == 'cpu':
        return trunk_bwd_plain(xs, h1s, g, w1s, w2s, res_scale)
    _check('trunk_bwd', g)
    n_blocks = xs.shape[0]
    bsz, h, wd, c = g.shape
    dev = g.device
    for name, t in (('xs', xs), ('h1s', h1s)):
        _build.expect(t, name, torch.bfloat16, (n_blocks, bsz, h, wd, c), dev)
    _build.expect(g, 'g', torch.bfloat16, (bsz, h, wd, c), dev)
    for name, t in (('w1s', w1s), ('w2s', w2s)):
        _build.expect(t, name, torch.bfloat16, (n_blocks, 3, 3, c, c), dev)
    w1t = w_t(w1s).contiguous()
    w2t = w_t(w2s).contiguous()
    gbuf = torch.empty_like(xs)     # gbuf[l]: cotangent of block l's output
    gbuf[-1].copy_(g)
    dh1s = torch.empty_like(xs)
    dx = torch.empty_like(g)
    lib = _build.library()
    with torch.cuda.device(dev):
        s = _build.stream(dev)
        for i in reversed(range(n_blocks)):
            dst = gbuf[i - 1] if i else dx
            err = lib.srt_resblock_bwd(
                gbuf[i].data_ptr(), h1s[i].data_ptr(), w2t[i].data_ptr(),
                w1t[i].data_ptr(), float(res_scale), dst.data_ptr(),
                dh1s[i].data_ptr(), bsz, h, wd, c, s)
            _build.check(err, 'srt_resblock_bwd')
            trunk_bwd.launches += 1
    dw2, db2 = conv_wgrad(h1s, gbuf, gscale=res_scale)
    dw1, db1 = conv_wgrad(xs, dh1s)
    return dx, dw1, db1, dw2, db2


trunk_fwd.launches = 0
trunk_bwd.launches = 0


class TrunkFn(torch.autograd.Function):
    """Differentiable K1 (srtpu ``trunk_cs_mega``): f32 block weights and
    biases in, the weights cast to x's dtype inside; saves every block's
    input and h1 (``cs_conv.py:_trunk_mega_vjp_fwd``) and returns f32
    weight grads."""

    @staticmethod
    def forward(ctx, x, w1s, b1s, w2s, b2s, res_scale: float, plain: bool):
        dt = x.dtype
        w1d, w2d = w1s.to(dt).contiguous(), w2s.to(dt).contiguous()
        out, xs, h1s = (trunk_plain if plain else trunk_fwd)(
            x, w1d, b1s.float().contiguous(), w2d, b2s.float().contiguous(),
            res_scale, save=True)
        ctx.save_for_backward(xs, h1s, w1d, w2d)
        ctx.res_scale, ctx.plain = res_scale, plain
        ctx.dtypes = (w1s.dtype, b1s.dtype, w2s.dtype, b2s.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        xs, h1s, w1d, w2d = ctx.saved_tensors
        grads = (trunk_bwd_plain if ctx.plain else trunk_bwd)(
            xs, h1s, g.contiguous(), w1d, w2d, ctx.res_scale)
        dx, *dparams = grads
        return (dx, *(d.to(t) for d, t in zip(dparams, ctx.dtypes)), None,
                None)


def trunk(x: torch.Tensor, w1s: torch.Tensor, b1s: torch.Tensor,
          w2s: torch.Tensor, b2s: torch.Tensor, res_scale: float,
          plain: bool = False) -> torch.Tensor:
    """L resblocks in x's dtype from f32 (or any) parameters: the autograd
    op when a gradient is wanted, else the forward alone (no saved
    activations)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1s, b1s, w2s, b2s)):
        return TrunkFn.apply(x, w1s, b1s, w2s, b2s, res_scale, plain)
    dt = x.dtype
    return (trunk_plain if plain else trunk_fwd)(
        x, w1s.to(dt).contiguous(), b1s.float().contiguous(),
        w2s.to(dt).contiguous(), b2s.float().contiguous(), res_scale)


def resblock_cs(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                w2: torch.Tensor, b2: torch.Tensor, res_scale: float = 1.0,
                plain: bool = False) -> torch.Tensor:
    """One EDSR resblock on HWIO weights (srtpu ``resblock_cs``): w1, w2
    (3, 3, C, C), b1, b2 (C,). :func:`trunk` at L = 1, so its launches
    count on K1's wrappers; the grads come back in the parameters'
    dtypes, as srtpu's ``_rb_cs_vjp_bwd`` returns the weight grads in the
    weights'."""
    return trunk(x.contiguous(), w1[None], b1[None], w2[None], b2[None],
                 res_scale, plain)


def trunk_xla(x, w1s, b1s, w2s, b2s, res_scale: float, close_w, close_b):
    """srtpu ``CSTrunk``'s XLA fallback, which it takes past 96 features
    (srtpu/models/common.py:387-416), in stock differentiable ops on x's
    dtype: per block ``resblock_reference`` (the weights rounded to x's
    dtype, f32 convs, h1 kept in f32, out rounded once), then
    ``conv3x3_reference`` (f32 conv + f32 bias, one rounding) and the
    skip in x's dtype. No kernel of the port runs here."""
    dt = x.dtype
    res = x
    for w1, b1, w2, b2 in zip(*(t.unbind(0) for t in (w1s, b1s, w2s,
                                                       b2s))):
        res = resblock_fused_plain(res, w1.to(dt), b1.float(), w2.to(dt),
                                   b2.float(), res_scale)
    return conv3x3_plain(res, close_w.to(dt), close_b.float()) + x
