"""K1: the EDSR resblock trunk, forward and backward, one host call per
trunk each way.

Replaces ``srtpu/ops/cs_conv.py:trunk_fwd_mega`` and ``trunk_bwd_mega``
(behind ``trunk_cs_mega``), and with them srtpu's per-block forms of the
same block: ``_rb_fwd_call_stk`` / ``_rb_bwd_call_stk`` (behind
``trunk_cs``, which srtpu's ``CSTrunk`` takes once the mega backward's
dW accumulators pass its TPU VMEM budget) and ``resblock_cs_fwd_h1`` /
``resblock_cs_bwd`` (behind ``resblock_cs``, one block on HWIO weights).
Those compute what K1 computes, block by block; K1 keeps no such
accumulators, so one route serves every depth, and :func:`resblock_cs`
is :func:`trunk` at L = 1. srtpu's ``s_valid`` (the dead lanes of a
padded CS packing) has no counterpart: NHWC has no dead lanes.

The kernels are ``csrc/trunk.cu``, whose head note says what bounds them
on the H100 and how they run: each conv one launch of K2's wgmma engine
(``csrc/conv_sm90.cuh``: conv1 K2's own instance, conv2 at K1's
epilogue, the dx chain's transposed convs at K5's), the blocks in order
on one stream. :func:`trunk_fwd` and :func:`trunk_bwd` run a trunk in one
host call each way (checks and scratch once per trunk; the backward's
weight grads then come from the weight-grad kernel, :mod:`.wgrad`, one
launch per conv for all blocks) for CUDA tensors, and take the plain
versions only for CPU tensors (:func:`trunk_chain` is the backward's
dx chain alone, on CUDA). :func:`fwd_plan` and :func:`chain_plan`
say in plain Python what trunk.cu launches. :func:`trunk` is the
differentiable op (:class:`TrunkFn`). :func:`trunk_xla` is srtpu's XLA
trunk past 96 features, in stock ops (no kernel).
"""

from __future__ import annotations

import torch

from . import _build
from .conv import conv3x3_plain, conv_f32
from .layout import w_t
from .resblock import resblock_fused_plain
from .wgrad import conv_wgrad, conv_wgrad_plain

KERNEL_C = C = 64       # the kernels' one width (EDSR-baseline's)
EPI_K2, EPI_K5, EPI_K1 = 0, 5, 6   # the engine's epilogues K1 launches


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


def fwd_plan(save: bool, scale: float, n_blocks: int = 1) -> tuple:
    """trunk.cu's launches for a forward call of ``n_blocks`` blocks, in
    order, each (kernel, EPI, k, cin, cout, transposed, scale, what it
    writes): 'engine' is K2's engine over the images' 8 x 16 tiles (EPI
    0, K2's own instance: conv1 with bias and ReLU; EPI 6, K1's: conv2,
    its bias, the scale and the skip), 'copy' a device copy. ``scale`` is
    the res_scale a launch applies (None: none)."""
    block = (('engine', EPI_K2, 3, C, C, False, None, ('h1',)),
             ('engine', EPI_K1, 3, C, C, False, float(scale), ('out',)))
    head = (('copy', None, None, None, None, None, None, ('xs',)),)
    return (head if save else ()) + block * n_blocks


def chain_plan(scale: float, n_blocks: int = 1) -> tuple:
    """trunk.cu's launches for a dx chain of ``n_blocks`` blocks (the last
    block first), as :func:`fwd_plan`: g copied into the weight grads'
    stack, then per block, where res_scale is not 1, a 'gs' pass making
    gs = bf16(res_scale * g), and the two transposed launches of the
    engine at K5's dx epilogue (EPI 5: h1's mask, then the skip g)."""
    gs = (('gs', None, None, None, None, None, float(scale), ('gs',)),)
    block = (('engine', EPI_K5, 3, C, C, True, None, ('dh1',)),
             ('engine', EPI_K5, 3, C, C, True, None, ('dx',)))
    if float(scale) != 1.0:
        block = gs + block
    return (('copy', None, None, None, None, None, None, ('g',)),
            ) + block * n_blocks


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
    one host call (two launches a block; ``trunk_fwd.launches`` counts
    the blocks). The registered operator ``srtpu::trunk_fwd``
    (:mod:`._library`)."""
    op = (torch.ops.srtpu.trunk_fwd.default
          if x.device.type in _build.OP_DEVICES else trunk_fwd_cuda)
    got = op(x, w1s, b1s, w2s, b2s, float(res_scale), save)
    return tuple(got) if save else got[0]


def trunk_fwd_cuda(x, w1s, b1s, w2s, b2s, res_scale: float, save: bool
                   ) -> list:
    """``srtpu::trunk_fwd`` on CUDA: the checks, the outputs and scratch,
    one ``srt_trunk_fwd`` call, the count."""
    _check('trunk_fwd', x)
    bsz, h, wd, c = x.shape
    n_blocks = w1s.shape[0]
    dev = x.device
    _build.expect(x, 'x', torch.bfloat16, (bsz, h, wd, c), dev)
    for name, t in (('w1s', w1s), ('w2s', w2s)):
        _build.expect(t, name, torch.bfloat16, (n_blocks, 3, 3, c, c), dev)
    for name, t in (('b1s', b1s), ('b2s', b2s)):
        _build.expect(t, name, torch.float32, (n_blocks, c), dev)
    out = torch.empty_like(x)
    if save:    # every block's input and h1 stay for the backward
        xs = torch.empty((n_blocks, *x.shape), dtype=x.dtype, device=dev)
        h1s = torch.empty_like(xs)
    else:       # the other of two outputs a block alternates on; h1 scratch
        xs = torch.empty_like(x) if n_blocks > 1 else None
        h1s = torch.empty_like(x)
    lib = _build.library()
    with _build.on(dev):
        err = lib.srt_trunk_fwd(
            x.data_ptr(), w1s.data_ptr(), b1s.data_ptr(), w2s.data_ptr(),
            b2s.data_ptr(), float(res_scale),
            None if xs is None else xs.data_ptr(), h1s.data_ptr(),
            out.data_ptr(), n_blocks, int(save), bsz, h, wd, c,
            _build.stream(dev))
    _build.check(err, 'srt_trunk_fwd')
    trunk_fwd.launches += n_blocks
    return [out, xs, h1s] if save else [out]


def trunk_chain(h1s: torch.Tensor, g: torch.Tensor, w1s: torch.Tensor,
                w2s: torch.Tensor, res_scale: float) -> tuple:
    """K1's dx chain on CUDA, without the weight grads: h1s (L, B, H, W,
    64) bf16 saved by the forward; g (B, H, W, 64) bf16; w1s, w2s (L, 3,
    3, 64, 64) bf16 -> (dx, gbuf, dh1s): the trunk's input cotangent,
    every block's output cotangent (L, ...) and dh1 (L, ...), as the
    weight grads read them. One host call (two launches a block;
    ``trunk_bwd.launches`` counts the blocks)."""
    _check('trunk_chain', g)
    n_blocks = h1s.shape[0]
    bsz, h, wd, c = g.shape
    dev = g.device
    _build.expect(h1s, 'h1s', torch.bfloat16, (n_blocks, bsz, h, wd, c), dev)
    _build.expect(g, 'g', torch.bfloat16, (bsz, h, wd, c), dev)
    for name, t in (('w1s', w1s), ('w2s', w2s)):
        _build.expect(t, name, torch.bfloat16, (n_blocks, 3, 3, c, c), dev)
    gbuf = torch.empty_like(h1s)    # gbuf[l]: cotangent of block l's output
    dh1s = torch.empty_like(h1s)
    dx = torch.empty_like(g)
    gs = torch.empty_like(g) if float(res_scale) != 1.0 else None
    lib = _build.library()
    with _build.on(dev):
        err = lib.srt_trunk_chain(
            h1s.data_ptr(), g.data_ptr(), w1s.data_ptr(), w2s.data_ptr(),
            float(res_scale), gbuf.data_ptr(), dh1s.data_ptr(),
            None if gs is None else gs.data_ptr(), dx.data_ptr(), n_blocks,
            bsz, h, wd, c, _build.stream(dev))
    _build.check(err, 'srt_trunk_chain')
    trunk_bwd.launches += n_blocks
    return dx, gbuf, dh1s


def trunk_bwd(xs: torch.Tensor, h1s: torch.Tensor, g: torch.Tensor,
              w1s: torch.Tensor, w2s: torch.Tensor, res_scale: float):
    """xs, h1s (L, B, H, W, C) bf16 from ``trunk_fwd(save=True)``; g
    (B, H, W, C) bf16; w1s, w2s (L, 3, 3, C, C) bf16 -> as
    :func:`trunk_bwd_plain`. On CUDA: C = 64; :func:`trunk_chain`, then
    one weight-grad launch per conv."""
    if g.device.type == 'cpu':
        return trunk_bwd_plain(xs, h1s, g, w1s, w2s, res_scale)
    _check('trunk_bwd', g)
    _build.expect(xs, 'xs', torch.bfloat16, h1s.shape, g.device)
    dx, gbuf, dh1s = trunk_chain(h1s, g, w1s, w2s, res_scale)
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
