"""K8a: srtpu's fused NHWC EDSR resblock (``use_pallas=True``), its
forward on the card, its backward in stock PyTorch.

Replaces ``srtpu/ops/resblock.py:resblock_fused_h1`` (body
``_resblock_kernel_h1``) behind ``resblock_fused_v2`` / ``FusedResBlock``,
and ``resblock_fused`` (``_resblock_kernel``, the same body without h1).
The kernels are ``csrc/resblock.cu``, whose head note says what bounds
them on the H100 and how they keep the f32 h1 on bf16 tensor cores: per
block two launches of K2's wgmma engine, conv1 storing h1 as a bf16
``[hi | lo]`` pair and conv2 over that pair. :func:`resblock_trunk_fwd`
runs L blocks on stacked weights in one host call for CUDA tensors and
takes the plain version (:func:`resblock_trunk_plain`) only for CPU
tensors; :func:`resblock_fused_fwd` is one block (the same kernels, L =
1). Each counts its blocks in its ``launches``
(``resblock_trunk_fwd.calls`` counts its host calls). :func:`fwd_plan`
says in plain Python what ``resblock.cu`` launches.
:func:`resblock_fused_trunk` is EDSR's True-route trunk op
(:class:`FusedTrunkFn`), :func:`resblock_fused` one block of it
(:class:`FusedResBlockFn`).

One block, NHWC x (B, H, W, C) in the compute dtype, HWIO w1, w2 (3, 3,
C, C) in x's dtype, f32 b1, b2: h1 = relu(conv(x, W1) + b1) in f32, out
= x.dtype((conv(h1, W2) + b2) * res_scale + x) with conv2 reading the
f32 h1; h1 is also emitted rounded to x.dtype, for the backward.

srtpu's backward of ``resblock_fused_v2`` (``_rb2_bwd``) is XLA, so it
is stock PyTorch here (:func:`resblock_fused_bwd`): f32 conv VJPs from
the saved x and x.dtype h1, the ReLU mask from that saved h1, and the
weight grads rounded to the weights' dtype (bf16 on the card), as srtpu
returns them. EDSR's True route runs that structure, block after block
in one autograd node.

K9d: srtpu's ``resblock_fused_v3`` computes the same backward in its
Pallas kernel ``resblock_bwd_fused`` (``_resblock_bwd_kernel``); here
``csrc/resblock_bwd.cu``, whose head note says what bounds it and how it
keeps gs and dh1 in f32 on bf16 tensor cores: its two transposed convs
on K2's engine over [hi | lo] pairs, its weight grads on W's.
:func:`resblock_bwd_fused` launches it for CUDA tensors (counted in
``launches``) and takes the plain version
(:func:`resblock_bwd_fused_plain`, the f32 math of ``_rb2_bwd``) only for
CPU tensors; :func:`bwd_plan` says in plain Python what it launches.
:func:`resblock_fused_v3` is the differentiable op
(:class:`FusedResBlockV3Fn`: K8a forward, K9d backward).
"""

from __future__ import annotations

import torch

from . import _build
from .conv import conv_f32
from .wgrad import wgrad_parts, wgrad_workspace

KERNEL_C = 64           # the kernel's one width (EDSR-baseline's)
EPI_HILO, EPI_SKIP = 12, 15  # the engine's epilogues K8a launches
EPI_DH1, EPI_DX = 16, 17     # and K9d's, transposed over [hi | lo] pairs


def resblock_fused_plain(x, w1, b1, w2, b2, res_scale: float,
                         save_h1: bool = False):
    """Plain version of the kernel: f32 convs from x's values, h1 never
    rounded before conv2, out rounded once to x.dtype; ``save_h1``
    returns ``(out, h1)`` with h1 rounded to x.dtype."""
    h1 = conv_f32(x, w1, b1).clamp_min(0.0)
    out = (conv_f32(h1, w2, b2) * res_scale + x.float()).to(x.dtype) \
        .contiguous()
    return (out, h1.to(x.dtype).contiguous()) if save_h1 else out


def resblock_trunk_plain(x, w1s, b1s, w2s, b2s, res_scale: float,
                         save: bool = False):
    """L blocks of :func:`resblock_fused_plain` on stacked weights (w1s,
    w2s (L, 3, 3, C, C), b1s, b2s (L, C)). ``save`` returns ``(out, xs,
    h1s)``: xs (L - 1, B, H, W, C) the inputs of blocks 1 .. L - 1 (block
    0's is x), h1s (L, B, H, W, C) each block's h1 rounded to x.dtype, as
    the kernel path saves them."""
    if not save:
        for w1, b1, w2, b2 in zip(w1s, b1s, w2s, b2s):
            x = resblock_fused_plain(x, w1, b1, w2, b2, res_scale)
        return x
    xs, h1s = [], []
    for w1, b1, w2, b2 in zip(w1s, b1s, w2s, b2s):
        if h1s:
            xs.append(x)
        x, h1 = resblock_fused_plain(x, w1, b1, w2, b2, res_scale, True)
        h1s.append(h1)
    xs = torch.stack(xs) if xs else x.new_empty((0, *x.shape))
    return x, xs, torch.stack(h1s)


def fwd_plan(save: bool, scale: float, n_blocks: int = 1) -> tuple:
    """resblock.cu's launches for a forward call of ``n_blocks`` blocks, in
    order, each (kernel, EPI, k, cin, cout, transposed, scale, what it
    writes): 'engine' is K2's engine over the images' 8 x 16 tiles at K2's
    plan (N = 64): conv1 at EPI 12 (bias, ReLU, the [hi | lo] pair, and h1
    where the call saves), conv2 over the pair (cin 128, W2 stacked twice)
    at EPI 15 (bias, the scale, the skip: one fused multiply-add, one
    rounding). ``scale`` is the res_scale a launch applies (None: none)."""
    c = KERNEL_C
    block = (('engine', EPI_HILO, 3, c, c, False, None,
              ('vcat', 'h1') if save else ('vcat',)),
             ('engine', EPI_SKIP, 3, 2 * c, c, False, float(scale),
              ('out',)))
    return block * n_blocks


def bwd_plan(scale: float) -> tuple:
    """resblock_bwd.cu's launches for one K9d call, in order, each
    (kernel, EPI, k, cin, cout, transposed, scale, what it writes), as
    :func:`fwd_plan`: 'split' the pass writing gsp, the [hi | lo] pair of
    g * ``scale`` (64 -> 128 channels); 'engine' K2's engine at K2's plan
    (N = 64), transposed, over a pair (cin 128) with the forward's weight
    read for both halves: dh1 at EPI 16 (h1's mask, the split, the pair
    dh1p), dx at EPI 17 (the sums + g, one rounding); 'wgrad' W's job at
    3x3 64 -> 128, one launch each (dW1 on (x, dh1p), dW2 on (h1, gsp)),
    into the 128-column dwx and dbx; 'fold' the hi + lo halves of both."""
    c = KERNEL_C
    return (('split', None, None, c, 2 * c, False, float(scale), ('gsp',)),
            ('engine', EPI_DH1, 3, 2 * c, c, True, None, ('dh1p',)),
            ('engine', EPI_DX, 3, 2 * c, c, True, None, ('dx',)),
            ('wgrad', None, 3, c, 2 * c, False, None, ('dwx', 'dbx')),
            ('wgrad', None, 3, c, 2 * c, False, None, ('dwx', 'dbx')),
            ('fold', None, None, 2 * c, c, False, None,
             ('dw1', 'db1', 'dw2', 'db2')))


def _check(name: str, x) -> None:
    """Raise unless the kernel takes x: 64 channels, on a CUDA tensor."""
    if x.shape[-1] != KERNEL_C:
        raise ValueError(
            f'{name}: no kernel for C={x.shape[-1]} (K8a takes '
            f'{KERNEL_C} channels; ROADMAP.md F4)')
    if x.device.type != 'cuda':
        raise ValueError(f'{name}: no kernel for device {x.device}')


def _launch(name: str, x, w1s, b1s, w2s, b2s, res_scale: float,
            save: bool) -> tuple:
    """One ``srt_resblock_f32_fwd`` call over the len(w1s) blocks: (out,
    xs, h1s) as :func:`resblock_trunk_plain` saves them (xs and h1s None
    unless ``save``)."""
    _check(name, x)
    bsz, h, w, c = x.shape
    n_blocks = w1s.shape[0]
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    _build.expect(x, 'x', bf16, (bsz, h, w, c), dev)
    for nm, t in (('w1', w1s), ('w2', w2s)):
        _build.expect(t, nm, bf16, (n_blocks, 3, 3, c, c), dev)
    for nm, t in (('b1', b1s), ('b2', b2s)):
        _build.expect(t, nm, f32, (n_blocks, c), dev, aligned=False)
    w2cat = torch.cat((w2s, w2s), -2)       # [W2; W2] over [hi | lo]
    vcat = torch.empty((bsz, h, w, 2 * c), dtype=bf16, device=dev)
    out = torch.empty_like(x)
    if save:    # the later blocks' inputs and every h1 stay
        xs = torch.empty((n_blocks - 1, *x.shape), dtype=bf16, device=dev)
        h1s = torch.empty((n_blocks, *x.shape), dtype=bf16, device=dev)
    else:       # the other of two outputs a block alternates on
        xs = torch.empty_like(x) if n_blocks > 1 else None
        h1s = None
    with _build.on(dev):
        err = _build.library().srt_resblock_f32_fwd(
            x.data_ptr(), w1s.data_ptr(), b1s.data_ptr(), w2cat.data_ptr(),
            b2s.data_ptr(), float(res_scale), vcat.data_ptr(),
            _build.ptr(xs) if n_blocks > 1 else None, _build.ptr(h1s),
            out.data_ptr(), n_blocks, int(save), bsz, h, w, c,
            _build.stream(dev))
    _build.check(err, 'srt_resblock_f32_fwd')
    return (out, xs, h1s) if save else (out, None, None)


def resblock_trunk_fwd(x, w1s, b1s, w2s, b2s, res_scale: float,
                       save: bool = False):
    """As :func:`resblock_trunk_plain`. On CUDA: bf16 x (B, H, W, 64), w1s,
    w2s (L, 3, 3, 64, 64) bf16, b1s, b2s (L, 64) f32; one host call, two
    launches a block (``launches`` counts the blocks, ``calls`` the host
    calls). The registered operator ``srtpu::resblock_trunk_fwd``
    (:mod:`._library`)."""
    op = (torch.ops.srtpu.resblock_trunk_fwd.default
          if x.device.type in _build.OP_DEVICES
          else resblock_trunk_fwd_cuda)
    got = op(x, w1s, b1s, w2s, b2s, float(res_scale), save)
    return tuple(got) if save else got[0]


def resblock_trunk_fwd_cuda(x, w1s, b1s, w2s, b2s, res_scale: float,
                            save: bool) -> list:
    """``srtpu::resblock_trunk_fwd`` on CUDA: one ``_launch`` over the
    blocks, counted."""
    out, xs, h1s = _launch('resblock_trunk_fwd', x, w1s, b1s, w2s, b2s,
                           res_scale, save)
    resblock_trunk_fwd.launches += w1s.shape[0]
    resblock_trunk_fwd.calls += 1
    return [out, xs, h1s] if save else [out]


def resblock_fused_fwd(x, w1, b1, w2, b2, res_scale: float,
                       save_h1: bool = False):
    """As :func:`resblock_fused_plain`. On CUDA: bf16 x (B, H, W, 64), w1,
    w2 (3, 3, 64, 64) bf16, b1, b2 (64,) f32; one block (two launches),
    which writes h1 only with ``save_h1``."""
    if x.device.type == 'cpu':
        return resblock_fused_plain(x, w1, b1, w2, b2, res_scale, save_h1)
    out, _, h1s = _launch('resblock_fused_fwd', x, w1[None], b1[None],
                          w2[None], b2[None], res_scale, save_h1)
    resblock_fused_fwd.launches += 1
    return (out, h1s[0]) if save_h1 else out


resblock_trunk_fwd.launches = 0
resblock_trunk_fwd.calls = 0
resblock_fused_fwd.launches = 0


def _conv_vjp(x, w, g):
    """(dx, dW) of the f32 SAME conv of NHWC ``x`` with HWIO ``w`` at the
    NHWC cotangent ``g``: one ``aten.convolution_backward`` in f32."""
    p = w.shape[0] // 2
    dx, dw, _ = torch.ops.aten.convolution_backward(
        g.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2),
        w.permute(3, 2, 0, 1), None, [1, 1], [p, p], [1, 1], False, [0, 0],
        1, [True, True, False])
    return dx.permute(0, 2, 3, 1), dw.permute(2, 3, 1, 0)


def resblock_bwd_fused_plain(x, h1, g, w1, w2, res_scale: float):
    """srtpu's ``_rb2_bwd`` math in stock ops, all in f32 (the math of
    K9d, srtpu's ``_resblock_bwd_kernel``): gs = f32(g) * res_scale;
    dh1, dW2 = the f32 conv VJP at (h1, W2); dh1 masked where the saved
    h1 is not > 0; dx, dW1 = the f32 conv VJP at (x, W1), dx + f32(g).
    Returns dx in x's dtype and the f32 dW1, db1, dW2, db2."""
    gs = g.float() * res_scale
    dh1, dw2 = _conv_vjp(h1.float(), w2.float(), gs)
    dh1 = dh1 * (h1.float() > 0)
    dx, dw1 = _conv_vjp(x.float(), w1.float(), dh1)
    dx = (dx + g.float()).to(x.dtype).contiguous()
    return dx, dw1, dh1.sum((0, 1, 2)), dw2, gs.sum((0, 1, 2))


def resblock_fused_bwd(x, h1, g, w1, w2, res_scale: float):
    """srtpu's ``_rb2_bwd``, the stock backward of EDSR's True route:
    :func:`resblock_bwd_fused_plain` with dW1 and dW2 rounded to the
    weights' dtype."""
    dx, dw1, db1, dw2, db2 = resblock_bwd_fused_plain(x, h1, g, w1, w2,
                                                      res_scale)
    return dx, dw1.to(w1.dtype), db1, dw2.to(w2.dtype), db2


def resblock_bwd_fused(x, h1, g, w1, w2, res_scale: float):
    """K9d: as :func:`resblock_bwd_fused_plain`. On CUDA: bf16 x, h1, g
    (B, H, W, 64) and w1, w2 (3, 3, 64, 64), read as they lie; one call
    runs :func:`bwd_plan`'s launches (each W launch with the in-order
    reductions of its partial slots where its split has more than one
    cluster, :func:`.wgrad.wgrad_parts`)."""
    if g.device.type == 'cpu':
        return resblock_bwd_fused_plain(x, h1, g, w1, w2, res_scale)
    _check('resblock_bwd_fused', g)
    bsz, h, w, c = g.shape
    dev, bf16 = g.device, torch.bfloat16
    for name, t in (('x', x), ('h1', h1), ('g', g)):
        _build.expect(t, name, bf16, (bsz, h, w, c), dev)
    for name, t in (('w1', w1), ('w2', w2)):
        _build.expect(t, name, bf16, (3, 3, c, c), dev)
    # the weight grads' split at the [hi | lo] pairs (64 -> 128)
    cluster, clusters = wgrad_parts(bsz, h, w, c, 2 * c)
    ws_w, ws_b = wgrad_workspace(1, cluster, clusters, c, 2 * c, 3, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    gsp = torch.empty((bsz, h, w, 2 * c), dtype=bf16, device=dev)
    dh1p = torch.empty_like(gsp)
    dwx = torch.empty((2, 9 * c * 2 * c), **f32)
    dbx = torch.empty((2, 2 * c), **f32)
    dx = torch.empty_like(g)
    dw1, dw2 = (torch.empty((3, 3, c, c), **f32) for _ in 'ab')
    db1, db2 = (torch.empty((c,), **f32) for _ in 'ab')
    with _build.on(dev):
        err = _build.library().srt_resblock_f32_bwd(
            x.data_ptr(), h1.data_ptr(), g.data_ptr(), w1.data_ptr(),
            w2.data_ptr(), float(res_scale), gsp.data_ptr(),
            dh1p.data_ptr(), dx.data_ptr(), ws_w.data_ptr(), ws_b.data_ptr(),
            dwx.data_ptr(), dbx.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
            dw2.data_ptr(), db2.data_ptr(), bsz, h, w, c, cluster, clusters,
            _build.stream(dev))
    _build.check(err, 'srt_resblock_f32_bwd')
    resblock_bwd_fused.launches += 1
    return dx, dw1, db1, dw2, db2


resblock_bwd_fused.launches = 0


def _cast(x, w1, b1, w2, b2):
    """The kernel's operands: weights in x's dtype, biases f32."""
    dt = x.dtype
    return (w1.to(dt).contiguous(), b1.float().contiguous(),
            w2.to(dt).contiguous(), b2.float().contiguous())


class FusedResBlockFn(torch.autograd.Function):
    """Differentiable K8a (srtpu ``resblock_fused_v2``): f32 (or any)
    parameters in, cast to x's dtype (the biases to f32) inside; saves x,
    the x.dtype h1 and the cast weights; the grads of the weights are
    their x.dtype values in the parameters' dtype (srtpu's weight grads
    come back in the cast weights' dtype)."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, res_scale: float, plain: bool):
        ops = _cast(x, w1, b1, w2, b2)
        out, h1 = (resblock_fused_plain if plain else resblock_fused_fwd)(
            x, *ops, res_scale, save_h1=True)
        ctx.save_for_backward(x, h1, ops[0], ops[2])
        ctx.res_scale = res_scale
        ctx.dtypes = tuple(t.dtype for t in (w1, b1, w2, b2))
        return out

    @staticmethod
    def backward(ctx, g):
        x, h1, w1, w2 = ctx.saved_tensors
        grads = resblock_fused_bwd(x, h1, g.contiguous(), w1, w2,
                                   ctx.res_scale)
        return (grads[0], *(t.to(d) for t, d in zip(grads[1:], ctx.dtypes)),
                None, None)


def resblock_fused(x, w1, b1, w2, b2, res_scale: float = 1.0,
                   plain: bool = False) -> torch.Tensor:
    """One EDSR resblock on srtpu's fused NHWC route in x's dtype from f32
    (or any) weights: the autograd op when a gradient is wanted, else the
    forward alone without h1 (srtpu's ``resblock_fused``). ``plain`` runs
    the plain version on any device."""
    x = x.contiguous()
    params = (w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        return FusedResBlockFn.apply(x, *params, res_scale, plain)
    return (resblock_fused_plain if plain else resblock_fused_fwd)(
        x, *_cast(x, *params), res_scale)


class FusedResBlockV3Fn(torch.autograd.Function):
    """Differentiable K8a + K9d (srtpu ``resblock_fused_v3``): as
    :class:`FusedResBlockFn`, the backward K9d (:func:`resblock_bwd_fused`)
    instead of stock ops; the weight grads rounded to the cast weights'
    dtype (srtpu's ``_rb3_bwd``), then to the parameters'."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, res_scale: float, plain: bool):
        ops = _cast(x, w1, b1, w2, b2)
        out, h1 = (resblock_fused_plain if plain else resblock_fused_fwd)(
            x, *ops, res_scale, save_h1=True)
        ctx.save_for_backward(x, h1, ops[0], ops[2])
        ctx.res_scale, ctx.plain = res_scale, plain
        ctx.dtypes = tuple(t.dtype for t in (w1, b1, w2, b2))
        return out

    @staticmethod
    def backward(ctx, g):
        x, h1, w1, w2 = ctx.saved_tensors
        dx, dw1, db1, dw2, db2 = (
            resblock_bwd_fused_plain if ctx.plain else resblock_bwd_fused)(
                x, h1, g.contiguous(), w1, w2, ctx.res_scale)
        grads = (dw1.to(w1.dtype), db1, dw2.to(w2.dtype), db2)
        return (dx, *(t.to(d) for t, d in zip(grads, ctx.dtypes)), None,
                None)


def resblock_fused_v3(x, w1, b1, w2, b2, res_scale: float = 1.0,
                      plain: bool = False) -> torch.Tensor:
    """One EDSR resblock, K8a forward and K9d backward (srtpu
    ``resblock_fused_v3``), in x's dtype from f32 (or any) weights: the
    autograd op when a gradient is wanted, else the forward alone.
    ``plain`` runs the plain versions on any device."""
    x = x.contiguous()
    params = (w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        return FusedResBlockV3Fn.apply(x, *params, res_scale, plain)
    return (resblock_fused_plain if plain else resblock_fused_fwd)(
        x, *_cast(x, *params), res_scale)


class FusedTrunkFn(torch.autograd.Function):
    """Differentiable K8a trunk (srtpu's ``resblock_fused_v2`` block after
    block, as ``FusedResBlock`` runs it): f32 (or any) stacked parameters
    in, cast to x's dtype (the biases to f32) inside; one forward call
    (:func:`resblock_trunk_fwd`) saves every block's input and x.dtype
    h1; the backward is :func:`resblock_fused_bwd` per block, the last
    first, in one node, the grads of the weights their x.dtype values in
    the parameters' dtype: the per-block route's bits
    (:class:`FusedResBlockFn`)."""

    @staticmethod
    def forward(ctx, x, w1s, b1s, w2s, b2s, res_scale: float, plain: bool):
        ops = _cast(x, w1s, b1s, w2s, b2s)
        out, xs, h1s = (resblock_trunk_plain if plain
                        else resblock_trunk_fwd)(x, *ops, res_scale,
                                                 save=True)
        ctx.save_for_backward(x, xs, h1s, ops[0], ops[2])
        ctx.res_scale = res_scale
        ctx.dtypes = tuple(t.dtype for t in (w1s, b1s, w2s, b2s))
        return out

    @staticmethod
    def backward(ctx, g):
        x, xs, h1s, w1s, w2s = ctx.saved_tensors
        inputs = (x, *xs.unbind(0))
        g = g.contiguous()
        grads = []
        for i in reversed(range(h1s.shape[0])):
            g, *gi = resblock_fused_bwd(inputs[i], h1s[i], g, w1s[i], w2s[i],
                                        ctx.res_scale)
            grads.append(gi)
        stacked = (torch.stack(t[::-1]) for t in zip(*grads))
        return (g, *(t.to(d) for t, d in zip(stacked, ctx.dtypes)), None,
                None)


def resblock_fused_trunk(x, w1s, b1s, w2s, b2s, res_scale: float = 1.0,
                         plain: bool = False) -> torch.Tensor:
    """EDSR's True-route trunk: L blocks of :func:`resblock_fused` on
    stacked f32 (or any) weights (w1s, w2s (L, 3, 3, C, C), b1s, b2s (L,
    C)) in x's dtype, one host call forward: the autograd op when a
    gradient is wanted, else the forward alone without h1. ``plain`` runs
    the plain versions on any device."""
    x = x.contiguous()
    params = (w1s, b1s, w2s, b2s)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        return FusedTrunkFn.apply(x, *params, res_scale, plain)
    return (resblock_trunk_plain if plain else resblock_trunk_fwd)(
        x, *_cast(x, *params), res_scale)
