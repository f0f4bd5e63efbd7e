"""K5: RCAN's residual channel-attention block (RCAB) and the residual
group around it, forward and backward.

Replaces ``srtpu/ops/cs_conv.py:_rcab_fwd_call`` (body
``_rcab_fwd_kernel``) and ``_rcab_bwd_call`` (``_rcab_bwd_kernel``),
behind ``resgroup_ca_cs``. The kernels are ``csrc/rcab.cu``, whose head
note says what bounds them on the H100 and how the design answers the
channel attention's whole-image pool: the two convs and the backward's
two transposed convs run on K2's wgmma engine (``csrc/conv_sm90.cuh``,
conv1 as K2's own instance, the others with K5's epilogues), beside
rcab.cu's pool, MLP, gate and dr2 passes, and the conv weight grads come
from the weight-grad kernel (:mod:`.wgrad`), one launch per conv for all
blocks of a group. :func:`group_fwd` and :func:`group_chain` run a
group's L RCABs in one host call each way (checks and scratch once per
group); :func:`rcab_fwd` and :func:`rcab_bwd` are one RCAB over the same
calls at L = 1. Each launches the kernels for CUDA tensors and takes the
plain versions only for CPU tensors; :func:`resgroup` is the
differentiable group op (:class:`ResGroupFn`). :func:`fwd_plan`,
:func:`chain_plan` and :func:`tile_grid` say in plain Python what
rcab.cu launches.

Shapes: activations NHWC (B, H, W, C); conv weights HWIO (3, 3, C, C)
in the compute dtype, their biases f32; the attention MLP wd (C, Cr),
bd (Cr,), wu (Cr, C), bu (C,) in f32 (srtpu never casts them). Group
stacks carry a leading L.
"""

from __future__ import annotations

import torch

from . import _build
from .conv import (conv3x3_bwd, conv3x3_bwd_plain, conv3x3_fwd,
                   conv3x3_plain, conv_f32)
from .layout import w_t
from .wgrad import conv_wgrad, conv_wgrad_plain

C = 64              # the kernels' channels
TH, TW = 8, 16      # the engine's pixel tile
CHUNK = 128         # pixels per block of the backward's pool sums


def tile_grid(bsz: int, h: int, w: int) -> tuple:
    """The engine's blocks over (B, H, W) images: (B, ceil(H / 8), ceil(W
    / 16)) 8 x 16 pixel tiles, one N tile of 64 channels each; conv2's
    pool partials are one slot per tile, in this order."""
    return bsz, -(-h // TH), -(-w // TW)


def fwd_plan(save: bool) -> tuple:
    """rcab.cu's launches for one RCAB's forward, in order, each (kernel,
    EPI, k, cin, cout, transposed, what it writes): 'engine' is K2's
    engine over :func:`tile_grid`'s tiles (EPI 0, K2's own instance; 4,
    K5's conv2 epilogue), the others rcab.cu's passes."""
    return (('engine', 0, 3, C, C, False, ('h1',)),
            ('engine', 4, 3, C, C, False,
             ('r2f', 'r2', 'part') if save else ('r2f', 'part')),
            ('pool_mlp', None, None, None, None, None, ('q',)),
            ('gate', None, None, None, None, None, ('out',)))


def chain_plan() -> tuple:
    """rcab.cu's launches for one RCAB's dx chain, in order, as
    :func:`fwd_plan`: the pool sums, the MLP's backward and its grads,
    dr2, then two transposed launches of the engine with K5's dx epilogue
    (EPI 5: the mask of h1, then the skip g)."""
    return (('ca_sums', None, None, None, None, None, ('part',)),
            ('ca_bwd', None, None, None, None, None, ('q', 'dpn', 'vec')),
            ('mlp_grads', None, None, None, None, None,
             ('dwd', 'dbd', 'dwu', 'dbu')),
            ('dr2', None, None, None, None, None, ('dr2',)),
            ('engine', 5, 3, C, C, True, ('dh1',)),
            ('engine', 5, 3, C, C, True, ('dx',)))


def _attention(r2f, wd, bd, wu, bu):
    """Channel attention of f32 r2 (B, H, W, C) -> (p, z, q), (B, C),
    (B, Cr), (B, C) f32 (srtpu ``_ca_forward``)."""
    p = r2f.mean((1, 2))
    z = (p @ wd.float() + bd.float()).clamp_min(0.0)
    q = torch.sigmoid(z @ wu.float() + bu.float())
    return p, z, q


def rcab_fwd_plain(x, w1, b1, w2, b2, wd, bd, wu, bu, save: bool = False):
    """Plain version, rounding where ``_rcab_fwd_kernel`` does:
    h1 = x.dtype(relu(conv(x, W1) + b1)); r2f = conv(h1, W2) + b2 in f32;
    q from the mean of r2f over the image; out = x.dtype(x + r2f * q).
    ``save`` returns ``(out, h1, r2)`` with r2 = r2f in x.dtype."""
    h1 = conv3x3_plain(x, w1, b1, relu=True)
    r2f = conv_f32(h1, w2, b2)
    q = _attention(r2f, wd, bd, wu, bu)[2]
    out = (x.float() + r2f * q[:, None, None, :]).to(x.dtype).contiguous()
    return (out, h1, r2f.to(x.dtype).contiguous()) if save else out


def _chain_plain(h1, r2, g, w1, w2, wd, bd, wu, bu, dr2, dh1):
    """Plain dx chain of one RCAB, rounding where ``_rcab_bwd_kernel``
    does; the gate recomputed from the saved r2:
      dq = sum(g * r2), dzq = dq q (1 - q), dz = (dzq Wu^T)[z > 0],
      dp = dz Wd^T, dr2 = bf16(g q + dp / (H W)),
      dh1 = bf16(h1 > 0 ? convT(dr2, W2) : 0), dx = bf16(convT(dh1, W1) + g)
    (bf16 meaning g's dtype; convT the transposed conv of the forward
    weight). Writes dr2 and dh1; returns dx and the f32 MLP grads (dwd,
    dbd, dwu, dbu)."""
    dt = g.dtype
    r2f, gf = r2.float(), g.float()
    n_pix = r2.shape[1] * r2.shape[2]
    p, z, q = _attention(r2f, wd, bd, wu, bu)
    dq = (gf * r2f).sum((1, 2))
    dzq = dq * q * (1.0 - q)
    dz = (dzq @ wu.float().t()) * (z > 0)
    dp = dz @ wd.float().t()
    dr2.copy_((gf * q[:, None, None] + (dp / n_pix)[:, None, None]).to(dt))
    dh1.copy_(torch.where(h1.float() > 0, conv_f32(dr2, w_t(w2)), 0.0)
              .to(dt))
    dx = (conv_f32(dh1, w_t(w1)) + gf).to(dt).contiguous()
    return dx, p.t() @ dz, dz.sum(0), z.t() @ dzq, dzq.sum(0)


def _blocks(*stacks):
    return [tuple(t[i] for t in stacks) for i in range(stacks[0].shape[0])]


def _expect_group(x, w1s, w2s, wds, bds, wus, bus, b1s, b2s, what: str):
    """Raise unless a group's operands are what rcab.cu takes (on a card,
    C = 64, 1 <= C/r <= 64; b1s and b2s None in the backward); returns
    (L, C/r)."""
    if x.device.type != 'cuda':
        raise ValueError(f'{what}: no kernel for device {x.device}')
    if x.shape[-1] != C:
        raise ValueError(f'{what}: no kernel for C={x.shape[-1]}')
    n, cr = w1s.shape[0], wds.shape[-1]
    if not 1 <= cr <= C:
        raise ValueError(f'{what}: no kernel for C/r = {cr}')
    dev = x.device
    _build.expect(x, 'x', torch.bfloat16, x.shape, dev)
    for name, t in (('w1', w1s), ('w2', w2s)):
        _build.expect(t, name, torch.bfloat16, (n, 3, 3, C, C), dev)
    for name, t, shape in (('wd', wds, (C, cr)), ('bd', bds, (cr,)),
                           ('wu', wus, (cr, C)), ('bu', bus, (C,)),
                           ('b1', b1s, (C,)), ('b2', b2s, (C,))):
        if t is not None:
            _build.expect(t, name, torch.float32, (n, *shape), dev,
                          aligned=False)
    return n, cr


def group_fwd(x, w1s, b1s, w2s, b2s, wds, bds, wus, bus, save: bool = False,
              plain: bool = False, ys=None):
    """K5's forward over a group's L RCABs (the stacks' leading dim) from
    x (B, H, W, C): the last RCAB's output, or with ``save`` the stacks
    ``(ys, h1s, r2s)``, (L, B, H, W, C) each, ys[i] RCAB i's output (into
    ``ys`` when given, a contiguous (L, B, H, W, C) of x's dtype). On CUDA
    one host call (five launches an RCAB; ``rcab_fwd.launches`` counts
    the RCABs); with ``plain`` or a CPU tensor :func:`rcab_fwd_plain` per
    RCAB. Without ``plain`` the registered operator
    ``srtpu::rcab_group_fwd`` (:mod:`._library`), which writes ys in
    place."""
    blocks = (w1s, b1s, w2s, b2s, wds, bds, wus, bus)
    if save and ys is None:
        ys = x.new_empty((w1s.shape[0], *x.shape))
    ys = ys if save else None
    if plain:
        got = group_fwd_cpu(x, *blocks, ys)
    elif x.device.type in _build.OP_DEVICES:
        got = torch.ops.srtpu.rcab_group_fwd.default(x, *blocks, ys)
    else:
        got = group_fwd_cuda(x, *blocks, ys)
    return (ys, *got) if save else got[0]


def group_fwd_cpu(x, w1s, b1s, w2s, b2s, wds, bds, wus, bus, ys) -> list:
    """``srtpu::rcab_group_fwd`` on the CPU (and the plain route on any
    device): :func:`rcab_fwd_plain` per RCAB; with ``ys`` the RCABs'
    outputs go into it and ``[h1s, r2s]`` come back, else ``[out]``."""
    n = w1s.shape[0]
    blocks = (w1s, b1s, w2s, b2s, wds, bds, wus, bus)
    if ys is None:
        for prm in _blocks(*blocks):
            x = rcab_fwd_plain(x, *prm)
        return [x]
    h1s, r2s = x.new_empty((n, *x.shape)), x.new_empty((n, *x.shape))
    cur = x
    for i, prm in enumerate(_blocks(*blocks)):
        for dst, src in zip((ys[i], h1s[i], r2s[i]),
                            rcab_fwd_plain(cur, *prm, save=True)):
            dst.copy_(src)
        cur = ys[i]
    return [h1s, r2s]


def group_fwd_cuda(x, w1s, b1s, w2s, b2s, wds, bds, wus, bus, ys) -> list:
    """``srtpu::rcab_group_fwd`` on CUDA: the checks, the scratch, one
    ``srt_rcab_group_fwd`` call, the count; ``[h1s, r2s]`` with ``ys``
    (written in place), else ``[out]``."""
    save = ys is not None
    blocks = (w1s, b1s, w2s, b2s, wds, bds, wus, bus)
    n, cr = _expect_group(x, w1s, w2s, wds, bds, wus, bus, b1s, b2s,
                          'rcab_fwd')
    bsz, h, w, _ = x.shape
    if save:
        _build.expect(ys, 'ys', torch.bfloat16, (n, *x.shape), x.device)
        h1, r2 = x.new_empty((n, *x.shape)), x.new_empty((n, *x.shape))
    else:   # RCAB i's output in slot i % 2; h1 scratch
        ys = x.new_empty((min(n, 2), *x.shape))
        h1, r2 = torch.empty_like(x), None
    f32 = dict(dtype=torch.float32, device=x.device)
    _, ty, tx = tile_grid(bsz, h, w)
    r2f = torch.empty(x.shape, **f32)
    part = torch.empty((bsz, ty * tx, C), **f32)
    q = torch.empty((bsz, C), **f32)
    lib = _build.library()
    with _build.on(x.device):
        err = lib.srt_rcab_group_fwd(
            x.data_ptr(), *(t.data_ptr() for t in blocks), ys.data_ptr(),
            h1.data_ptr(), None if r2 is None else r2.data_ptr(),
            r2f.data_ptr(), part.data_ptr(), q.data_ptr(), n, int(save),
            bsz, h, w, C, cr, _build.stream(x.device))
    _build.check(err, 'srt_rcab_group_fwd')
    rcab_fwd.launches += n
    return [h1, r2] if save else [ys[(n - 1) % 2]]


def group_chain(h1s, r2s, g, w1s, w2s, wds, bds, wus, bus,
                plain: bool = False):
    """K5's backward over a group's L RCABs without the conv weight grads,
    the last RCAB first, from the saved stacks h1s, r2s (L, B, H, W, C)
    and the cotangent g of the last RCAB's output. Returns dx (the first
    RCAB's input cotangent), the stacks dr2s and dh1s (L, B, H, W, C) the
    weight grads read, and the f32 MLP grads (dwd, dbd, dwu, dbu), each
    (L, ...). On CUDA one host call (six launches an RCAB;
    ``rcab_bwd.launches`` counts the RCABs); with ``plain`` or a CPU
    tensor :func:`_chain_plain` per RCAB."""
    dr2s, dh1s = torch.empty_like(h1s), torch.empty_like(h1s)
    n = w1s.shape[0]
    if plain or g.device.type == 'cpu':
        mlp = [None] * n
        for i in reversed(range(n)):
            g, *mlp[i] = _chain_plain(h1s[i], r2s[i], g, w1s[i], w2s[i],
                                      wds[i], bds[i], wus[i], bus[i],
                                      dr2s[i], dh1s[i])
        return g, dr2s, dh1s, tuple(torch.stack(t) for t in zip(*mlp))
    n, cr = _expect_group(g, w1s, w2s, wds, bds, wus, bus, None, None,
                          'rcab_bwd')
    bsz, h, w, _ = g.shape
    for name, t in (('h1', h1s), ('r2', r2s)):
        _build.expect(t, name, torch.bfloat16, (n, *g.shape), g.device)
    f32 = dict(dtype=torch.float32, device=g.device)
    # pool-sum partials of r2 and g * r2, then per image p, dzq, z, dz
    part = torch.empty(2 * bsz * -(-h * w // CHUNK) * C
                       + bsz * (2 * C + 2 * cr), **f32)
    q, dpn = torch.empty((bsz, C), **f32), torch.empty((bsz, C), **f32)
    gs = g.new_empty((min(n, 2), *g.shape))    # RCAB i's dx in slot i % 2
    mlp = (torch.empty((n, C, cr), **f32), torch.empty((n, cr), **f32),
           torch.empty((n, cr, C), **f32), torch.empty((n, C), **f32))
    lib = _build.library()
    with _build.on(g.device):
        err = lib.srt_rcab_group_chain(
            h1s.data_ptr(), r2s.data_ptr(), g.data_ptr(), w1s.data_ptr(),
            w2s.data_ptr(), wds.data_ptr(), bds.data_ptr(), wus.data_ptr(),
            bus.data_ptr(), part.data_ptr(), q.data_ptr(), dpn.data_ptr(),
            dr2s.data_ptr(), dh1s.data_ptr(), gs.data_ptr(),
            *(t.data_ptr() for t in mlp), n, bsz, h, w, C, cr,
            _build.stream(g.device))
    _build.check(err, 'srt_rcab_group_chain')
    rcab_bwd.launches += n
    return gs[0], dr2s, dh1s, mlp


def rcab_fwd(x, w1, b1, w2, b2, wd, bd, wu, bu, save: bool = False):
    """x (B, H, W, C) bf16; w1, w2 (3, 3, C, C) bf16; b1, b2 (C,) f32; MLP
    f32 -> out (B, H, W, C) bf16, or with ``save`` ``(out, h1, r2)``, as
    :func:`rcab_fwd_plain`. On CUDA: C = 64, 1 <= C/r <= 64; one call is
    :func:`group_fwd` at L = 1 (conv1, conv2, pool + MLP, gate)."""
    if x.device.type == 'cpu':
        return rcab_fwd_plain(x, w1, b1, w2, b2, wd, bd, wu, bu, save)
    got = group_fwd(x, *(t[None] for t in (w1, b1, w2, b2, wd, bd, wu, bu)),
                    save=save)
    return tuple(t[0] for t in got) if save else got


def _bwd(x, h1, r2, g, w1, w2, wd, bd, wu, bu, plain: bool):
    dx, dr2, dh1, mlp = group_chain(
        h1[None], r2[None], g, *(t[None] for t in (w1, w2, wd, bd, wu, bu)),
        plain=plain)
    wgrad = conv_wgrad_plain if plain else conv_wgrad
    dw2, db2 = wgrad(h1, dr2[0])
    dw1, db1 = wgrad(x, dh1[0])
    return (dx, dw1, db1, dw2, db2, *(t[0] for t in mlp))


def rcab_bwd_plain(x, h1, r2, g, w1, w2, wd, bd, wu, bu):
    """Plain backward of one RCAB from its input x, saved h1 and r2 and
    the cotangent g of its output: dx and the f32 grads (dw1, db1, dw2,
    db2, dwd, dbd, dwu, dbu); dW2 = corr(h1, dr2), dW1 = corr(x, dh1)."""
    return _bwd(x, h1, r2, g, w1, w2, wd, bd, wu, bu, plain=True)


def rcab_bwd(x, h1, r2, g, w1, w2, wd, bd, wu, bu):
    """As :func:`rcab_bwd_plain`, bf16 activations and conv weights. On
    CUDA: :func:`group_chain` at L = 1 (six launches) and two weight-grad
    launches."""
    return _bwd(x, h1, r2, g, w1, w2, wd, bd, wu, bu,
                plain=x.device.type == 'cpu')


rcab_fwd.launches = 0
rcab_bwd.launches = 0


def resgroup_fwd(x, w1s, b1s, w2s, b2s, wds, bds, wus, bus, wc, bc,
                 save: bool = False, plain: bool = False):
    """A residual group (srtpu ``_rg_fwd``): L RCABs (:func:`group_fwd`),
    the close conv (K2) and the group skip, out = conv(x_L, Wc) + bc
    rounded to x's dtype, plus x in x's dtype. Weights as
    :func:`rcab_fwd`, stacked (L, ...); wc (3, 3, C, C), bc (C,). ``save``
    returns ``(out, xs, h1s, r2s)``: xs (L + 1, B, H, W, C) holds each
    block's input and, last, the close conv's; h1s, r2s (L, ...) the
    blocks' saved activations. ``plain`` runs the plain versions on any
    device."""
    blocks = (w1s, b1s, w2s, b2s, wds, bds, wus, bus)
    if save:
        xs = x.new_empty((w1s.shape[0] + 1, *x.shape))
        xs[0].copy_(x)
        _, h1s, r2s = group_fwd(x, *blocks, save=True, plain=plain,
                                ys=xs[1:])
        cur = xs[-1]
    else:
        cur = group_fwd(x, *blocks, plain=plain)
    out = (conv3x3_plain if plain else conv3x3_fwd)(cur, wc, bc) + x
    return (out, xs, h1s, r2s) if save else out


def resgroup_plain(x, w1s, b1s, w2s, b2s, wds, bds, wus, bus, wc, bc,
                   save: bool = False):
    """Plain version of the group, as :func:`resgroup_fwd`."""
    return resgroup_fwd(x, w1s, b1s, w2s, b2s, wds, bds, wus, bus, wc, bc,
                        save, plain=True)


def resgroup_bwd(xs, h1s, r2s, g, w1s, w2s, wds, bds, wus, bus, wc,
                 plain: bool = False):
    """Backward of :func:`resgroup_fwd` (srtpu ``_rg_vjp_bwd``) from its
    saved (xs, h1s, r2s) and the cotangent g of its output: the close
    conv's backward (K2), the RCABs' in reverse (:func:`group_chain`),
    then the conv weight grads of all blocks, one weight-grad launch per
    conv, and dx = bf16(f32(g_chain) + f32(g)). Returns dx and the f32
    grads of (w1s, b1s, w2s, b2s, wds, bds, wus, bus, wc, bc)."""
    kernel = not plain and g.device.type != 'cpu'
    n = w1s.shape[0]
    gc, dwc, dbc = (conv3x3_bwd_plain if plain else conv3x3_bwd)(
        xs[n], wc, g)
    gc, dr2s, dh1s, mlp = group_chain(h1s, r2s, gc, w1s, w2s, wds, bds,
                                      wus, bus, plain=plain)
    wgrad = conv_wgrad if kernel else conv_wgrad_plain
    dw2, db2 = wgrad(h1s, dr2s)
    dw1, db1 = wgrad(xs[:n], dh1s)
    return (gc + g, dw1, db1, dw2, db2, *mlp, dwc, dbc)


def resgroup_bwd_plain(xs, h1s, r2s, g, w1s, w2s, wds, bds, wus, bus, wc):
    """Plain version of the group's backward, as :func:`resgroup_bwd`."""
    return resgroup_bwd(xs, h1s, r2s, g, w1s, w2s, wds, bds, wus, bus, wc,
                        plain=True)


def _cast(x, w1s, b1s, w2s, b2s, wds, bds, wus, bus, wc, bc):
    """Conv weights to x's dtype, biases and the MLP to f32 (srtpu
    ``_rg_fwd``)."""
    conv = lambda w: w.to(x.dtype).contiguous()  # noqa: E731
    f32 = lambda t: t.float().contiguous()        # noqa: E731
    return (conv(w1s), f32(b1s), conv(w2s), f32(b2s), f32(wds), f32(bds),
            f32(wus), f32(bus), conv(wc), f32(bc))


class ResGroupFn(torch.autograd.Function):
    """Differentiable K5 group (srtpu ``resgroup_ca_cs``): f32 parameters
    in, the conv weights cast to x's dtype inside; saves every block's
    input, h1 and r2 and the close conv's input; returns f32 grads."""

    @staticmethod
    def forward(ctx, x, w1s, b1s, w2s, b2s, wds, bds, wus, bus, wc, bc,
                plain: bool):
        prm = _cast(x, w1s, b1s, w2s, b2s, wds, bds, wus, bus, wc, bc)
        out, xs, h1s, r2s = resgroup_fwd(x, *prm, save=True, plain=plain)
        w1d, _, w2d, _, wd, bd, wu, bu, wcd, _ = prm
        ctx.save_for_backward(xs, h1s, r2s, w1d, w2d, wd, bd, wu, bu, wcd)
        ctx.plain = plain
        ctx.dtypes = tuple(t.dtype for t in (w1s, b1s, w2s, b2s, wds, bds,
                                             wus, bus, wc, bc))
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors   # once: a remat forward's unpack
        dx, *dparams = resgroup_bwd(*saved[:3], g.contiguous(), *saved[3:],
                                    plain=ctx.plain)
        return (dx, *(d.to(t) for d, t in zip(dparams, ctx.dtypes)), None)


def resgroup(x, w1s, b1s, w2s, b2s, wds, bds, wus, bus, wc, bc,
             plain: bool = False) -> torch.Tensor:
    """One residual group in x's dtype from f32 (or any) parameters: the
    autograd op when a gradient is wanted, else the forward alone (no
    saved activations)."""
    params = (w1s, b1s, w2s, b2s, wds, bds, wus, bus, wc, bc)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *params)):
        return ResGroupFn.apply(x, *params, plain)
    return resgroup_fwd(x, *_cast(x, *params), plain=plain)


def resgroup_xla(x, w1s, b1s, w2s, b2s, wds, bds, wus, bus, wc, bc):
    """srtpu ``CSResidualGroup.xla_apply``, which its RCAN trunk takes past
    96 features (srtpu/models/rcan.py:130-147, :235-240), in stock
    differentiable ops on x's dtype: per RCAB ``conv3x3_reference`` twice
    on the f32 weights (f32 conv + f32 bias, rounded to x's dtype; ReLU
    between), ``ca_gate_reference`` (f32 pool, MLP and sigmoid; the gate
    rounded to x's dtype, r * gate in x's dtype) and the skip in x's
    dtype; then the close conv as ``conv3x3_reference`` and the group skip.
    No kernel of the port runs here."""
    res = x
    for w1, b1, w2, b2, wd, bd, wu, bu in _blocks(w1s, b1s, w2s, b2s, wds,
                                                  bds, wus, bus):
        r = conv3x3_plain(res, w1.float(), b1.float(), relu=True)
        r = conv3x3_plain(r, w2.float(), b2.float())
        q = _attention(r.float(), wd, bd, wu, bu)[2]
        res = res + r * q[:, None, None, :].to(r.dtype)
    return conv3x3_plain(res, wc.float(), bc.float()) + x
