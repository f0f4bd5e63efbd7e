"""K5: RCAN's residual channel-attention block (RCAB) and the residual
group around it, forward and backward.

Replaces ``srtpu/ops/cs_conv.py:_rcab_fwd_call`` (body
``_rcab_fwd_kernel``) and ``_rcab_bwd_call`` (``_rcab_bwd_kernel``),
behind ``resgroup_ca_cs``. The kernels are ``csrc/rcab.cu``, whose head
note says what bounds them on the H100 and how the design answers the
channel attention's whole-image pool; the conv pair and the backward's
dx chain are the fused-block bodies K1 uses (``csrc/fused_block.cuh``),
and the conv weight grads come from the weight-grad kernel
(:mod:`.wgrad`), one launch per conv for all blocks of a group.
:func:`rcab_fwd` and :func:`rcab_bwd` launch the kernels for CUDA
tensors and take the plain versions only for CPU tensors;
:func:`resgroup` is the differentiable group op (:class:`ResGroupFn`).

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

TH, TW = 8, 16      # the conv pair's pixel tile
CHUNK = 128         # pixels per block of the backward's pool sums


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


def _chain_plain(h1, r2, g, w1t, w2t, wd, bd, wu, bu, dr2, dh1):
    """Plain dx chain of one RCAB, rounding where ``_rcab_bwd_kernel``
    does; the gate recomputed from the saved r2:
      dq = sum(g * r2), dzq = dq q (1 - q), dz = (dzq Wu^T)[z > 0],
      dp = dz Wd^T, dr2 = bf16(g q + dp / (H W)),
      dh1 = bf16(h1 > 0 ? convT(dr2, W2) : 0), dx = bf16(convT(dh1, W1) + g)
    (bf16 meaning g's dtype). Writes dr2 and dh1; returns dx and the f32
    MLP grads (dwd, dbd, dwu, dbu)."""
    dt = g.dtype
    r2f, gf = r2.float(), g.float()
    n_pix = r2.shape[1] * r2.shape[2]
    p, z, q = _attention(r2f, wd, bd, wu, bu)
    dq = (gf * r2f).sum((1, 2))
    dzq = dq * q * (1.0 - q)
    dz = (dzq @ wu.float().t()) * (z > 0)
    dp = dz @ wd.float().t()
    dr2.copy_((gf * q[:, None, None] + (dp / n_pix)[:, None, None]).to(dt))
    dh1.copy_(torch.where(h1.float() > 0, conv_f32(dr2, w2t), 0.0).to(dt))
    dx = (conv_f32(dh1, w1t) + gf).to(dt).contiguous()
    return dx, p.t() @ dz, dz.sum(0), z.t() @ dzq, dzq.sum(0)


def _check(name: str, x: torch.Tensor) -> None:
    if x.device.type != 'cuda':
        raise ValueError(f'{name}: no kernel for device {x.device}')
    if x.shape[-1] != 64:
        raise ValueError(f'{name}: no kernel for C={x.shape[-1]}')


def _expect_mlp(wd, bd, wu, bu, c: int, dev) -> int:
    cr = wd.shape[-1]
    if not 1 <= cr <= c:
        raise ValueError(f'rcab: no kernel for C/r = {cr}')
    for name, t, shape in (('wd', wd, (c, cr)), ('bd', bd, (cr,)),
                           ('wu', wu, (cr, c)), ('bu', bu, (c,))):
        _build.expect(t, name, torch.float32, shape, dev, aligned=False)
    return cr


def _fwd_into(x, prm, out, h1, r2) -> None:
    """Launch K5's forward (F1-F3) for one RCAB into out (and, saving,
    h1 and r2)."""
    w1, b1, w2, b2, wd, bd, wu, bu = prm
    _check('rcab_fwd', x)
    bsz, h, w, c = x.shape
    dev = x.device
    act = (bsz, h, w, c)
    for name, t in (('x', x), ('out', out)) + (
            (('h1', h1), ('r2', r2)) if h1 is not None else ()):
        _build.expect(t, name, torch.bfloat16, act, dev)
    for name, t in (('w1', w1), ('w2', w2)):
        _build.expect(t, name, torch.bfloat16, (3, 3, c, c), dev)
    for name, t in (('b1', b1), ('b2', b2)):
        _build.expect(t, name, torch.float32, (c,), dev)
    cr = _expect_mlp(wd, bd, wu, bu, c, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    r2f = torch.empty(act, **f32)
    part = torch.empty((bsz, -(-h // TH) * -(-w // TW), c), **f32)
    q = torch.empty((bsz, c), **f32)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.srt_rcab_fwd(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), wd.data_ptr(), bd.data_ptr(), wu.data_ptr(),
            bu.data_ptr(), r2f.data_ptr(), part.data_ptr(), q.data_ptr(),
            out.data_ptr(), None if h1 is None else h1.data_ptr(),
            None if r2 is None else r2.data_ptr(), bsz, h, w, c, cr,
            _build.stream(dev))
    _build.check(err, 'srt_rcab_fwd')
    rcab_fwd.launches += 1


def rcab_fwd(x, w1, b1, w2, b2, wd, bd, wu, bu, save: bool = False):
    """x (B, H, W, C) bf16; w1, w2 (3, 3, C, C) bf16; b1, b2 (C,) f32; MLP
    f32 -> out (B, H, W, C) bf16, or with ``save`` ``(out, h1, r2)``, as
    :func:`rcab_fwd_plain`. On CUDA: C = 64, 1 <= C/r <= 64; one call is
    three launches (conv pair, pool + MLP, gate)."""
    if x.device.type == 'cpu':
        return rcab_fwd_plain(x, w1, b1, w2, b2, wd, bd, wu, bu, save)
    out = torch.empty_like(x)
    h1 = torch.empty_like(x) if save else None
    r2 = torch.empty_like(x) if save else None
    _fwd_into(x, (w1, b1, w2, b2, wd, bd, wu, bu), out, h1, r2)
    return (out, h1, r2) if save else out


def _chain(h1, r2, g, w1t, w2t, wd, bd, wu, bu, dr2, dh1):
    """K5's backward without the conv weight grads (B1-B4, five
    launches), as :func:`_chain_plain`; the plain version only for CPU
    tensors."""
    if g.device.type == 'cpu':
        return _chain_plain(h1, r2, g, w1t, w2t, wd, bd, wu, bu, dr2, dh1)
    _check('rcab_bwd', g)
    bsz, h, w, c = g.shape
    dev = g.device
    for name, t in (('h1', h1), ('r2', r2), ('g', g), ('dr2', dr2),
                    ('dh1', dh1)):
        _build.expect(t, name, torch.bfloat16, (bsz, h, w, c), dev)
    for name, t in (('w1t', w1t), ('w2t', w2t)):
        _build.expect(t, name, torch.bfloat16, (3, 3, c, c), dev)
    cr = _expect_mlp(wd, bd, wu, bu, c, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    # pool-sum partials of r2 and g * r2, then per image p, dzq, z, dz
    part = torch.empty(2 * bsz * -(-h * w // CHUNK) * c
                       + bsz * (2 * c + 2 * cr), **f32)
    q = torch.empty((bsz, c), **f32)
    dpn = torch.empty((bsz, c), **f32)
    dx = torch.empty_like(g)
    dwd, dbd = torch.empty((c, cr), **f32), torch.empty((cr,), **f32)
    dwu, dbu = torch.empty((cr, c), **f32), torch.empty((c,), **f32)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.srt_rcab_bwd(
            h1.data_ptr(), r2.data_ptr(), g.data_ptr(), w2t.data_ptr(),
            w1t.data_ptr(), wd.data_ptr(), bd.data_ptr(), wu.data_ptr(),
            bu.data_ptr(), part.data_ptr(), q.data_ptr(), dpn.data_ptr(),
            dr2.data_ptr(), dh1.data_ptr(), dx.data_ptr(), dwd.data_ptr(),
            dbd.data_ptr(), dwu.data_ptr(), dbu.data_ptr(), bsz, h, w, c, cr,
            _build.stream(dev))
    _build.check(err, 'srt_rcab_bwd')
    rcab_bwd.launches += 1
    return dx, dwd, dbd, dwu, dbu


def _bwd(x, h1, r2, g, w1, w2, wd, bd, wu, bu, plain: bool):
    dr2, dh1 = torch.empty_like(g), torch.empty_like(g)
    dx, dwd, dbd, dwu, dbu = (_chain_plain if plain else _chain)(
        h1, r2, g, w_t(w1).contiguous(), w_t(w2).contiguous(), wd, bd, wu,
        bu, dr2, dh1)
    wgrad = conv_wgrad_plain if plain else conv_wgrad
    dw2, db2 = wgrad(h1, dr2)
    dw1, db1 = wgrad(x, dh1)
    return dx, dw1, db1, dw2, db2, dwd, dbd, dwu, dbu


def rcab_bwd_plain(x, h1, r2, g, w1, w2, wd, bd, wu, bu):
    """Plain backward of one RCAB from its input x, saved h1 and r2 and
    the cotangent g of its output: dx and the f32 grads (dw1, db1, dw2,
    db2, dwd, dbd, dwu, dbu); dW2 = corr(h1, dr2), dW1 = corr(x, dh1)."""
    return _bwd(x, h1, r2, g, w1, w2, wd, bd, wu, bu, plain=True)


def rcab_bwd(x, h1, r2, g, w1, w2, wd, bd, wu, bu):
    """As :func:`rcab_bwd_plain`, bf16 activations and conv weights. On
    CUDA: one K5 backward call (five launches) and two weight-grad
    launches."""
    return _bwd(x, h1, r2, g, w1, w2, wd, bd, wu, bu,
                plain=x.device.type == 'cpu')


rcab_fwd.launches = 0
rcab_bwd.launches = 0


def _blocks(w1s, b1s, w2s, b2s, wds, bds, wus, bus):
    return [tuple(t[i] for t in (w1s, b1s, w2s, b2s, wds, bds, wus, bus))
            for i in range(w1s.shape[0])]


def resgroup_fwd(x, w1s, b1s, w2s, b2s, wds, bds, wus, bus, wc, bc,
                 save: bool = False, plain: bool = False):
    """A residual group (srtpu ``_rg_fwd``): L RCABs, the close conv (K2)
    and the group skip, out = conv(x_L, Wc) + bc rounded to x's dtype,
    plus x in x's dtype. Weights as :func:`rcab_fwd`, stacked (L, ...);
    wc (3, 3, C, C), bc (C,). ``save`` returns ``(out, xs, h1s, r2s)``:
    xs (L + 1, B, H, W, C) holds each block's input and, last, the close
    conv's; h1s, r2s (L, ...) the blocks' saved activations. ``plain``
    runs the plain versions on any device."""
    blocks = _blocks(w1s, b1s, w2s, b2s, wds, bds, wus, bus)
    kernel = not plain and x.device.type != 'cpu'
    if save:
        xs = x.new_empty((len(blocks) + 1, *x.shape))
        xs[0].copy_(x)
        h1s = x.new_empty((len(blocks), *x.shape))
        r2s = torch.empty_like(h1s)
        for i, prm in enumerate(blocks):
            if kernel:
                _fwd_into(xs[i], prm, xs[i + 1], h1s[i], r2s[i])
            else:
                for dst, src in zip((xs[i + 1], h1s[i], r2s[i]),
                                    rcab_fwd_plain(xs[i], *prm, save=True)):
                    dst.copy_(src)
        cur = xs[-1]
    else:
        cur = x
        for prm in blocks:
            cur = (rcab_fwd if kernel else rcab_fwd_plain)(cur, *prm)
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
    conv's backward (K2), the RCABs' in reverse (K5), then the conv
    weight grads of all blocks, one weight-grad launch per conv, and
    dx = bf16(f32(g_chain) + f32(g)). Returns dx and the f32 grads of
    (w1s, b1s, w2s, b2s, wds, bds, wus, bus, wc, bc)."""
    kernel = not plain and g.device.type != 'cpu'
    n = w1s.shape[0]
    gc, dwc, dbc = (conv3x3_bwd_plain if plain else conv3x3_bwd)(
        xs[n], wc, g)
    w1t, w2t = w_t(w1s).contiguous(), w_t(w2s).contiguous()
    dr2s, dh1s = torch.empty_like(h1s), torch.empty_like(h1s)
    mlp = [None] * n
    for i in reversed(range(n)):
        gc, *mlp[i] = (_chain if kernel else _chain_plain)(
            h1s[i], r2s[i], gc, w1t[i], w2t[i], wds[i], bds[i], wus[i],
            bus[i], dr2s[i], dh1s[i])
    wgrad = conv_wgrad if kernel else conv_wgrad_plain
    dw2, db2 = wgrad(h1s, dr2s)
    dw1, db1 = wgrad(xs[:n], dh1s)
    dwd, dbd, dwu, dbu = (torch.stack(t) for t in zip(*mlp))
    return gc + g, dw1, db1, dw2, db2, dwd, dbd, dwu, dbu, dwc, dbc


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
        dx, *dparams = resgroup_bwd(*ctx.saved_tensors[:3], g.contiguous(),
                                    *ctx.saved_tensors[3:], plain=ctx.plain)
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
