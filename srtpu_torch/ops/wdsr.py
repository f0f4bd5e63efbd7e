"""K7: WDSR-B's wide-activation block, forward and backward.

Replaces ``srtpu/ops/wdsr_cs.py:_fwd_call`` (body ``_fwd_kernel``) and
``_bwd_call`` (``_bwd_kernel``), behind ``wdsr_block_cs``. The kernels
are ``csrc/wdsr.cu``, whose head note says what bounds them on the H100
and how the 6C-wide h1 stays out of device memory in both directions.
:func:`wdsr_fwd` and :func:`wdsr_bwd` launch them for CUDA tensors and
take the plain versions only for CPU tensors; each counts its calls in
``launches``. :func:`wdsr_block` is the differentiable op
(:class:`WDSRBlockFn`).

One block, NHWC x (B, H, W, C), in the compute dtype (bf16 on the card):
h1 = relu(x W1 + b1) (C -> e = 6C), h2 = h1 W2 + b2 (e -> Lp), out =
(conv3x3(h2; W3) + b3) * res_scale + x. The kernels' weights: w1 (C, e),
w2 (e, Lp), w3 HWIO (3, 3, Lp, C) in x's dtype, biases f32, with the
bottleneck width L = int(0.8 C) zero-padded to the 16-multiple Lp
(:func:`wdsr_lp`; padded rows carry zero weights and bias, so results
are exact). :func:`wdsr_block` takes the unpadded f32 weights (w2 (e,
L), w3 (3, 3, L, C)) and pads inside, as srtpu/models/wdsr.py:91-95
does; autograd slices the padding off the gradients.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .conv import conv_f32
from .layout import w_t
from .wgrad import conv_wgrad_plain, wgrad_launch

P_TILE = 128            # pixels per tile of the 1x1 kernels
E_CHUNK = 96            # expanded channels per chunk (e = 6C divides)
MAX_C = 128             # the kernels' widest C and Lp (8 wmma tiles)
TARGET_BLOCKS = 132     # the backward's blocks: one per SM of the H100


def wdsr_lp(n_feats: int, linear: float = 0.8) -> tuple[int, int]:
    """(L, Lp): the bottleneck width and its 16-multiple padding
    (srtpu/ops/wdsr_cs.py:wdsr_lp)."""
    lv = int(n_feats * linear)
    return lv, (lv + 15) // 16 * 16


def _recompute(x, w1, b1, w2, b2):
    """h1 and h2 in x's dtype, each rounded once from f32 sums."""
    dt = x.dtype
    h1 = (x.float() @ w1.float() + b1.float()).clamp_min(0.0).to(dt)
    return h1, (h1.float() @ w2.float() + b2.float()).to(dt)


def wdsr_fwd_plain(x, w1, b1, w2, b2, w3, b3, res_scale: float):
    """Plain forward, rounding where ``_fwd_kernel`` does: h1 and h2 once
    each, out = x.dtype((conv3x3(h2) + b3) * res_scale + x) once."""
    _, h2 = _recompute(x, w1, b1, w2, b2)
    return (conv_f32(h2, w3, b3) * res_scale + x.float()).to(x.dtype) \
        .contiguous()


def wdsr_bwd_plain(x, g, w1, b1, w2, b2, w3, res_scale: float):
    """Plain backward, rounding where ``_bwd_kernel`` does: recompute h1,
    h2; gs = bf16(g * res_scale), dh2 = convT(gs) in f32, db2 = sum dh2,
    dh2b = bf16(dh2); dh1 = [h1 > 0] dh2b W2^T in f32, db1 = sum dh1,
    dh1b = bf16(dh1); dW2 = h1^T dh2b, dW1 = x^T dh1b; dW3, db3 the weight
    grads of the 3x3 on (h2, gs); dx = bf16(g + dh1b W1^T). Returns dx and
    the f32 grads (dw1 (C, e), db1, dw2 (e, Lp), db2, dw3 (3, 3, Lp, C),
    db3)."""
    dt = x.dtype
    h1, h2 = _recompute(x, w1, b1, w2, b2)
    gs = (g.float() * res_scale).to(dt)
    dh2 = conv_f32(gs, w_t(w3))
    dw3, db3 = conv_wgrad_plain(h2, g, gscale=res_scale)
    dh2b = dh2.to(dt).float()
    dh1 = torch.where(h1.float() > 0, dh2b @ w2.float().t(), 0.0)
    dh1b = dh1.to(dt).float()
    c, e, lp = x.shape[-1], h1.shape[-1], h2.shape[-1]
    dw2 = h1.float().reshape(-1, e).t() @ dh2b.reshape(-1, lp)
    dw1 = x.float().reshape(-1, c).t() @ dh1b.reshape(-1, e)
    dx = (g.float() + dh1b @ w1.float().t()).to(dt).contiguous()
    return (dx, dw1, dh1.sum((0, 1, 2)), dw2, dh2.sum((0, 1, 2)), dw3, db3)


def _check(name: str, x, w1, w2):
    """Raise unless the kernels take this block: C a multiple of 16 up to
    MAX_C, e a multiple of E_CHUNK, Lp a multiple of 16 up to MAX_C, on a
    CUDA tensor."""
    c, e, lp = x.shape[-1], w1.shape[-1], w2.shape[-1]
    if c % 16 or c > MAX_C or e % E_CHUNK or lp % 16 or lp > MAX_C:
        raise ValueError(f'{name}: no kernel for C={c}, e={e}, Lp={lp} (C '
                         f'and Lp multiples of 16 up to {MAX_C}, e of '
                         f'{E_CHUNK}; ROADMAP.md F4)')
    if x.device.type != 'cuda':
        raise ValueError(f'{name}: no kernel for device {x.device}')


def _expect(x, w1, b1, w2, b2, w3):
    bsz, h, w, c = x.shape
    e, lp = w1.shape[-1], w2.shape[-1]
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    _build.expect(x, 'x', bf16, (bsz, h, w, c), dev)
    _build.expect(w1, 'w1', bf16, (c, e), dev)
    _build.expect(b1, 'b1', f32, (e,), dev, aligned=False)
    _build.expect(w2, 'w2', bf16, (e, lp), dev)
    _build.expect(b2, 'b2', f32, (lp,), dev, aligned=False)
    _build.expect(w3, 'w3', bf16, (3, 3, lp, c), dev)
    return bsz, h, w, c, e, lp


def wdsr_fwd(x, w1, b1, w2, b2, w3, b3, res_scale: float):
    """As :func:`wdsr_fwd_plain`. On CUDA: bf16 x (B, H, W, C), w1 (C,
    e), w2 (e, Lp), w3 (3, 3, Lp, C); f32 b1, b2, b3. One call is two
    launches (the fused 1x1 pair writing h2, then the 3x3 with the
    ``res_scale`` and skip epilogue)."""
    if x.device.type == 'cpu':
        return wdsr_fwd_plain(x, w1, b1, w2, b2, w3, b3, res_scale)
    _check('wdsr_fwd', x, w1, w2)
    bsz, h, w, c, e, lp = _expect(x, w1, b1, w2, b2, w3)
    _build.expect(b3, 'b3', torch.float32, (c,), x.device, aligned=False)
    h2 = torch.empty((bsz, h, w, lp), dtype=torch.bfloat16, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _build.library().srt_wdsr_fwd(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), w3.data_ptr(), b3.data_ptr(), float(res_scale),
            h2.data_ptr(), out.data_ptr(), bsz, h, w, c, e, lp,
            _build.stream(x.device))
    _build.check(err, 'srt_wdsr_fwd')
    wdsr_fwd.launches += 1
    return out


def wdsr_bwd(x, g, w1, b1, w2, b2, w3, res_scale: float):
    """As :func:`wdsr_bwd_plain`. On CUDA, at the widths :func:`wdsr_fwd`
    takes: one call is six launches (h2 recomputed, dh2, the fused
    pointwise backward, its fixed-order reduction, and dW3 / db3 through
    the weight-grad kernel with a second reduction), counted once here
    and not on the weight-grad kernel's counters."""
    if x.device.type == 'cpu':
        return wdsr_bwd_plain(x, g, w1, b1, w2, b2, w3, res_scale)
    _check('wdsr_bwd', x, w1, w2)
    bsz, h, w, c, e, lp = _expect(x, w1, b1, w2, b2, w3)
    dev = x.device
    _build.expect(g, 'g', torch.bfloat16, x.shape, dev)
    ntiles = -(-bsz * h * w // P_TILE)
    nparts = min(ntiles, TARGET_BLOCKS)
    wsz = c * e + e * lp + e + lp
    f32 = dict(dtype=torch.float32, device=dev)
    h2 = torch.empty((bsz, h, w, lp), dtype=torch.bfloat16, device=dev)
    dh2 = torch.empty((bsz, h, w, lp), **f32)
    ws = torch.empty((nparts, wsz), **f32)
    red = torch.empty((wsz,), **f32)
    dx = torch.empty_like(x)
    w3t = w_t(w3).contiguous()
    with torch.cuda.device(dev):
        err = _build.library().srt_wdsr_bwd(
            x.data_ptr(), g.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), w3t.data_ptr(),
            float(res_scale), h2.data_ptr(), dh2.data_ptr(), ws.data_ptr(),
            red.data_ptr(), dx.data_ptr(), bsz, h, w, c, e, lp, nparts,
            _build.stream(dev))
    _build.check(err, 'srt_wdsr_bwd')
    dw3, db3 = wgrad_launch(h2, g, gscale=res_scale)
    wdsr_bwd.launches += 1
    dw1, dw2, db1, db2 = red.split((c * e, e * lp, e, lp))
    return (dx, dw1.view(c, e), db1, dw2.view(e, lp), db2, dw3, db3)


wdsr_fwd.launches = 0
wdsr_bwd.launches = 0


class WDSRBlockFn(torch.autograd.Function):
    """Differentiable K7 (srtpu ``wdsr_block_cs``) on padded weights: f32
    (or any) parameters in, cast to x's dtype (the biases to f32) inside;
    saves x and the cast weights, nothing of the forward's activations;
    returns the grads in the parameters' dtypes."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, w3, b3, res_scale: float,
                plain: bool):
        ops = _cast(x, w1, b1, w2, b2, w3, b3)
        out = (wdsr_fwd_plain if plain else wdsr_fwd)(x, *ops, res_scale)
        ctx.save_for_backward(x, *ops[:5])
        ctx.res_scale, ctx.plain = res_scale, plain
        ctx.dtypes = tuple(t.dtype for t in (w1, b1, w2, b2, w3, b3))
        return out

    @staticmethod
    def backward(ctx, g):
        x, *ops = ctx.saved_tensors
        grads = (wdsr_bwd_plain if ctx.plain else wdsr_bwd)(
            x, g.contiguous(), *ops, ctx.res_scale)
        return (grads[0], *(t.to(d) for t, d in zip(grads[1:], ctx.dtypes)),
                None, None)


def _cast(x, w1, b1, w2, b2, w3, b3):
    """The kernels' operands: weights in x's dtype, biases f32."""
    dt = x.dtype
    return (w1.to(dt).contiguous(), b1.float().contiguous(),
            w2.to(dt).contiguous(), b2.float().contiguous(),
            w3.to(dt).contiguous(), b3.float().contiguous())


def wdsr_block(x, w1, b1, w2, b2, w3, b3, res_scale: float = 1.0,
               plain: bool = False) -> torch.Tensor:
    """One WDSR-B block in x's dtype from f32 (or any) weights: w1 (C, e),
    b1 (e,), w2 (e, L), b2 (L,), w3 (3, 3, L, C), b3 (C,). L is
    zero-padded to :func:`wdsr_lp`'s Lp here. The autograd op when a
    gradient is wanted, else the forward alone. ``plain`` runs the plain
    versions on any device."""
    pad = -w2.shape[-1] % 16
    w2, b2 = F.pad(w2, (0, pad)), F.pad(b2, (0, pad))
    w3 = F.pad(w3, (0, 0, 0, pad))
    x = x.contiguous()
    params = (w1, b1, w2, b2, w3, b3)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        return WDSRBlockFn.apply(x, *params, res_scale, plain)
    return (wdsr_fwd_plain if plain else wdsr_fwd)(
        x, *_cast(x, *params), res_scale)
