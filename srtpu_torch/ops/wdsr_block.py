"""K8c: srtpu's fused NHWC WDSR-B block (``use_pallas=True``), its
forward on the card, its backward by autograd through the plain version.

Replaces ``srtpu/ops/wdsr_block.py:wdsr_block_fused_fwd`` (body
``_wdsr_kernel``), behind ``wdsr_block_fused`` / ``_BlockB._fused``. The
kernel is ``srt_wdsr_block_fwd`` in ``csrc/wdsr.cu``: K7's chained 1x1
pair in its hi / lo form and the 3x3 on K2's engine; its head note says
what bounds it on the H100 and how it keeps the f32 activations on bf16
tensor cores. :func:`wdsr_block_fused_fwd` launches it for CUDA
tensors and takes the plain version only for CPU tensors; it counts its
calls in ``launches``. :func:`wdsr_block_fused` is the differentiable op
(:class:`WDSRFusedFn`).

One block, NHWC x (B, H, W, C) in the compute dtype, w1 (C, e), w2 (e,
L), w3 HWIO (3, 3, L, C) in x's dtype, f32 biases: a = relu(x w1 + b1)
and v = a w2 + b2 in f32, out = x.dtype((conv3x3(v, w3) + b3) * res_scale
+ x). The kernel wrapper pads L, and C where it is narrower than the
kernels' 64 or 128, with zeros (exact; ``ops.wdsr.widen``).

srtpu's backward (``_wb_bwd``) is ``jax.vjp`` of ``wdsr_block_reference``
in XLA; here autograd runs through :func:`wdsr_block_fused_plain` on the
saved x and cast weights, so dx and the weight grads come back rounded to
their dtypes (bf16 on the card), the bias grads f32, as srtpu's.
"""

from __future__ import annotations

import torch

from . import _build
from .conv import conv_f32
from .wdsr import _cast, _check, kernel_c, widen


def wdsr_block_fused_plain(x, w1, b1, w2, b2, w3, b3, res_scale: float
                           ) -> torch.Tensor:
    """Plain version of the kernel (srtpu ``wdsr_block_reference``): the
    two 1x1 products and the 3x3 in f32 from x's and the weights' values,
    one rounding of the block's output to x.dtype."""
    xf = x.float()
    a = (xf @ w1.float() + b1.float()).clamp_min(0.0)
    v = a @ w2.float() + b2.float()
    return (conv_f32(v, w3, b3) * res_scale + xf).to(x.dtype)


def wdsr_block_fused_fwd(x, w1, b1, w2, b2, w3, b3, res_scale: float
                         ) -> torch.Tensor:
    """As :func:`wdsr_block_fused_plain`. On CUDA: bf16 x (B, H, W, C), w1
    (C, e), w2 (e, L), w3 (3, 3, L, C); f32 b1, b2, b3; C a multiple of
    16 up to 128, e at most 6 C (ROADMAP.md F4), all run padded to the
    kernels' width (64 or 128; ``ops.wdsr.widen``). One call is two
    launches (the chained 1x1 pair writing v as bf16 hi and lo halves,
    then the 3x3 on K2's engine over both with the res_scale and skip
    epilogue). The registered operator ``srtpu::wdsr_block_fwd``
    (:mod:`._library`)."""
    op = (torch.ops.srtpu.wdsr_block_fwd.default
          if x.device.type in _build.OP_DEVICES else wdsr_block_fwd_cuda)
    return op(x, w1, b1, w2, b2, w3, b3, float(res_scale))


def wdsr_block_fwd_cuda(x, w1, b1, w2, b2, w3, b3, res_scale: float
                        ) -> torch.Tensor:
    """``srtpu::wdsr_block_fwd`` on CUDA: the checks, the padding to the
    kernels' width, one ``srt_wdsr_block_fwd`` call, the count."""
    _check('wdsr_block_fused_fwd', x, w1.shape[-1], w2.shape[-1])
    bsz, h, w, c_in = x.shape
    (x,), w1, b1, w2, b2, w3, b3 = widen(c_in, (x,), w1, b1, w2, b2, w3, b3)
    c = lp = kernel_c(c_in)
    e = 6 * c
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    _build.expect(x, 'x', bf16, (bsz, h, w, c), dev)
    _build.expect(w1, 'w1', bf16, (c, e), dev)
    _build.expect(w2, 'w2', bf16, (e, lp), dev)
    for name, t, n in (('b1', b1, e), ('b2', b2, lp), ('b3', b3, c)):
        _build.expect(t, name, f32, (n,), dev, aligned=False)
    w3cat = torch.cat((w3, w3), 2).contiguous()      # [W3; W3]: hi and lo
    _build.expect(w3cat, 'w3cat', bf16, (3, 3, 2 * lp, c), dev)
    vcat = torch.empty((bsz, h, w, 2 * lp), dtype=bf16, device=dev)
    out = torch.empty_like(x)
    with _build.on(dev):
        err = _build.library().srt_wdsr_block_fwd(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), w3cat.data_ptr(), b3.data_ptr(), float(res_scale),
            vcat.data_ptr(), out.data_ptr(), bsz, h, w, c, e, lp,
            _build.stream(dev))
    _build.check(err, 'srt_wdsr_block_fwd')
    wdsr_block_fused_fwd.launches += 1
    return out if c == c_in else out[..., :c_in].contiguous()


wdsr_block_fused_fwd.launches = 0


class WDSRFusedFn(torch.autograd.Function):
    """Differentiable K8c (srtpu ``wdsr_block_fused``): f32 (or any)
    parameters in, cast to x's dtype (the biases to f32) inside; saves x
    and the cast weights; the backward recomputes the block in the plain
    version under autograd. Grads come back in the parameters' dtypes,
    holding the cast weights' rounding."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, w3, b3, res_scale: float,
                plain: bool):
        ops = _cast(x, w1, b1, w2, b2, w3, b3)
        ctx.save_for_backward(x, *ops)
        ctx.res_scale = res_scale
        ctx.dtypes = tuple(t.dtype for t in (w1, b1, w2, b2, w3, b3))
        return (wdsr_block_fused_plain if plain else wdsr_block_fused_fwd)(
            x, *ops, res_scale)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = wdsr_block_fused_plain(*leaves, ctx.res_scale)
        dx, *dws = torch.autograd.grad(out, leaves, g)
        return (dx, *(t.to(d) for t, d in zip(dws, ctx.dtypes)), None, None)


def wdsr_block_fused(x, w1, b1, w2, b2, w3, b3, res_scale: float = 1.0,
                     plain: bool = False) -> torch.Tensor:
    """One WDSR-B block on srtpu's fused NHWC route in x's dtype from f32
    (or any) weights: w1 (C, e), b1 (e,), w2 (e, L), b2 (L,), w3 (3, 3, L,
    C), b3 (C,). The autograd op when a gradient is wanted, else the
    forward alone. ``plain`` runs the plain version on any device."""
    x = x.contiguous()
    params = (w1, b1, w2, b2, w3, b3)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        return WDSRFusedFn.apply(x, *params, res_scale, plain)
    return (wdsr_block_fused_plain if plain else wdsr_block_fused_fwd)(
        x, *_cast(x, *params), res_scale)
