"""K8b: srtpu's fused channel-attention gate (RCAN's ``CALayer`` on its
``use_pallas=True`` route), its forward on the card, its backward by
autograd through the plain version.

Replaces ``srtpu/ops/ca_layer.py:ca_layer_fused`` (body ``_ca_kernel``),
behind ``ca_layer_fused_trainable``. The kernel is ``csrc/ca_layer.cu``,
whose head note says what bounds it on the H100: two launches, the
partial sums and then the gating, over blocks of :func:`block_pixels`
pixels. :func:`ca_layer_fwd` launches it
for CUDA tensors and takes the plain version only for CPU tensors; it
counts its calls in ``launches``. :func:`ca_gate` is the differentiable
op (:class:`CALayerFn`).

x (B, H, W, C) in the compute dtype; f32 w1 (C, C/r), b1 (C/r,), w2
(C/r, C), b2 (C,) (srtpu does not cast them): per image pool = mean over
H W of f32(x), gate = sigmoid(relu(pool w1 + b1) w2 + b2), out =
x.dtype(f32(x) * gate).

srtpu's backward (``_ca_bwd``) is ``jax.vjp`` of ``ca_layer_reference``
in XLA; here autograd runs through :func:`ca_layer_plain` on the saved x,
whose two reads of x (the pool and the gating) each round their f32
cotangent to x's dtype, as srtpu's two ``astype`` calls do. The weight
grads stay f32.
"""

from __future__ import annotations

import torch

from . import _build

# Pixels a block: K_PIX, or more where an image would give more than
# MAX_SPLITS blocks (each block of the second launch adds all of its
# image's partials; measured on the H100 at 1 x 512 x 352: 256 blocks an
# image 0.040 device-ms, 128 0.053).
K_PIX, MAX_SPLITS = 128, 256
# the partial sums, one buffer per (device, stream, size), kept from call
# to call (a stream's calls run in order, so they never share it at once)
_SCRATCH: dict = {}


def block_pixels(h: int, w: int) -> int:
    """Pixels a block of K8b's two launches for an h x w image, as
    ca_layer.cu takes them."""
    return max(K_PIX, -(-h * w // MAX_SPLITS))


def ca_layer_plain(x, w1, b1, w2, b2) -> torch.Tensor:
    """Plain version of the kernel (srtpu ``ca_layer_reference``): f32
    pool, MLP and sigmoid, one rounding of the gated x to x.dtype."""
    pooled = x.float().mean((1, 2))
    hidden = (pooled @ w1.float() + b1.float()).clamp_min(0.0)
    gate = torch.sigmoid(hidden @ w2.float() + b2.float())
    return (x.float() * gate[:, None, None, :]).to(x.dtype)


def ca_layer_fwd(x, w1, b1, w2, b2) -> torch.Tensor:
    """As :func:`ca_layer_plain`. On CUDA: bf16 x (B, H, W, C) with C a
    multiple of 8, f32 w1 (C, C/r), b1, w2 (C/r, C), b2; two launches,
    counted once. The registered operator ``srtpu::ca_layer_fwd``
    (:mod:`._library`)."""
    if x.device.type not in _build.OP_DEVICES:
        return ca_layer_fwd_cuda(x, w1, b1, w2, b2)
    return torch.ops.srtpu.ca_layer_fwd.default(x, w1, b1, w2, b2)


def ca_layer_fwd_cuda(x, w1, b1, w2, b2) -> torch.Tensor:
    """``srtpu::ca_layer_fwd`` on CUDA: the checks, the scratch kept per
    stream, one ``srt_ca_layer_fwd`` call, the count."""
    bsz, h, w, c = x.shape
    cr = w1.shape[-1]
    if c % 8:
        raise ValueError(f'ca_layer_fwd: no kernel for C={c} (K8b takes a '
                         f'multiple of 8; ROADMAP.md F4)')
    if x.device.type != 'cuda':
        raise ValueError(f'ca_layer_fwd: no kernel for device {x.device}')
    dev, f32 = x.device, torch.float32
    _build.expect(x, 'x', torch.bfloat16, (bsz, h, w, c), dev)
    for name, t, shape in (('w1', w1, (c, cr)), ('b1', b1, (cr,)),
                           ('w2', w2, (cr, c)), ('b2', b2, (c,))):
        _build.expect(t, name, f32, shape, dev, aligned=False)
    kpix, stream = block_pixels(h, w), _build.stream(dev)
    size = bsz * -(-h * w // kpix) * c
    if torch.cuda.is_current_stream_capturing():
        # a buffer of the CUDA graph's own pool, not one shared with eager
        # calls
        scratch = torch.empty((size,), dtype=f32, device=dev)
    else:
        key = (dev, stream, size)
        scratch = _SCRATCH.get(key)
        if scratch is None:
            scratch = _SCRATCH[key] = torch.empty((size,), dtype=f32,
                                                  device=dev)
    out = torch.empty_like(x)
    with _build.on(dev):
        err = _build.library().srt_ca_layer_fwd(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), scratch.data_ptr(), out.data_ptr(), bsz, h * w,
            c, cr, kpix, stream)
    _build.check(err, 'srt_ca_layer_fwd')
    ca_layer_fwd.launches += 1
    return out


ca_layer_fwd.launches = 0


def _operands(w1, b1, w2, b2):
    return tuple(t.float().contiguous() for t in (w1, b1, w2, b2))


class CALayerFn(torch.autograd.Function):
    """Differentiable K8b (srtpu ``ca_layer_fused_trainable``): saves x and
    the f32 weights; the backward is autograd through
    :func:`ca_layer_plain`, grads in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, plain: bool):
        ops = _operands(w1, b1, w2, b2)
        ctx.save_for_backward(x, *ops)
        ctx.dtypes = tuple(t.dtype for t in (w1, b1, w2, b2))
        return (ca_layer_plain if plain else ca_layer_fwd)(x, *ops)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ca_layer_plain(*leaves)
        dx, *dws = torch.autograd.grad(out, leaves, g)
        return (dx, *(t.to(d) for t, d in zip(dws, ctx.dtypes)), None)


def ca_gate(x, w1, b1, w2, b2, plain: bool = False) -> torch.Tensor:
    """The channel-attention gate in x's dtype: the autograd op when a
    gradient is wanted, else the forward alone. ``plain`` runs the plain
    version on any device."""
    x = x.contiguous()
    params = (w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        return CALayerFn.apply(x, *params, plain)
    return (ca_layer_plain if plain else ca_layer_fwd)(x, *_operands(*params))
