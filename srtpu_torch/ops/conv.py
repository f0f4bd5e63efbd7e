"""K2: 3x3 (and 5x5) SAME conv + bias, NHWC bf16 -> bf16, f32 sums, and
its backward, at any channel counts that are multiples of 16.

Replaces ``srtpu/ops/cs_conv.py:conv3x3_cs_fwd`` and ``conv3x3_cs_bwd``
(behind ``conv3x3_cs`` / ``conv3x3_cs_pre``). The forward kernel is
``csrc/conv.cu``, whose head note says what bounds it on the H100 and
how its design answers that; the backward's dx is the same kernel with
the transposed weight and no bias, its dW and db the weight-grad kernel
(:mod:`.wgrad`). :func:`conv3x3_fwd` and :func:`conv3x3_bwd` launch the
kernels for CUDA tensors and take the plain versions only for CPU
tensors. Each counts its launches per kernel size and path:
``launches`` at 3x3 and ``launches_5x5`` at 5x5 (SRResNet's phase-dense
final conv) on the instances of their own, ``launches_general`` and
``launches_general_5x5`` on the general path (DDBPN, the x3 tails).
:func:`conv3x3` is the differentiable op (:class:`Conv3x3Fn`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .layout import w_t
from .wgrad import conv_wgrad, conv_wgrad_plain


def conv_f32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None
             ) -> torch.Tensor:
    """kxk SAME conv of NHWC ``x`` with HWIO ``w`` (plus ``b``), in f32
    with no rounding (the kernels' accumulator, before the bf16 store)."""
    y = F.conv2d(x.permute(0, 3, 1, 2).float(),
                 w.permute(3, 2, 0, 1).float(), padding=w.shape[0] // 2)
    y = y.permute(0, 2, 3, 1)
    return y if b is None else y + b.float()


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  relu: bool = False) -> torch.Tensor:
    """Plain version of the kernel: f32 conv + bias (+ ReLU), one rounding
    to ``x.dtype``."""
    y = conv_f32(x, w, b)
    if relu:
        y = y.clamp_min(0.0)
    return y.to(x.dtype).contiguous()


def conv3x3_bwd_plain(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward, rounding where ``_conv_bwd_kernel`` does: dx = one
    rounding to x.dtype of the f32 transposed conv of g; dW = sum over
    pixels of x (x) g in f32 (HWIO, 3x3 or 5x5 as w); db = sum of g in
    f32."""
    dx = conv_f32(g, w_t(w)).to(x.dtype).contiguous()
    return (dx, *conv_wgrad_plain(x, g, k=w.shape[0]))


def _own_instance(cin: int, cout: int, k: int) -> bool:
    """The EDSR, SRResNet and RDN shapes, on instances of their own (as
    ``csrc/conv.cu`` dispatches them)."""
    if k == 5:
        return (cin == 256 and cout % 16 == 0) or (cin == 16
                                                   and cout % 64 == 0)
    return k == 3 and ((cin in (16, 64) and cout % 64 == 0)
                       or (cin == 256 and cout % 16 == 0))


def _engine_takes(cin: int, cout: int, k: int) -> bool:
    """K2 takes a k = 3 or 5 conv whose cin and cout are multiples of 16:
    :func:`_own_instance`'s shapes, and every other on the general path
    (``csrc/conv.cu`` through ``csrc/tile_conv.cuh``'s
    conv_chunked_kernel)."""
    return k in (3, 5) and cin % 16 == 0 and cout % 16 == 0


def _launch(x, w, b, relu: bool, name: str) -> torch.Tensor:
    """Check x (B, H, W, Cin) bf16, w (k, k, Cin, Cout) bf16 and b (Cout,)
    f32 or None, and launch K2 (k = 3 or 5) into a new output."""
    if x.device.type != 'cuda':
        raise ValueError(f'{name}: no kernel for device {x.device}')
    bsz, h, wd, cin = x.shape
    k, cout = w.shape[0], w.shape[-1]
    if not _engine_takes(cin, cout, k):
        raise ValueError(f'{name}: no kernel for {k}x{k} {cin} -> {cout} '
                         f'channels')
    dev = x.device
    _build.expect(x, 'x', torch.bfloat16, (bsz, h, wd, cin), dev)
    _build.expect(w, 'w', torch.bfloat16, (k, k, cin, cout), dev)
    if b is not None:
        _build.expect(b, 'b', torch.float32, (cout,), dev)
    out = torch.empty((bsz, h, wd, cout), dtype=torch.bfloat16, device=dev)
    entry = 'srt_conv5x5_fwd' if k == 5 else 'srt_conv3x3_fwd'
    with torch.cuda.device(dev):
        err = getattr(_build.library(), entry)(
            x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(), bsz, h, wd, cin, cout, int(relu),
            _build.stream(dev))
    _build.check(err, entry)
    return out


def _count(fn, w: torch.Tensor) -> None:
    """One launch of ``fn``'s kernel at ``w``'s (the launched weight's)
    size and path."""
    k, cin, cout = w.shape[0], w.shape[-2], w.shape[-1]
    attr = 'launches' if _own_instance(cin, cout, k) else 'launches_general'
    attr += '_5x5' if k == 5 else ''
    setattr(fn, attr, getattr(fn, attr) + 1)


def conv3x3_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                relu: bool = False) -> torch.Tensor:
    """x (B, H, W, Cin) bf16; w (k, k, Cin, Cout) bf16; b (Cout,) f32 ->
    (B, H, W, Cout) bf16. On CUDA, k = 3 or 5 with Cin and Cout multiples
    of 16: the EDSR tail's 64 -> 64, 64 -> 256, 256 -> 16 and SRResNet's
    5x5 256 -> 16 on their own instances; DDBPN's projections (x4: 32 ->
    512, 512 -> 32; x2: 32 -> 128, 128 -> 32), its output convs (512 ->
    48, 128 -> 16) and the x3 tails' phase-dense 576 -> 32 (3x3 and 5x5)
    on the general path."""
    if x.device.type == 'cpu':
        return conv3x3_plain(x, w, b, relu)
    out = _launch(x, w, b, relu, 'conv3x3_fwd')
    _count(conv3x3_fwd, w)
    return out


def conv3x3_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, H, W, Cin) bf16; w (k, k, Cin, Cout) bf16; g (B, H, W, Cout)
    bf16 -> dx bf16, dW (k, k, Cin, Cout) f32, db (Cout,) f32. On CUDA at
    every shape :func:`conv3x3_fwd` takes: dx is the forward kernel on
    the transposed weight (DDBPN x4's 512 -> 32, 32 -> 512, 48 -> 512;
    x2's 128 -> 32, 32 -> 128, 16 -> 128; the x3 tails' 32 -> 576), dW
    and db the weight-grad kernel at (Cin, Cout)."""
    if x.device.type == 'cpu':
        return conv3x3_bwd_plain(x, w, g)
    if x.device.type != 'cuda':
        raise ValueError(f'conv3x3_bwd: no kernel for device {x.device}')
    bsz, h, wd, cin = x.shape
    k, cout = w.shape[0], w.shape[-1]
    if not _engine_takes(cout, cin, k):
        raise ValueError(f'conv3x3_bwd: no kernel for {k}x{k} {cin} -> '
                         f'{cout} channels')
    dev = x.device
    _build.expect(x, 'x', torch.bfloat16, (bsz, h, wd, cin), dev)
    _build.expect(g, 'g', torch.bfloat16, (bsz, h, wd, cout), dev)
    wt = w_t(w).contiguous()
    dx = _launch(g, wt, None, False, 'conv3x3_bwd')
    _count(conv3x3_bwd, wt)
    return (dx, *conv_wgrad(x, g, k=k))


for _fn in (conv3x3_fwd, conv3x3_bwd):
    _fn.launches = _fn.launches_5x5 = 0
    _fn.launches_general = _fn.launches_general_5x5 = 0


class Conv3x3Fn(torch.autograd.Function):
    """Differentiable K2 (srtpu ``conv3x3_cs``): takes the f32 weight and
    bias, casts the weight to x's dtype inside, saves (x, weight) and
    returns dW and db in f32."""

    @staticmethod
    def forward(ctx, x, w, b, plain: bool):
        wd = w.to(x.dtype).contiguous()
        y = (conv3x3_plain if plain else conv3x3_fwd)(
            x, wd, b.float().contiguous())
        ctx.save_for_backward(x, wd)
        ctx.plain = plain
        ctx.dtypes = (w.dtype, b.dtype)
        return y

    @staticmethod
    def backward(ctx, g):
        x, wd = ctx.saved_tensors
        dx, dw, db = (conv3x3_bwd_plain if ctx.plain else conv3x3_bwd)(
            x, wd, g.contiguous())
        return dx, dw.to(ctx.dtypes[0]), db.to(ctx.dtypes[1]), None


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
            plain: bool = False) -> torch.Tensor:
    """3x3 (or 5x5, as w) SAME conv + bias in x's dtype from f32 (or any)
    parameters:
    the autograd op when a gradient is wanted, else the forward alone.
    ``plain`` runs the plain versions on any device."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or b.requires_grad):
        return Conv3x3Fn.apply(x, w, b, plain)
    return (conv3x3_plain if plain else conv3x3_fwd)(
        x, w.to(x.dtype).contiguous(), b.float().contiguous())
