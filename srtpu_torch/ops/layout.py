"""Weight and activation rearrangements of the EDSR path, NHWC/HWIO.

Counterparts of the layout helpers in ``srtpu/ops/cs_conv.py``. The TPU
package stores its weights in the channel-sublane (CS) arrangement; the
port runs NHWC activations and HWIO weights, so it needs only:

* the CS -> HWIO unstacking of stored JAX weights (``w_hwio_from_cs``,
  ``w_ps_hwio``), used by :mod:`srtpu_torch.convert`;
* the math rewrites of the upscale tail, which are not layout: the last
  upscale conv with phase-major output channels (``w_pm_hwio``,
  ``b_pm``), the fine final conv recast as a coarse "phase-dense" conv
  over those channels (``w_phase_dense``), and the final phase-major ->
  NHWC rearrangement (``pm_to_nhwc``);
* REFLECT boundaries (SRGAN's convs): the reflect pad of NCHW
  activations as mirrored slices (``reflect_pad``) and its adjoint
  (``reflect_fold``), each adding a pixel's mirrored terms in a fixed
  order where the stock pad's CUDA backward uses atomics;
* for the backward passes: the transposed conv weight (``w_t``), the
  fine cotangent read phase-major (``pm_from_fine``, the work of
  ``_ups_deint_kernel``) and the inverses of ``w_pm_hwio`` / ``b_pm``
  that return the upscale grads in stored PixelShuffle order.

Phase-major channel order is ``(a * r + b) * C + c`` for output pixel
``(r * y + a, r * x + b)``; torch's PixelShuffle order is
``c * r * r + a * r + b``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def w_hwio_from_cs(w_csd: torch.Tensor, c_in: int, c_out: int,
                   kk: int = 3) -> torch.Tensor:
    """(L, kk*C', kk*C) CS arrangement [(dy, c_out), (dx, c_in)] ->
    (L, kk, kk, C, C') HWIO stack (cs_conv.py:w_hwio_from_cs)."""
    n = w_csd.shape[0]
    return w_csd.reshape(n, kk, c_out, kk, c_in).permute(0, 1, 3, 4, 2)


def w_ps_hwio(w_arr: torch.Tensor, c: int, r: int) -> torch.Tensor:
    """(r*r, 3C, 3C) phase-major CS stacks -> HWIO (3, 3, C, r*r*C) in
    torch PixelShuffle channel order (cs_conv.py:w_ps_hwio)."""
    v = w_arr.reshape(r, r, 3, c, 3, c)          # a, b, dy, c', dx, cin
    return v.permute(2, 4, 5, 3, 0, 1).reshape(3, 3, c, c * r * r)


def w_pm_hwio(w_hwio: torch.Tensor, r: int) -> torch.Tensor:
    """HWIO (k, k, C, r*r*C') in torch PixelShuffle order -> the same conv
    with phase-major output channels (cs_conv.py:w_pm_hwio, which starts
    from the CS stacks)."""
    kh, kw, c_in, c_out = w_hwio.shape
    c = c_out // (r * r)
    return w_hwio.reshape(kh, kw, c_in, c, r * r).transpose(3, 4) \
        .reshape(kh, kw, c_in, c_out)


def b_pm(b: torch.Tensor, r: int) -> torch.Tensor:
    """(r*r*C,) bias in PixelShuffle order -> phase-major order."""
    return b.reshape(-1, r * r).t().reshape(-1)


def w_ps_from_pm(w_pm: torch.Tensor, r: int) -> torch.Tensor:
    """Inverse of :func:`w_pm_hwio`: phase-major output channels back to
    PixelShuffle order."""
    kh, kw, c_in, c_out = w_pm.shape
    return w_pm.reshape(kh, kw, c_in, r * r, c_out // (r * r)) \
        .transpose(3, 4).reshape(kh, kw, c_in, c_out)


def b_ps_from_pm(b: torch.Tensor, r: int) -> torch.Tensor:
    """Inverse of :func:`b_pm`."""
    return b.reshape(r * r, -1).t().reshape(-1)


def w_t(w: torch.Tensor) -> torch.Tensor:
    """HWIO (..., k, k, Cin, Cout) -> the transposed conv's weight
    (..., k, k, Cout, Cin) with w_t[ky, kx, co, ci] = w[k-1-ky, k-1-kx,
    ci, co]: conv(g, w_t(w)) is the gradient of conv(x, w) w.r.t. x."""
    return w.flip(-4, -3).transpose(-2, -1)


def pm_from_fine(y: torch.Tensor, r: int) -> torch.Tensor:
    """Fine NHWC (B, r*H, r*W, C) -> its phase-major coarse view (B, H, W,
    r*r*C): the inverse of :func:`pm_to_nhwc`, exact (a permutation)."""
    bsz, fh, fw, c = y.shape
    h, w = fh // r, fw // r
    return y.reshape(bsz, h, r, w, r, c).permute(0, 1, 3, 2, 4, 5) \
        .reshape(bsz, h, w, r * r * c)


def phase_dense_ck(fk: int, r: int) -> int:
    """Coarse tap span of :func:`w_phase_dense` for a fine fk x fk conv
    (cs_conv.py:phase_dense_ck): 3 for fk=3."""
    hw = fk // 2
    lo = -(hw // r) - (1 if hw % r else 0)       # floor(-hw / r)
    return (r - 1 + hw) // r - lo + 1


def w_phase_dense(w_hwio: torch.Tensor, r: int) -> torch.Tensor:
    """Fine fk x fk conv HWIO (fk, fk, Cin, ch) -> coarse conv HWIO
    (ck, ck, r*r*Cin, CO) reading and writing phase-major channel blocks
    (cs_conv.py:w_phase_dense). A fine tap at offset (u - fk//2) from
    fine position r*y + a lands on phase (a + u - fk//2) % r at coarse
    offset floor((a + u - fk//2) / r). CO pads r*r*ch up to a multiple
    of 16 with zero columns (the kernel's output tile width).

    Along each axis the pair (coarse tap ky, input phase p) is one index
    t = r*ky + p, and output phase a's tap u sits at t = u + a - fk//2 -
    r*lo: so each output phase's block is w zero-padded by that shift,
    a handful of ops (and one autograd node each) whatever fk is."""
    fk, _, cin, ch = w_hwio.shape
    hw = fk // 2
    lo = -(hw // r) - (1 if hw % r else 0)
    ck = phase_dense_ck(fk, r)
    co = -(-r * r * ch // 16) * 16
    n = r * ck
    blocks = []
    for a in range(r):
        for b in range(r):
            oy, ox = a - hw - r * lo, b - hw - r * lo
            blocks.append(F.pad(w_hwio, (0, 0, 0, 0, ox, n - fk - ox,
                                         oy, n - fk - oy)))
    wpd = torch.stack(blocks, -2)                   # (n, n, cin, r*r, ch)
    wpd = wpd.reshape(ck, r, ck, r, cin, r * r * ch).permute(0, 2, 1, 3, 4, 5)
    return F.pad(wpd.reshape(ck, ck, r * r * cin, r * r * ch),
                 (0, co - r * r * ch))


def b_phase_dense(b: torch.Tensor, r: int, co: int) -> torch.Tensor:
    """Final-conv bias (ch,) -> the phase-dense conv's (co,) bias."""
    return torch.cat([b.repeat(r * r), b.new_zeros(co - r * r * b.shape[0])])


def pm_to_nhwc(y_pm: torch.Tensor, r: int, ch: int) -> torch.Tensor:
    """Phase-major coarse NHWC (B, H, W, >= r*r*ch) -> fine NHWC
    (B, r*H, r*W, ch); channels past r*r*ch are alignment padding
    (cs_conv.py:pm_to_nhwc)."""
    bsz, h, w, _ = y_pm.shape
    y = y_pm[..., :r * r * ch].reshape(bsz, h, w, r, r, ch)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(bsz, h * r, w * r, ch)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC (B, H, W, C*r*r) -> (B, H*r, W*r, C), torch PixelShuffle
    channel order c*r*r + a*r + b (srtpu/models/common.py:pixel_shuffle)."""
    bsz, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(bsz, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(bsz, h * r, w * r, c)


def reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """``F.pad(x, (p, p, p, p), mode='reflect')`` of NCHW x (H, W > p),
    built from mirrored slices: the same values, and an autograd backward
    that adds a pixel's mirrored gradients in a fixed order (the stock
    pad's CUDA backward adds them with atomics, in an order that changes
    from call to call)."""
    x = torch.cat((x[..., 1:p + 1].flip(-1), x, x[..., -p - 1:-1].flip(-1)),
                  -1)
    return torch.cat((x[..., 1:p + 1, :].flip(-2), x,
                      x[..., -p - 1:-1, :].flip(-2)), -2)


def reflect_fold(g: torch.Tensor, p: int) -> torch.Tensor:
    """The adjoint of :func:`reflect_pad`: g (N, C, H + 2p, W + 2p) to
    (N, C, H, W), each pad pixel's value added to the pixel it mirrors,
    columns first, then rows, in a fixed order."""
    g = g.clone()
    h, w = g.shape[-2] - 2 * p, g.shape[-1] - 2 * p
    for k in range(1, p + 1):
        g[..., p + k] += g[..., p - k]
        g[..., p + w - 1 - k] += g[..., p + w - 1 + k]
    for k in range(1, p + 1):
        g[..., p + k, :] += g[..., p - k, :]
        g[..., p + h - 1 - k, :] += g[..., p + h - 1 + k, :]
    return g[..., p:p + h, p:p + w]
