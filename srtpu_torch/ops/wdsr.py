"""K7: WDSR-B's wide-activation block, forward and backward, one host call
per trunk each way.

Replaces ``srtpu/ops/wdsr_cs.py:_fwd_call`` (body ``_fwd_kernel``) and
``_bwd_call`` (``_bwd_kernel``), behind ``wdsr_block_cs``. The kernels
are ``csrc/wdsr.cu``, whose head note says what bounds them on the H100
and how they run: the 1x1 pair as one chained-GEMM kernel on wgmma (h1
never in device memory), the 3x3 and the backward's dh2 on K2's engine
(``csrc/conv_sm90.cuh``), the pointwise backward as the chain run
backwards, and dW1, dW2, dW3 on W's (:mod:`.wgrad`).
:func:`wdsr_trunk_fwd` and :func:`wdsr_trunk_bwd` run L blocks on
stacked weights in one host call each way for CUDA tensors and take the
plain versions only for CPU tensors; :func:`wdsr_fwd` and
:func:`wdsr_bwd` are one block (a trunk of one). Every call counts its
blocks in ``wdsr_fwd.launches`` and ``wdsr_bwd.launches``.
:func:`fwd_plan` and :func:`bwd_plan` say in plain Python what wdsr.cu
launches. :func:`wdsr_trunk` is the differentiable op
(:class:`WDSRTrunkFn`), :func:`wdsr_block` one block of it.

One block, NHWC x (B, H, W, C), in the compute dtype (bf16 on the card):
h1 = relu(x W1 + b1) (C -> e = 6C), h2 = h1 W2 + b2 (e -> Lp), out =
(conv3x3(h2; W3) + b3) * res_scale + x. Weights: w1 (C, e), w2 (e, Lp),
w3 HWIO (3, 3, Lp, C) in x's dtype, biases f32, with the bottleneck width
L = int(0.8 C) zero-padded to Lp: the 16-multiple :func:`wdsr_lp` (as
srtpu pads, srtpu/models/wdsr.py:91-95) in the plain versions and what
callers hand in, and the kernels' width inside the kernel wrappers
(:func:`kernel_c`: C where C is 64 or 128, so that every product runs at
a multiple of 64). A narrower C (a multiple of 16) runs zero-padded to
the next of the two: x's channels, W1's rows and columns (e to 6 times
the width), W3's output channels and b3. Padded channels carry zero
weights and bias, so results and the unpadded gradients are exact either
way; the wrappers return results at the widths they were given.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from ._build import ptr
from .conv import conv_f32
from .layout import w_t
from .wgrad import conv_wgrad_plain, wgrad_parts

KERNEL_C = (64, 128)    # the kernels' widths (C, and Lp = C)
P_TILE = 128            # pixels a block of the chain kernels
TH, TW = 8, 16          # K2's engine's pixel tile
EPI_DH2, EPI_SKIP = 7, 8   # the engine's epilogues K7 launches


def wdsr_lp(n_feats: int, linear: float = 0.8) -> tuple[int, int]:
    """(L, Lp): the bottleneck width and its 16-multiple padding
    (srtpu/ops/wdsr_cs.py:wdsr_lp)."""
    lv = int(n_feats * linear)
    return lv, (lv + 15) // 16 * 16


def kernel_c(n_feats: int) -> int:
    """The width the kernels run a block of ``n_feats`` channels at: the
    narrowest of KERNEL_C that holds it (``n_feats`` itself where none
    does, which :func:`_check` refuses)."""
    return min((k for k in KERNEL_C if k >= n_feats), default=n_feats)


def kernel_lp(n_feats: int) -> int:
    """The Lp the kernels run at: their width :func:`kernel_c`, so that
    the W2 and 3x3 products' widths are multiples of 64 (K2's and W's
    64-channel atoms)."""
    return kernel_c(n_feats)


def pad_lp(w2, b2, w3, lp: int) -> tuple:
    """w2 (..., e, L), b2 (..., L), w3 (..., 3, 3, L, C) with the
    bottleneck zero-padded to ``lp`` (differentiable: autograd slices the
    padding off the gradients)."""
    pad = lp - w2.shape[-1]
    if pad == 0:
        return w2, b2, w3
    return (F.pad(w2, (0, pad)), F.pad(b2, (0, pad)),
            F.pad(w3, (0, 0, 0, pad)))


def _recompute(x, w1, b1, w2, b2):
    """h1 and h2 in x's dtype, each rounded once from f32 sums."""
    dt = x.dtype
    h1 = (x.float() @ w1.float() + b1.float()).clamp_min(0.0).to(dt)
    return h1, (h1.float() @ w2.float() + b2.float()).to(dt)


def _block_plain(x, w1, b1, w2, b2, w3, b3, res_scale: float):
    """One block's output and h2, rounding where ``_fwd_kernel`` does."""
    _, h2 = _recompute(x, w1, b1, w2, b2)
    out = (conv_f32(h2, w3, b3) * res_scale + x.float()).to(x.dtype)
    return out.contiguous(), h2


def wdsr_fwd_plain(x, w1, b1, w2, b2, w3, b3, res_scale: float):
    """Plain forward, rounding where ``_fwd_kernel`` does: h1 and h2 once
    each, out = x.dtype((conv3x3(h2) + b3) * res_scale + x) once."""
    return _block_plain(x, w1, b1, w2, b2, w3, b3, res_scale)[0]


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


def wdsr_trunk_plain(x, w1s, b1s, w2s, b2s, w3s, b3s, res_scale: float,
                     save: bool = False):
    """L blocks of :func:`wdsr_fwd_plain` on stacked weights (w1s (L, C,
    e), ...). ``save`` returns ``(out, xs, h2s)``: every block's input and
    h2, stacked (L, B, H, W, ...), as the kernel path saves them (the
    plain backward recomputes h2)."""
    xs, h2s = [], []
    for prm in zip(w1s, b1s, w2s, b2s, w3s, b3s):
        xs.append(x)
        x, h2 = _block_plain(x, *prm, res_scale)
        h2s.append(h2)
    return (x, torch.stack(xs), torch.stack(h2s)) if save else x


def wdsr_trunk_bwd_plain(xs, g, w1s, b1s, w2s, b2s, w3s, res_scale: float):
    """L blocks of :func:`wdsr_bwd_plain`, the last first: dx and the
    stacked f32 grads (dw1s, db1s, dw2s, db2s, dw3s, db3s)."""
    grads = []
    for l in reversed(range(xs.shape[0])):
        g, *gl = wdsr_bwd_plain(xs[l], g, w1s[l], b1s[l], w2s[l], b2s[l],
                                w3s[l], res_scale)
        grads.append(gl)
    return (g, *(torch.stack(t[::-1]) for t in zip(*grads)))


def fwd_plan(c: int, save: bool, scale: float, n_blocks: int = 1,
             hilo: bool = False) -> tuple:
    """wdsr.cu's launches for a forward call of ``n_blocks`` blocks at
    width ``c`` (K8c's one block with ``hilo``), in order, each (kernel,
    EPI, k, cin, cout, transposed, scale, what it writes), at the kernels'
    width C = :func:`kernel_c`: 'chain' the 1x1 pair (C -> e -> Lp = C,
    one 128-pixel block each; K8c's writes v as [hi | lo]), 'engine' K2's
    engine over the 8 x 16 tiles (EPI 8: the 3x3 Lp -> C with its bias,
    the scale and the skip), 'copy' a device copy."""
    c = lp = kernel_c(c)
    block = (('chain', None, 1, c, lp, False, None,
              ('v',) if hilo else ('h2',)),
             ('engine', EPI_SKIP, 3, 2 * lp if hilo else lp, c, False,
              float(scale), ('out',)))
    head = (('copy', None, None, None, None, None, None, ('xs',)),)
    return (head if save else ()) + block * n_blocks


def bwd_plan(c: int, scale: float, n_blocks: int = 1) -> tuple:
    """wdsr.cu's launches for a backward call of ``n_blocks`` blocks (the
    last first) from the forward's saved block inputs and h2, as
    :func:`fwd_plan`: per block, a 'gs' pass where res_scale is not 1,
    dh2 on K2's transposed engine at EPI 7 (dh2b and its tile sums), the
    chain backward ('chain_bwd': dx, h1, dh1b, db1's partials), and W's
    three ('wgrad': dW1, dW2 at k = 1, dW3 and db3 at k = 3 reading g at
    the scale); then one 'colsum' each for db1 and db2."""
    c = lp = kernel_c(c)
    e = 6 * c
    block = ()
    if float(scale) != 1.0:
        block += (('gs', None, None, None, None, None, float(scale),
                   ('gs',)),)
    block += (('engine', EPI_DH2, 3, c, lp, True, None, ('dh2b', 'part2')),
              ('chain_bwd', None, 1, c, lp, True, None,
               ('dx', 'h1', 'dh1b', 'part1')),
              ('wgrad', None, 1, c, e, False, None, ('dw1',)),
              ('wgrad', None, 1, e, lp, False, None, ('dw2',)),
              ('wgrad', None, 3, lp, c, False, float(scale), ('dw3', 'db3')))
    tail = (('colsum', None, None, None, None, None, None, ('db1',)),
            ('colsum', None, None, None, None, None, None, ('db2',)))
    return block * n_blocks + tail


def _check(name: str, x, e: int, lp: int) -> None:
    """Raise unless the kernels take this block, padded to their width
    (:func:`kernel_c`): C a multiple of 16 up to 128, e at most 6 times
    the width, Lp at most the width; on a CUDA tensor."""
    c = x.shape[-1]
    cp = kernel_c(c)
    if c % 16 or cp not in KERNEL_C or e > 6 * cp or lp > cp:
        raise ValueError(f'{name}: no kernel for C={c}, e={e}, Lp={lp} (C a '
                         f'multiple of 16 up to 128, run padded to 64 or '
                         f'128, with e and Lp at most 6 and 1 times that; '
                         f'ROADMAP.md F4)')
    if x.device.type != 'cuda':
        raise ValueError(f'{name}: no kernel for device {x.device}')


def widen(c: int, acts, w1, b1, w2, b2, w3, b3) -> tuple:
    """The operands of blocks of width ``c`` at the kernels' widths: the
    activations ``acts`` (..., C) and w1 (..., C, e), b1 (..., e), w2
    (..., e, Lp), b2 (..., Lp), w3 (..., 3, 3, Lp, C), b3 (..., C),
    stacked or not, zero-padded to C = e / 6 = Lp = :func:`kernel_c`
    (exact: the padded channels stay 0 through the block, and add 0 to
    every real sum). None stays None; nothing is copied where nothing is
    padded. Returns (acts, w1, b1, w2, b2, w3, b3)."""
    cp = kernel_c(c)
    dc, de, dl = cp - c, 6 * cp - w1.shape[-1], cp - w2.shape[-1]

    def pad(t, *p):
        return None if t is None else (F.pad(t, p) if any(p)
                                       else t).contiguous()
    return ([pad(a, 0, dc) for a in acts], pad(w1, 0, de, 0, dc),
            pad(b1, 0, de), pad(w2, 0, dl, 0, de), pad(b2, 0, dl),
            pad(w3, 0, dc, 0, dl), pad(b3, 0, dc))


def _expect_weights(w1s, b1s, w2s, b2s, w3s, n_blocks, c, e, lp, dev):
    bf16, f32 = torch.bfloat16, torch.float32
    _build.expect(w1s, 'w1s', bf16, (n_blocks, c, e), dev)
    _build.expect(b1s, 'b1s', f32, (n_blocks, e), dev)
    _build.expect(w2s, 'w2s', bf16, (n_blocks, e, lp), dev)
    if b2s is not None:
        _build.expect(b2s, 'b2s', f32, (n_blocks, lp), dev)
    _build.expect(w3s, 'w3s', bf16, (n_blocks, 3, 3, lp, c), dev)


def wdsr_trunk_fwd(x, w1s, b1s, w2s, b2s, w3s, b3s, res_scale: float,
                   save: bool = False):
    """x (B, H, W, C) bf16; w1s (L, C, e), w2s (L, e, Lp), w3s (L, 3, 3,
    Lp, C) bf16; b1s (L, e), b2s (L, Lp), b3s (L, C) f32 -> (B, H, W, C)
    bf16 after L blocks, or with ``save`` ``(out, xs, h2s)``: every
    block's input and h2 at the kernels' width, stacked (L, B, H, W,
    :func:`kernel_c`), as :func:`wdsr_trunk_bwd` reads them. On CUDA (see
    :func:`_check`): one host call, two launches a block. The registered
    operator ``srtpu::wdsr_trunk_fwd`` (:mod:`._library`)."""
    op = (torch.ops.srtpu.wdsr_trunk_fwd.default
          if x.device.type in _build.OP_DEVICES else wdsr_trunk_fwd_cuda)
    got = op(x, w1s, b1s, w2s, b2s, w3s, b3s, float(res_scale), save)
    return tuple(got) if save else got[0]


def wdsr_trunk_fwd_cuda(x, w1s, b1s, w2s, b2s, w3s, b3s, res_scale: float,
                        save: bool) -> list:
    """``srtpu::wdsr_trunk_fwd`` on CUDA: the checks, the padding to the
    kernels' width, one ``srt_wdsr_trunk_fwd`` call, the count."""
    n_blocks, c, e = w1s.shape
    _check('wdsr_fwd', x, e, w2s.shape[-1])
    (x,), w1s, b1s, w2s, b2s, w3s, b3s = widen(c, (x,), w1s, b1s, w2s, b2s,
                                               w3s, b3s)
    cp, dev = kernel_c(c), x.device
    _build.expect(x, 'x', torch.bfloat16, x.shape, dev)
    _expect_weights(w1s, b1s, w2s, b2s, w3s, n_blocks, cp, 6 * cp, cp, dev)
    _build.expect(b3s, 'b3s', torch.float32, (n_blocks, cp), dev)
    out = torch.empty_like(x)
    if save:    # every block's input and h2 stay for the backward
        xs = torch.empty((n_blocks, *x.shape), dtype=x.dtype, device=dev)
        h2s = torch.empty_like(xs)
    else:       # the other of two outputs a block alternates on; h2 scratch
        xs = torch.empty_like(x) if n_blocks > 1 else None
        h2s = torch.empty_like(x)
    bsz, h, w, _ = x.shape
    with _build.on(dev):
        err = _build.library().srt_wdsr_trunk_fwd(
            x.data_ptr(), w1s.data_ptr(), b1s.data_ptr(), w2s.data_ptr(),
            b2s.data_ptr(), w3s.data_ptr(), b3s.data_ptr(), float(res_scale),
            None if xs is None else xs.data_ptr(), h2s.data_ptr(),
            out.data_ptr(), n_blocks, int(save), bsz, h, w, cp, 6 * cp, cp,
            _build.stream(dev))
    _build.check(err, 'srt_wdsr_trunk_fwd')
    wdsr_fwd.launches += n_blocks
    if cp != c:
        out = out[..., :c].contiguous()
    return [out, xs, h2s] if save else [out]


def wdsr_trunk_bwd(xs, h2s, g, w1s, b1s, w2s, b2s, w3s, res_scale: float):
    """xs, h2s (L, B, H, W, C') bf16, every block's input and h2, as
    ``wdsr_trunk_fwd(save=True)`` returns them (C' the kernels' width on
    CUDA; the plain version recomputes h2 from xs at C, and reads b2s);
    g (B, H, W, C) bf16; the weights as the forward's -> (dx, dw1s, db1s,
    dw2s, db2s, dw3s, db3s) as :func:`wdsr_trunk_bwd_plain`, at the
    widths of the weights given. On CUDA: one host call (see
    :func:`bwd_plan`)."""
    if g.device.type == 'cpu':
        return wdsr_trunk_bwd_plain(xs, g, w1s, b1s, w2s, b2s, w3s,
                                    res_scale)
    n_blocks, c, e = w1s.shape
    lp_in = w2s.shape[-1]
    _check('wdsr_bwd', g, e, lp_in)
    (g,), w1s, b1s, w2s, _, w3s, _ = widen(c, (g,), w1s, b1s, w2s, None,
                                           w3s, None)
    cp, dev = kernel_c(c), g.device
    e_k = 6 * cp
    bsz, h, w, _ = g.shape
    _build.expect(g, 'g', torch.bfloat16, g.shape, dev)
    for name, t in (('xs', xs), ('h2s', h2s)):
        _build.expect(t, name, torch.bfloat16, (n_blocks, bsz, h, w, cp),
                      dev)
    _expect_weights(w1s, b1s, w2s, None, w3s, n_blocks, cp, e_k, cp, dev)
    bf = dict(dtype=torch.bfloat16, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    act = (bsz, h, w, cp)
    gs = torch.empty(act, **bf) if float(res_scale) != 1.0 else None
    dh2b = torch.empty(act, **bf)
    h1 = torch.empty((bsz, h, w, e_k), **bf)
    dh1b = torch.empty_like(h1)
    gbuf = torch.empty((2, *act), **bf) if n_blocks > 1 else None
    # W's splits: dW1 (C -> e) and dW2 (e -> Lp) at k = 1, dW3 at k = 3;
    # one set of partial slots, sized for the largest, serves all three
    # (wgrad_workspace's layout at one job)
    classes = ((cp, e_k, 1), (e_k, cp, 1), (cp, cp, 3))
    split = [wgrad_parts(bsz, h, w, ci, co, k=k) for ci, co, k in classes]
    nw = max([n * k * k * ci * co for (_, n), (ci, co, k) in
              zip(split, classes) if n > 1], default=0)
    nb = max([n * co for (_, n), (_, co, _) in zip(split, classes) if n > 1],
             default=0)
    ws_w = torch.empty((nw,), **f32) if nw else None
    ws_b = torch.empty((nb,), **f32) if nb else None
    tiles = bsz * -(-h // TH) * -(-w // TW)
    part1 = torch.empty((n_blocks, 2 * -(-bsz * h * w // P_TILE), e_k),
                        **f32)
    part2 = torch.empty((n_blocks, tiles, cp), **f32)
    # the f32 grads in one allocation (an allocation costs microseconds)
    shapes = ((cp, e_k), (e_k,), (e_k, cp), (cp,), (3, 3, cp, cp), (cp,))
    sizes = [n_blocks * torch.Size(s).numel() for s in shapes]
    dw1s, db1s, dw2s, db2s, dw3s, db3s = (
        t.view(n_blocks, *s) for t, s in zip(
            torch.empty((sum(sizes),), **f32).split(sizes), shapes))
    dx = torch.empty_like(g)
    with _build.on(dev):
        err = _build.library().srt_wdsr_trunk_bwd(
            xs.data_ptr(), h2s.data_ptr(), g.data_ptr(), w1s.data_ptr(),
            b1s.data_ptr(), w2s.data_ptr(), w3s.data_ptr(), float(res_scale),
            ptr(gs), dh2b.data_ptr(), h1.data_ptr(), dh1b.data_ptr(),
            ptr(gbuf), ptr(ws_w), ptr(ws_b), part1.data_ptr(),
            part2.data_ptr(), dw1s.data_ptr(), dw2s.data_ptr(),
            dw3s.data_ptr(), db1s.data_ptr(), db2s.data_ptr(),
            db3s.data_ptr(), dx.data_ptr(), n_blocks, bsz, h, w, cp, e_k, cp,
            *split[0], *split[1], *split[2], _build.stream(dev))
    _build.check(err, 'srt_wdsr_trunk_bwd')
    wdsr_bwd.launches += n_blocks
    if cp == c and e_k == e and cp == lp_in:
        return dx, dw1s, db1s, dw2s, db2s, dw3s, db3s
    return (dx[..., :c].contiguous(), dw1s[:, :c, :e], db1s[:, :e],
            dw2s[:, :e, :lp_in], db2s[:, :lp_in], dw3s[..., :lp_in, :c],
            db3s[:, :c])


def wdsr_fwd(x, w1, b1, w2, b2, w3, b3, res_scale: float):
    """One block, as :func:`wdsr_fwd_plain`: bf16 x (B, H, W, C), w1 (C,
    e), w2 (e, Lp), w3 (3, 3, Lp, C); f32 b1, b2, b3. On CUDA
    :func:`wdsr_trunk_fwd` at L = 1 (two launches)."""
    if x.device.type == 'cpu':
        return wdsr_fwd_plain(x, w1, b1, w2, b2, w3, b3, res_scale)
    return wdsr_trunk_fwd(x, w1[None], b1[None], w2[None], b2[None],
                          w3[None], b3[None], res_scale)


def wdsr_bwd(x, g, w1, b1, w2, b2, w3, res_scale: float):
    """One block, as :func:`wdsr_bwd_plain`. On CUDA the block's saved
    input and h2 from ``wdsr_trunk_fwd(save=True)`` (a forward launch,
    counted as one; b3 does not reach h2), then :func:`wdsr_trunk_bwd` at
    L = 1."""
    if x.device.type == 'cpu':
        return wdsr_bwd_plain(x, g, w1, b1, w2, b2, w3, res_scale)
    w = (w1[None], b1[None], w2[None], b2[None], w3[None])
    b3 = torch.zeros((1, x.shape[-1]), dtype=torch.float32, device=x.device)
    _, xs, h2s = wdsr_trunk_fwd(x, *w, b3, res_scale, save=True)
    out = wdsr_trunk_bwd(xs, h2s, g, *w, res_scale)
    return (out[0], *(t[0] for t in out[1:]))


wdsr_fwd.launches = 0
wdsr_bwd.launches = 0


class WDSRTrunkFn(torch.autograd.Function):
    """Differentiable K7 over L blocks (srtpu ``wdsr_block_cs`` block after
    block) on stacked, padded weights: f32 (or any) parameters in, cast to
    x's dtype (the biases to f32) inside; saves every block's input and,
    on the card, its h2; returns the grads in the parameters' dtypes."""

    @staticmethod
    def forward(ctx, x, w1s, b1s, w2s, b2s, w3s, b3s, res_scale: float,
                plain: bool):
        ops = _cast(x, w1s, b1s, w2s, b2s, w3s, b3s)
        out, xs, h2s = (wdsr_trunk_plain if plain else wdsr_trunk_fwd)(
            x, *ops, res_scale, save=True)
        ctx.save_for_backward(xs, h2s, *ops[:5])
        ctx.res_scale, ctx.plain = res_scale, plain
        ctx.dtypes = tuple(t.dtype for t in (w1s, b1s, w2s, b2s, w3s, b3s))
        return out

    @staticmethod
    def backward(ctx, g):
        xs, h2s, *ops = ctx.saved_tensors
        g = g.contiguous()
        grads = (wdsr_trunk_bwd_plain(xs, g, *ops, ctx.res_scale)
                 if ctx.plain else
                 wdsr_trunk_bwd(xs, h2s, g, *ops, ctx.res_scale))
        return (grads[0], *(t.to(d) for t, d in zip(grads[1:], ctx.dtypes)),
                None, None)


def _cast(x, w1, b1, w2, b2, w3, b3):
    """The kernels' operands: weights in x's dtype, biases f32."""
    dt = x.dtype
    return (w1.to(dt).contiguous(), b1.float().contiguous(),
            w2.to(dt).contiguous(), b2.float().contiguous(),
            w3.to(dt).contiguous(), b3.float().contiguous())


def wdsr_trunk(x, w1s, b1s, w2s, b2s, w3s, b3s, res_scale: float = 1.0,
               plain: bool = False) -> torch.Tensor:
    """L WDSR-B blocks in x's dtype from stacked f32 (or any) weights: w1s
    (L, C, e), b1s (L, e), w2s (L, e, L_b), b2s (L, L_b), w3s (L, 3, 3,
    L_b, C), b3s (L, C), with L_b = int(0.8 C) unpadded. L_b is
    zero-padded here: to :func:`wdsr_lp`'s Lp for the plain versions, to
    :func:`kernel_lp` for the kernels. The autograd op when a gradient is
    wanted, else the forward alone (no saved activations). ``plain`` runs
    the plain versions on any device."""
    lp = (wdsr_lp(x.shape[-1])[1] if plain or x.device.type == 'cpu'
          else kernel_lp(x.shape[-1]))
    w2s, b2s, w3s = pad_lp(w2s, b2s, w3s, lp)
    x = x.contiguous()
    params = (w1s, b1s, w2s, b2s, w3s, b3s)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        return WDSRTrunkFn.apply(x, *params, res_scale, plain)
    return (wdsr_trunk_plain if plain else wdsr_trunk_fwd)(
        x, *_cast(x, *params), res_scale)


def wdsr_block(x, w1, b1, w2, b2, w3, b3, res_scale: float = 1.0,
               plain: bool = False) -> torch.Tensor:
    """One WDSR-B block: :func:`wdsr_trunk` at L = 1 on w1 (C, e), b1
    (e,), w2 (e, L_b), b2 (L_b,), w3 (3, 3, L_b, C), b3 (C,)."""
    return wdsr_trunk(x, w1[None], b1[None], w2[None], b2[None], w3[None],
                      b3[None], res_scale, plain)
