"""K4: SRResNet's BatchNorm resblock and the trunk's closing conv + BN,
training mode, forward and backward; and their eval-mode counterparts.
With ``reflect=True``, K4r: the same with REFLECT conv boundaries (torch
``ReflectionPad2d(1)`` + a valid conv, SRGAN's generator) instead of SAME
zero padding.

Replaces ``srtpu/ops/bn_resblock_cs.py``: ``_conv_stats_call`` (behind
``f1_conv_stats`` and ``f2_norm_act_conv_stats``), ``f3_norm_skip``,
``b1_sums``, ``b2_call`` and ``b3_call``, composed as ``bn_resblock_cs``
(:class:`BNResBlockFn`) and ``bn_close_cs`` (:class:`BNCloseFn`), each
with ``reflect`` as srtpu's (``f3_norm_skip`` and ``b1_sums`` have no
conv and take none). The kernels are ``csrc/bn_block.cu``, whose head
note says what bounds them on the H100, how the convs run on K2's
Hopper engine (``csrc/conv_sm90.cuh``, K4's own epilogues ``EPI`` 9-11),
how the batch statistics are reduced without float atomics and what
reflect changes (the halo mirrored in shared memory; the backward's fold
of the mirrored reads); the weight grads come from the weight-grad
kernel (:mod:`.wgrad`). Each wrapper (:func:`f1_conv_stats` ...
:func:`b3_call`) launches its kernels for CUDA tensors, takes its plain
version (``*_plain``) only for CPU tensors, and counts one launch per
call: ``launches`` with SAME boundaries, ``launches_reflect`` with
REFLECT.

The trunk op (:func:`bn_trunk`, :class:`BNTrunkFn`) runs a whole BN
trunk, L blocks and the closing conv + BN + global skip, in one host
call each way (:func:`bn_trunk_fwd`, :func:`bn_trunk_bwd`: the per-block
loop in C++, every weight grad in one stacked launch of W); its plain
versions are the per-function plain versions in the same order, so the
trunk op equals L calls of :func:`bn_resblock` and one of
:func:`bn_close`.

Shapes: activations NHWC (B, H, W, C) in the compute dtype; conv weights
HWIO (3, 3, C, C) in it; biases, BN scale (gamma) and shift (beta), the
PReLU slope alpha (1,) and every statistic f32. A BN's statistics travel
as ``st`` (5, C) f32, rows mean, biased variance, inv = 1 / sqrt(var +
1e-5), a = gamma * inv, c = beta - mean * a (BN(y) = a * y + c).
``sums`` (2, C) are a backward's two channel sums. On CUDA: C = 64.

The eval-mode functions :func:`bn_resblock_ref` and :func:`bn_close_ref`
normalise with running statistics through stock PyTorch convs, as srtpu
leaves that path to XLA (``bn_resblock_ref``, ``bn_close_ref``; reflect
as ``conv3x3_reflect_reference``: ``F.pad(mode='reflect')`` and a valid
conv).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from ._build import ptr
from .conv import conv_f32
from .layout import reflect_fold, w_t
from .wgrad import (conv_wgrad, conv_wgrad_plain, wgrad_parts,
                    wgrad_workspace)

EPS = 1e-5
TH, TW = 8, 16      # K2's engine's pixel tile (the convs' partials)
CHUNK = 128         # pixels per block of B1's sums and the dy pass
# K4's epilogues on K2's engine (csrc/conv_sm90.cuh): F1 / F2's conv and
# its statistics' partials; B2's and B3's transposed convs
EPI_F, EPI_B2, EPI_B3 = 9, 10, 11
_DIMS = (0, 1, 2)


def _finalize(sm, sq, m: float, gamma, beta) -> torch.Tensor:
    """sum / sum of squares over m values -> st (5, C): mean, biased var,
    inv, a, c (bn_resblock_cs.py:_finalize)."""
    mean = sm / m
    var = (sq / m - mean * mean).clamp_min(0.0)
    inv = 1.0 / torch.sqrt(var + EPS)
    a = gamma * inv
    return torch.stack([mean, var, inv, a, beta - mean * a])


def _npix(t: torch.Tensor) -> float:
    return float(t.shape[0] * t.shape[1] * t.shape[2])


def _xhat(y, st):
    return (y.float() - st[0]) * st[2]


def _z(y1, st1):
    """The PReLU input a1 * y1 + c1, f32."""
    return st1[3] * y1.float() + st1[4]


def _conv(x, w, b=None, reflect: bool = False):
    """3x3 conv of NHWC x with HWIO w (plus b) in f32 with no rounding:
    SAME (``conv_f32``) or REFLECT (``ReflectionPad2d(1)``, a valid
    conv)."""
    if not reflect:
        return conv_f32(x, w, b)
    xp = F.pad(x.permute(0, 3, 1, 2).float(), (1, 1, 1, 1), mode='reflect')
    y = F.conv2d(xp, w.permute(3, 2, 0, 1).float()).permute(0, 2, 3, 1)
    return y if b is None else y + b.float()


def _conv_t(g, w, reflect: bool = False):
    """The input gradient of ``_conv(x, w, reflect=reflect)`` at cotangent
    g, f32: SAME, the transposed conv conv(g, w_t(w)); REFLECT, that conv
    over the padded grid (g zero-padded by 2: rows and columns -1 .. H,
    W), whose ring is then added at its mirrored sources (the adjoint of
    the reflect pad, ``reflect_fold``: rows 1, H - 2, columns 1, W - 2,
    in a fixed order)."""
    if not reflect:
        return conv_f32(g, w_t(w))
    gp = F.pad(g.permute(0, 3, 1, 2).float(), (2, 2, 2, 2))
    full = F.conv2d(gp, w_t(w).permute(3, 2, 0, 1).float())
    return reflect_fold(full, 1).permute(0, 2, 3, 1)


# ------------------------------------------------------- plain versions


def f1_plain(u, w, b, gamma, beta, reflect: bool = False):
    """F1: y = bf16(conv(u, w) + b) and the statistics of the stored y."""
    y = _conv(u, w, b, reflect).to(u.dtype).contiguous()
    yf = y.float()
    return y, _finalize(yf.sum(_DIMS), (yf * yf).sum(_DIMS), _npix(y), gamma,
                        beta)


def f2_plain(y1, st1, alpha, w, b, gamma, beta, reflect: bool = False):
    """F2: h1 = bf16(prelu(a1 * y1 + c1)), then F1 on h1 (the padding
    applies to h1). Returns (y2, h1, st2)."""
    z = _z(y1, st1)
    h1 = torch.where(z >= 0, z, alpha * z).to(y1.dtype).contiguous()
    y2, st2 = f1_plain(h1, w, b, gamma, beta, reflect)
    return y2, h1, st2


def f3_plain(y, st, u):
    """F3: out = bf16(a * y + c + u), one rounding."""
    return (st[3] * y.float() + st[4] + u.float()).to(y.dtype).contiguous()


def b1_plain(g, y, st):
    """B1: sums (2, C) = sum g, sum g * xhat."""
    gf = g.float()
    return torch.stack([gf.sum(_DIMS), (gf * _xhat(y, st)).sum(_DIMS)])


def _dy(g, y, st, gamma, sums):
    """A BN's input gradient, f32: coef * (g - t1 - xhat * t2), coef =
    gamma * inv, t1 = sums[0] / m, t2 = sums[1] / m."""
    m = _npix(g)
    return (gamma * st[2]) * ((g.float() - sums[0] / m)
                              - _xhat(y, st) * (sums[1] / m))


def b2_plain(g, y2, st2, gamma2, sums2, y1, st1, alpha, w2,
             reflect: bool = False):
    """B2: BN2 backward -> transposed conv with w2 (with reflect, its fold
    in f32) -> PReLU backward. Returns dz (bf16, as stored), bf16 dy2 (for
    dW2), db2 (sum of the f32 dy2), dalpha (1,) and BN1's sums (2, C) of
    the stored dz."""
    dy2 = _dy(g, y2, st2, gamma2, sums2)
    dy2c = dy2.to(g.dtype).contiguous()
    dh1 = _conv_t(dy2c, w2, reflect)
    z = _z(y1, st1)
    dz = torch.where(z >= 0, dh1, alpha * dh1).to(g.dtype).contiguous()
    dal = torch.where(z >= 0, 0.0, dh1 * z).sum(_DIMS).sum().reshape(1)
    return dz, dy2c, dy2.sum(_DIMS), dal, b1_plain(dz, y1, st1)


def b3_plain(dz, y1, st1, gamma1, sums1, w1, skip, reflect: bool = False):
    """B3: BN1 backward -> transposed conv with w1 (with reflect, its fold
    in f32; + skip, unless None), one rounding. Returns du, bf16 dy1 (for
    dW1) and db1 (sum of the f32 dy1)."""
    dy1 = _dy(dz, y1, st1, gamma1, sums1)
    dy1c = dy1.to(dz.dtype).contiguous()
    du = _conv_t(dy1c, w1, reflect)
    if skip is not None:
        du = du + skip.float()
    return du.to(dz.dtype).contiguous(), dy1c, dy1.sum(_DIMS)


# --------------------------------------- kernel against plain: limits

STEP = 2.0 ** -7        # one bf16 rounding step, relative
F32_SUM = 2.0 ** -20    # an f32 sum's rounding, of the sum of |terms|


def _abs_sum(t):
    return t.float().abs().sum(_DIMS)


def _st_limits(yk, yp, st, gamma, beta):
    """Limits (5, C) on a kernel's statistics against the plain ones (st,
    from the plain version's stored y ``yp``; ``yk`` the kernel's): the
    f32 rounding of the sums of y and y^2 plus what the two stored y
    differ by, carried through _finalize (inv's slope taken at the low
    end of var's interval)."""
    m = _npix(yp)
    yf, kf = yp.float(), yk.float()
    lm = (F32_SUM * _abs_sum(yf) + _abs_sum(kf - yf)) / m
    lv = ((F32_SUM * (yf * yf).sum(_DIMS) + _abs_sum(kf * kf - yf * yf)) / m
          + (2 * st[0].abs() + lm) * lm)
    mean, inv, a = st[0].abs(), st[2], st[3].abs()
    li = (0.5 * (st[1] - lv + EPS).clamp_min(EPS) ** -1.5 * lv
          + F32_SUM * inv)
    la = gamma.abs() * li + F32_SUM * a
    lc = a * lm + mean * la + F32_SUM * (beta.abs() + mean * a)
    return torch.stack([lm, lv, li, la, lc])


def db_scale(st, gamma, sums, dy) -> torch.Tensor:
    """Per channel, the scale whose f32 rounding (F32_SUM of it) bounds db
    = sum dy of a BN backward (st, gamma, sums its inputs, dy its input
    gradient): sum |dy|, and what each of the m terms carries from the
    rounding of t1 = S_g / m and of the mean inside xhat, |coef| (|S_g| +
    |S_gx| inv |mean|)."""
    coef = (gamma * st[2]).abs()
    return _abs_sum(dy) + coef * (sums[0].abs()
                                  + sums[1].abs() * st[2] * st[0].abs())


def kernel_limits(kind: str, args, ref, got) -> list[torch.Tensor]:
    """Per-element limits (each broadcasts to its output) within which the
    K4 kernel ``kind`` ('f1' ... 'b3') must match its plain version on
    ``args``; ``ref`` the plain outputs, ``got`` the kernel's. A bf16
    output: one rounding step of its largest magnitude (the same rounding
    points; f32 sums in another order). An f32 sum: its f32 rounding,
    F32_SUM of the sum of its terms' magnitudes, plus what the stored bf16
    values it reads differ by between the two versions (the statistics
    through _finalize); db = sum dy to F32_SUM of its db_scale, even where
    the BN makes it 0 (a db summed from the bf16 dy is off by far more)."""
    lim = [STEP * r.float().abs().max() if r.dtype == torch.bfloat16
           else None for r in ref]
    if kind == 'f1':
        lim[1] = _st_limits(got[0], ref[0], ref[1], args[3], args[4])
    elif kind == 'f2':
        lim[2] = _st_limits(got[0], ref[0], ref[2], args[5], args[6])
    elif kind == 'b1':
        g, y, st = args
        lim[0] = F32_SUM * torch.stack([_abs_sum(g),
                                        _abs_sum(g.float() * _xhat(y, st))])
    elif kind == 'b2':
        y1, st1, w2 = args[5], args[6], args[8]
        reflect = len(args) > 9 and bool(args[9])
        lim[2] = F32_SUM * db_scale(*args[2:5], ref[1])
        # dalpha: the f32 sum over z < 0 of dh1 * z, and the dh1 that the
        # two versions' bf16 dy2 (which may sit a step apart) give
        z = _z(y1, st1)
        neg = (z < 0).float() * z.abs()
        dh1 = _conv_t(ref[1], w2, reflect).abs()
        ddh = _conv_t((got[1].float() - ref[1].float()).abs(),
                      w2.float().abs(), reflect)
        lim[3] = (F32_SUM * (dh1 * neg).sum() + (ddh * neg).sum()).reshape(1)
        # BN1's sums read the stored dz, which may sit a step apart
        dk, dp = got[0].float(), ref[0].float()
        xh = _xhat(y1, st1).abs()
        lim[4] = torch.stack([
            F32_SUM * _abs_sum(dp) + _abs_sum(dk - dp),
            F32_SUM * _abs_sum(dp * xh) + _abs_sum((dk - dp) * xh)])
    elif kind == 'b3':
        lim[2] = F32_SUM * db_scale(*args[2:5], ref[1])
    return lim


# ------------------------------------------------------------- kernels


def _check(name: str, x: torch.Tensor, reflect: bool = False) -> None:
    if x.device.type != 'cuda':
        raise ValueError(f'{name}: no kernel for device {x.device}')
    if x.shape[-1] != 64:
        raise ValueError(f'{name}: no kernel for C={x.shape[-1]}')
    if reflect and min(x.shape[1], x.shape[2]) < 2:
        # as torch's ReflectionPad2d(1): a mirror needs two pixels
        raise ValueError(f'{name}: reflect needs H, W >= 2, got '
                         f'{x.shape[1]}x{x.shape[2]}')


def _count(fn, reflect: bool) -> None:
    if reflect:
        fn.launches_reflect += 1
    else:
        fn.launches += 1


def _expect(dev, acts, vecs=(), weights=()):
    """Activations (B, H, W, 64) bf16 (of the first's shape), small f32
    vectors of the given shapes, (3, 3, 64, 64) bf16 weights."""
    shape = tuple(acts[0][1].shape)
    for name, t in acts:
        _build.expect(t, name, torch.bfloat16, shape, dev)
    for name, t, vshape in vecs:
        _build.expect(t, name, torch.float32, vshape, dev, aligned=False)
    for name, t in weights:
        _build.expect(t, name, torch.bfloat16, (3, 3, 64, 64), dev)


def _tiles(x) -> int:
    bsz, h, w, _ = x.shape
    return bsz * -(-h // TH) * -(-w // TW)


def _f32(*shape, dev):
    return torch.empty(shape, dtype=torch.float32, device=dev)


def _conv_stats(x, st_in, alpha, w, b, gamma, beta, reflect, name):
    _check(name, x, reflect)
    dev, c = x.device, 64
    vecs = [('b', b, (c,)), ('gamma', gamma, (c,)), ('beta', beta, (c,))]
    if st_in is not None:
        vecs += [('st1', st_in, (5, c)), ('alpha', alpha, (1,))]
    _expect(dev, [('x', x)], vecs, [('w', w)])
    y = torch.empty_like(x)
    h = torch.empty_like(x) if st_in is not None else None
    st = _f32(5, c, dev=dev)
    part = _f32(_tiles(x), 2, c, dev=dev)
    bsz, hh, ww, _ = x.shape
    with _build.on(dev):
        err = _build.library().srt_bn_conv_stats(
            x.data_ptr(), ptr(st_in), ptr(alpha), w.data_ptr(),
            b.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
            ptr(h), part.data_ptr(), st.data_ptr(), bsz, hh, ww,
            int(reflect), _build.stream(dev))
    _build.check(err, 'srt_bn_conv_stats')
    return y, h, st


def f1_conv_stats(u, w, b, gamma, beta, reflect: bool = False):
    """F1 (srtpu ``f1_conv_stats``): u (B, H, W, C) bf16, w (3, 3, C, C)
    bf16, b, gamma, beta (C,) f32 -> (y, st). On CUDA: conv + per-tile
    sums on K2's engine (EPI 9), then the fixed-order reduction and
    finalize (two launches).
    ``reflect``: REFLECT boundaries (H, W >= 2)."""
    if u.device.type == 'cpu':
        return f1_plain(u, w, b, gamma, beta, reflect)
    y, _, st = _conv_stats(u, None, None, w, b, gamma, beta, reflect,
                           'f1_conv_stats')
    _count(f1_conv_stats, reflect)
    return y, st


def f2_norm_act_conv_stats(y1, st1, alpha, w, b, gamma, beta,
                           reflect: bool = False):
    """F2 (srtpu ``f2_norm_act_conv_stats``): y1 and its statistics st1,
    the PReLU slope alpha (1,) f32 -> (y2, h1, st2); h1 =
    bf16(prelu(a1 * y1 + c1)) is saved for dW2. On CUDA: a pass writes h1,
    then F1's conv reads it. ``reflect``: the conv's ring mirrors h1."""
    if y1.device.type == 'cpu':
        return f2_plain(y1, st1, alpha, w, b, gamma, beta, reflect)
    y2, h1, st2 = _conv_stats(y1, st1, alpha, w, b, gamma, beta, reflect,
                              'f2_norm_act_conv_stats')
    _count(f2_norm_act_conv_stats, reflect)
    return y2, h1, st2


def f3_norm_skip(y, st, u):
    """F3 (srtpu ``f3_norm_skip``): out = bf16(a * y + c + u)."""
    if y.device.type == 'cpu':
        return f3_plain(y, st, u)
    _check('f3_norm_skip', y)
    dev = y.device
    _expect(dev, [('y', y), ('u', u)], [('st', st, (5, 64))])
    out = torch.empty_like(y)
    with _build.on(dev):
        err = _build.library().srt_bn_norm_skip(
            y.data_ptr(), st.data_ptr(), u.data_ptr(), out.data_ptr(),
            int(_npix(y)), _build.stream(dev))
    _build.check(err, 'srt_bn_norm_skip')
    f3_norm_skip.launches += 1
    return out


def b1_sums(g, y, st):
    """B1 (srtpu ``b1_sums``): sums (2, C) = sum g, sum g * xhat."""
    if g.device.type == 'cpu':
        return b1_plain(g, y, st)
    _check('b1_sums', g)
    dev = g.device
    _expect(dev, [('g', g), ('y', y)], [('st', st, (5, 64))])
    npix = int(_npix(g))
    part = _f32(-(-npix // CHUNK), 2, 64, dev=dev)
    sums = _f32(2, 64, dev=dev)
    with _build.on(dev):
        err = _build.library().srt_bn_sums(
            g.data_ptr(), y.data_ptr(), st.data_ptr(), part.data_ptr(),
            sums.data_ptr(), npix, _build.stream(dev))
    _build.check(err, 'srt_bn_sums')
    b1_sums.launches += 1
    return sums


def _bwd_conv(g, y, st, gamma, sums, w, y1, st1, alpha, skip, reflect,
              name):
    _check(name, g, reflect)
    dev, c = g.device, 64
    b2 = y1 is not None
    acts = [('g', g), ('y', y)] + ([('y1', y1)] if b2 else []) + (
        [('skip', skip)] if skip is not None else [])
    vecs = [('st', st, (5, c)), ('gamma', gamma, (c,)), ('sums', sums, (2, c))]
    if b2:
        vecs += [('st1', st1, (5, c)), ('alpha', alpha, (1,))]
    _expect(dev, acts, vecs, [('w', w)])
    nq = 4 if b2 else 1
    bsz, hh, ww, _ = g.shape
    dy, out = torch.empty_like(g), torch.empty_like(g)
    part = _f32(_tiles(g), 3, c, dev=dev) if b2 else None
    dbpart = _f32(-(-int(_npix(g)) // CHUNK), c, dev=dev)
    red = _f32(nq, c, dev=dev)
    dal = _f32(1, dev=dev) if b2 else None
    ring = _f32(bsz, 2 * (hh + ww), c, dev=dev) if reflect else None
    with _build.on(dev):
        err = _build.library().srt_bn_bwd_conv(
            g.data_ptr(), y.data_ptr(), st.data_ptr(), gamma.data_ptr(),
            sums.data_ptr(), w.data_ptr(), dy.data_ptr(), out.data_ptr(),
            ptr(y1), ptr(st1), ptr(alpha), ptr(skip), ptr(part),
            dbpart.data_ptr(), red.data_ptr(), ptr(dal), ptr(ring), bsz, hh,
            ww, int(reflect), _build.stream(dev))
    _build.check(err, 'srt_bn_bwd_conv')
    return out, dy, red, dal


def b2_call(g, y2, st2, gamma2, sums2, y1, st1, alpha, w2,
            reflect: bool = False):
    """B2 (srtpu ``b2_call``), as :func:`b2_plain`: w2 is the forward
    weight (K2's transposed engine reads it as it lies). On CUDA: a pass
    writes bf16 dy2 and db2's partials, the transposed conv runs at EPI
    10, and two reductions give db2 and BN1's sums. ``reflect``: a ring
    launch computes the transposed conv's values on the pad ring from the
    stored dy2, which B2 adds at their mirrored sources before its
    epilogue."""
    if g.device.type == 'cpu':
        return b2_plain(g, y2, st2, gamma2, sums2, y1, st1, alpha, w2,
                        reflect)
    dz, dy2, red, dal = _bwd_conv(g, y2, st2, gamma2, sums2, w2, y1, st1,
                                  alpha, None, reflect, 'b2_call')
    _count(b2_call, reflect)
    return dz, dy2, red[0], dal, red[2:]


def b3_call(dz, y1, st1, gamma1, sums1, w1, skip, reflect: bool = False):
    """B3 (srtpu ``b3_call``), as :func:`b3_plain`: w1 is the forward
    weight; skip None for the close conv; the transposed conv at EPI 11;
    ``reflect`` as :func:`b2_call`."""
    if dz.device.type == 'cpu':
        return b3_plain(dz, y1, st1, gamma1, sums1, w1, skip, reflect)
    du, dy1, red, _ = _bwd_conv(dz, y1, st1, gamma1, sums1, w1, None, None,
                                None, skip, reflect, 'b3_call')
    _count(b3_call, reflect)
    return du, dy1, red[0]


for _k in (f1_conv_stats, f2_norm_act_conv_stats, f3_norm_skip, b1_sums,
           b2_call, b3_call):
    _k.launches = 0
for _k in (f1_conv_stats, f2_norm_act_conv_stats, b2_call, b3_call):
    _k.launches_reflect = 0

# the kernel wrappers and their plain versions, by the role they play
KERNELS = dict(f1=f1_conv_stats, f2=f2_norm_act_conv_stats, f3=f3_norm_skip,
               b1=b1_sums, b2=b2_call, b3=b3_call, wgrad=conv_wgrad)
PLAIN = dict(f1=f1_plain, f2=f2_plain, f3=f3_plain, b1=b1_plain, b2=b2_plain,
             b3=b3_plain, wgrad=conv_wgrad_plain)


# ------------------------------------------------------- autograd ops


def _f32c(t):
    return t.float().contiguous()


class BNResBlockFn(torch.autograd.Function):
    """One SRResNet resblock in training mode (srtpu ``bn_resblock_cs``):
    out = BN2(conv(prelu(BN1(conv(u, w1) + b1)), w2) + b2) + u with batch
    statistics; ``reflect`` runs both convs with REFLECT boundaries
    (SRGAN's generator block). Takes f32 parameters (conv weights cast to
    u's dtype inside), returns ``(out, st1, st2)``, the statistics
    non-differentiable (their cotangents are ignored, as srtpu's are), and
    gives f32 grads for w1, b1, gamma1, beta1, alpha, w2, b2, gamma2,
    beta2."""

    @staticmethod
    def forward(ctx, u, w1, b1, ga1, be1, alpha, w2, b2, ga2, be2,
                plain: bool, reflect: bool = False):
        k = PLAIN if plain else KERNELS
        w1d, w2d = (w.to(u.dtype).contiguous() for w in (w1, w2))
        ga1f, ga2f, alf = _f32c(ga1), _f32c(ga2), _f32c(alpha)
        y1, st1 = k['f1'](u, w1d, _f32c(b1), ga1f, _f32c(be1), reflect)
        y2, h1, st2 = k['f2'](y1, st1, alf, w2d, _f32c(b2), ga2f, _f32c(be2),
                              reflect)
        out = k['f3'](y2, st2, u)
        ctx.save_for_backward(u, y1, h1, y2, st1, st2, w1d, w2d, ga1f, ga2f,
                              alf)
        ctx.plain, ctx.reflect = plain, reflect
        ctx.dtypes = tuple(t.dtype for t in (w1, b1, ga1, be1, alpha, w2, b2,
                                             ga2, be2))
        ctx.mark_non_differentiable(st1, st2)
        return out, st1, st2

    @staticmethod
    def backward(ctx, g, _st1, _st2):
        u, y1, h1, y2, st1, st2, w1d, w2d, ga1, ga2, al = ctx.saved_tensors
        k, rf = PLAIN if ctx.plain else KERNELS, ctx.reflect
        g = g.contiguous()
        sums2 = k['b1'](g, y2, st2)
        dz, dy2, db2, dal, sums1 = k['b2'](g, y2, st2, ga2, sums2, y1, st1,
                                           al, w2d, rf)
        du, dy1, db1 = k['b3'](dz, y1, st1, ga1, sums1, w1d, g, rf)
        dw2, _ = k['wgrad'](h1, dy2, reflect=rf)
        dw1, _ = k['wgrad'](u, dy1, reflect=rf)
        grads = (dw1, db1, sums1[1], sums1[0], dal, dw2, db2, sums2[1],
                 sums2[0])
        return (du, *(d.to(t) for d, t in zip(grads, ctx.dtypes)), None,
                None)


class BNCloseFn(torch.autograd.Function):
    """The trunk's closing conv + BN + global skip in training mode (srtpu
    ``bn_close_cs``): out = BN(conv(u, wc) + bc) + x_skip (``reflect`` as
    :class:`BNResBlockFn`). F1 + F3 forward, B1 + B3 (no skip) backward;
    x_skip's cotangent is g itself. Returns ``(out, st)``."""

    @staticmethod
    def forward(ctx, u, x_skip, wc, bc, gac, bec, plain: bool,
                reflect: bool = False):
        k = PLAIN if plain else KERNELS
        wcd, gacf = wc.to(u.dtype).contiguous(), _f32c(gac)
        y, st = k['f1'](u, wcd, _f32c(bc), gacf, _f32c(bec), reflect)
        out = k['f3'](y, st, x_skip)
        ctx.save_for_backward(u, y, st, wcd, gacf)
        ctx.plain, ctx.reflect = plain, reflect
        ctx.dtypes = tuple(t.dtype for t in (wc, bc, gac, bec))
        ctx.mark_non_differentiable(st)
        return out, st

    @staticmethod
    def backward(ctx, g, _st):
        u, y, st, wcd, gac = ctx.saved_tensors
        k, rf = PLAIN if ctx.plain else KERNELS, ctx.reflect
        g = g.contiguous()
        sums = k['b1'](g, y, st)
        du, dy, db = k['b3'](g, y, st, gac, sums, wcd, None, rf)
        dw, _ = k['wgrad'](u, dy, reflect=rf)
        grads = (dw, db, sums[1], sums[0])
        return (du, g, *(d.to(t) for d, t in zip(grads, ctx.dtypes)), None,
                None)


def bn_resblock(u, w1, b1, ga1, be1, alpha, w2, b2, ga2, be2,
                plain: bool = False, reflect: bool = False):
    """One resblock in training mode (:class:`BNResBlockFn`): returns
    ``(out, (mean1, var1, mean2, var2))``. ``plain`` runs the plain
    versions on any device; ``reflect`` REFLECT conv boundaries."""
    out, st1, st2 = BNResBlockFn.apply(u, w1, b1, ga1, be1, alpha, w2, b2,
                                       ga2, be2, plain, reflect)
    return out, (st1[0], st1[1], st2[0], st2[1])


def bn_close(u, x_skip, wc, bc, gac, bec, plain: bool = False,
             reflect: bool = False):
    """The closing conv + BN + skip in training mode (:class:`BNCloseFn`):
    returns ``(out, (mean, var))``."""
    out, st = BNCloseFn.apply(u, x_skip, wc, bc, gac, bec, plain, reflect)
    return out, (st[0], st[1])


# ------------------------------------------------------ the trunk op


def trunk_fwd_calls(k: dict, x, w1s, b1s, g1s, be1s, alphas, w2s, b2s, g2s,
                    be2s, wc, bc, gc, bec, reflect: bool = False):
    """:func:`bn_trunk_fwd` as calls of the per-function table ``k``
    (``PLAIN`` or ``KERNELS``), block after block, then the close."""
    acts, ys, sts = [x], [], []
    u = x
    for i in range(w1s.shape[0]):
        y1, st1 = k['f1'](u, w1s[i], b1s[i], g1s[i], be1s[i], reflect)
        y2, h1, st2 = k['f2'](y1, st1, alphas[i].reshape(1), w2s[i], b2s[i],
                              g2s[i], be2s[i], reflect)
        u = k['f3'](y2, st2, u)
        acts += [h1, u]
        ys += [y1, y2]
        sts += [st1, st2]
    yc, stc = k['f1'](u, wc, bc, gc, bec, reflect)
    return (k['f3'](yc, stc, x), torch.stack(acts), torch.stack(ys + [yc]),
            torch.stack(sts + [stc]))


def trunk_bwd_calls(k: dict, acts, ys, sts, g, w1s, w2s, wc, g1s, g2s, gc,
                    alphas, reflect: bool = False):
    """:func:`bn_trunk_bwd` as calls of the per-function table ``k``: the
    close's B1 and B3, then blocks L - 1 .. 0 (B1, B2, B3), dx = block
    0's du + g, and every conv's weight grads from its saved input and
    bf16 dy."""
    n = w1s.shape[0]
    c = 2 * n
    dys, dbs, sums, dal = [None] * (c + 1), [None] * (c + 1), \
        [None] * (c + 1), [None] * n
    sums[c] = k['b1'](g, ys[c], sts[c])
    gcur, dys[c], dbs[c] = k['b3'](g, ys[c], sts[c], gc, sums[c], wc, None,
                                   reflect)
    for i in reversed(range(n)):
        k1, k2 = 2 * i, 2 * i + 1
        sums[k2] = k['b1'](gcur, ys[k2], sts[k2])
        dz, dys[k2], dbs[k2], dal[i], sums[k1] = k['b2'](
            gcur, ys[k2], sts[k2], g2s[i], sums[k2], ys[k1], sts[k1],
            alphas[i].reshape(1), w2s[i], reflect)
        gcur, dys[k1], dbs[k1] = k['b3'](dz, ys[k1], sts[k1], g1s[i],
                                         sums[k1], w1s[i], gcur, reflect)
    dys = torch.stack(dys)
    dws, _ = k['wgrad'](acts, dys, reflect=reflect)
    return (gcur + g, dys, dws, torch.stack(dbs), torch.stack(sums),
            torch.cat(dal))


def bn_trunk_fwd_plain(*args, **kw):
    """Plain version of :func:`bn_trunk_fwd`: the per-function plain
    versions in its order (:func:`trunk_fwd_calls` over ``PLAIN``)."""
    return trunk_fwd_calls(PLAIN, *args, **kw)


def bn_trunk_bwd_plain(*args, **kw):
    """Plain version of :func:`bn_trunk_bwd` (:func:`trunk_bwd_calls`
    over ``PLAIN``)."""
    return trunk_bwd_calls(PLAIN, *args, **kw)


def fwd_plan(n_blocks: int, reflect: bool) -> tuple:
    """bn_block.cu's launches for a trunk forward of ``n_blocks`` blocks
    (srt_bn_trunk_fwd), in order, each (kernel, EPI, transposed, reflect,
    what it writes): 'engine' K2's engine over the 8 x 16 tiles at K4's
    EPI, 'reduce' the fixed-order reduction (and finalize), 'act' the
    h1 pass, 'norm_skip' F3, 'copy' a device copy."""
    rf = bool(reflect)
    conv = (('engine', EPI_F, False, rf, ('y', 'part')),
            ('reduce', None, False, False, ('st',)))
    block = (conv + (('act', None, False, False, ('h1',)),) + conv
             + (('norm_skip', None, False, False, ('u',)),))
    return ((('copy', None, False, False, ('acts',)),) + block * n_blocks
            + conv + (('norm_skip', None, False, False, ('out',)),))


def bwd_plan(n_blocks: int, reflect: bool) -> tuple:
    """bn_block.cu's launches for a trunk backward (srt_bn_trunk_bwd), as
    :func:`fwd_plan`: 'sums' B1, 'dy' a BN backward's bf16 dy and db's
    partials, 'ring' REFLECT's fold ring, the transposed convs at EPI 10
    (B2) and 11 (B3), then one 'wgrad' launch of 2 L + 1 stacked jobs (W
    in REFLECT mode for K4r) and one 'reduce' of every db."""
    rf = bool(reflect)
    ring = (('ring', None, False, True, ('ring',)),) if rf else ()
    sums = (('sums', None, False, False, ('part',)),
            ('reduce', None, False, False, ('sums',)))
    dy = (('dy', None, False, False, ('dy', 'dbpart')),) + ring
    close = sums + dy + (('engine', EPI_B3, True, rf, ('du',)),)
    block = (sums + dy + (('engine', EPI_B2, True, rf, ('dz', 'part')),
                          ('reduce', None, False, False, ('sums', 'dal')))
             + dy + (('engine', EPI_B3, True, rf, ('du',)),))
    return (close + block * n_blocks
            + (('wgrad', None, False, rf, ('dws',)),
               ('reduce', None, False, False, ('dbs',))))


def fn_plan(kind: str, reflect: bool) -> tuple:
    """The launches of one per-function wrapper ('f1' ... 'b3'), as
    :func:`fwd_plan`."""
    rf = bool(reflect)
    conv = (('engine', EPI_F, False, rf, ('y', 'part')),
            ('reduce', None, False, False, ('st',)))
    dy = (('dy', None, False, False, ('dy', 'dbpart')),) + (
        (('ring', None, False, True, ('ring',)),) if rf else ())
    db = (('reduce', None, False, False, ('db',)),)
    return {'f1': conv,
            'f2': (('act', None, False, False, ('h1',)),) + conv,
            'f3': (('norm_skip', None, False, False, ('out',)),),
            'b1': (('sums', None, False, False, ('part',)),
                   ('reduce', None, False, False, ('sums',))),
            'b2': dy + (('engine', EPI_B2, True, rf, ('dz', 'part')),
                        ('reduce', None, False, False, ('sums', 'dal')))
            + db,
            'b3': dy + (('engine', EPI_B3, True, rf, ('du',)),) + db}[kind]


def _trunk_expect(dev, x, n, weights, vecs, alphas, close):
    """The trunk op's operands: x (B, H, W, 64) bf16; (L, 3, 3, 64, 64)
    bf16 weights; (L, 64) f32 vectors; alphas (L) or (L, 1) f32; the
    close's (3, 3, 64, 64) bf16 weight and (64) f32 vectors."""
    _build.expect(x, 'x', torch.bfloat16, tuple(x.shape), dev)
    for name, t in weights:
        _build.expect(t, name, torch.bfloat16, (n, 3, 3, 64, 64), dev)
    for name, t in vecs:
        _build.expect(t, name, torch.float32, (n, 64), dev, aligned=False)
    _build.expect(alphas, 'alphas', torch.float32, tuple(alphas.shape), dev,
                  aligned=False)
    if alphas.numel() != n:
        raise ValueError(f'alphas has {alphas.numel()} slopes for {n} '
                         f'blocks')
    wc, *cv = close
    _build.expect(wc, 'wc', torch.bfloat16, (3, 3, 64, 64), dev)
    for i, t in enumerate(cv):
        _build.expect(t, f'close vector {i}', torch.float32, (64,), dev,
                      aligned=False)


def bn_trunk_fwd(x, w1s, b1s, g1s, be1s, alphas, w2s, b2s, g2s, be2s, wc,
                 bc, gc, bec, reflect: bool = False):
    """A BN trunk's training-mode forward, L blocks (weights stacked L
    deep, bf16; vectors f32) and the close conv + BN + the skip x, in one
    host call (srt_bn_trunk_fwd). Returns (out, acts, ys, sts): acts (2 L
    + 1, B, H, W, C) every conv's input (block i's u in slot 2 i, its h1
    in 2 i + 1, the close's u in 2 L), ys their y, sts (2 L + 1, 5, C)
    their batch statistics. CPU tensors: :func:`bn_trunk_fwd_plain`.
    Counts one call on ``launches`` (SAME) or ``launches_reflect``."""
    if x.device.type == 'cpu':
        return bn_trunk_fwd_plain(x, w1s, b1s, g1s, be1s, alphas, w2s, b2s,
                                  g2s, be2s, wc, bc, gc, bec, reflect)
    _check('bn_trunk_fwd', x, reflect)
    dev, n = x.device, w1s.shape[0]
    _trunk_expect(dev, x, n, [('w1s', w1s), ('w2s', w2s)],
                  [('b1s', b1s), ('g1s', g1s), ('be1s', be1s), ('b2s', b2s),
                   ('g2s', g2s), ('be2s', be2s)], alphas, (wc, bc, gc, bec))
    bsz, hh, ww, c = x.shape
    acts = x.new_empty((2 * n + 1, bsz, hh, ww, c))
    ys = torch.empty_like(acts)
    out = torch.empty_like(x)
    f32 = _f32((2 * n + 1) * 5 * c + _tiles(x) * 2 * c, dev=dev)
    sts = f32[:(2 * n + 1) * 5 * c].view(2 * n + 1, 5, c)
    with _build.on(dev):
        err = _build.library().srt_bn_trunk_fwd(
            x.data_ptr(), w1s.data_ptr(), b1s.data_ptr(), g1s.data_ptr(),
            be1s.data_ptr(), alphas.data_ptr(), w2s.data_ptr(),
            b2s.data_ptr(), g2s.data_ptr(), be2s.data_ptr(), wc.data_ptr(),
            bc.data_ptr(), gc.data_ptr(), bec.data_ptr(), acts.data_ptr(),
            ys.data_ptr(), sts.data_ptr(), f32[sts.numel():].data_ptr(),
            out.data_ptr(), n, bsz, hh, ww, int(reflect), _build.stream(dev))
    _build.check(err, 'srt_bn_trunk_fwd')
    _count(_TRUNK[0], reflect)
    return out, acts, ys, sts


def bn_trunk_bwd(acts, ys, sts, g, w1s, w2s, wc, g1s, g2s, gc, alphas,
                 reflect: bool = False):
    """The backward of :func:`bn_trunk_fwd` from what it returned and g,
    the cotangent of out, in one host call (srt_bn_trunk_bwd). Returns
    (dx, dys, dws, dbs, sums, dal): dys (2 L + 1, B, H, W, C) every conv's
    bf16 dy in acts' order, dws (2 L + 1, 3, 3, C, C) their weight grads,
    dbs (2 L + 1, C) their bias grads (sums of the f32 dy), sums (2 L + 1,
    2, C) each BN's S_g and S_gx (its beta's and gamma's grads), dal (L)
    each PReLU slope's grad. CPU tensors: :func:`bn_trunk_bwd_plain`."""
    if g.device.type == 'cpu':
        return bn_trunk_bwd_plain(acts, ys, sts, g, w1s, w2s, wc, g1s, g2s,
                                  gc, alphas, reflect)
    _check('bn_trunk_bwd', g, reflect)
    dev, n = g.device, w1s.shape[0]
    bsz, hh, ww, c = g.shape
    k = 2 * n + 1
    _trunk_expect(dev, g, n, [('w1s', w1s), ('w2s', w2s)],
                  [('g1s', g1s), ('g2s', g2s)], alphas, (wc, gc))
    for name, t in (('acts', acts), ('ys', ys)):
        _build.expect(t, name, torch.bfloat16, (k, bsz, hh, ww, c), dev)
    _build.expect(sts, 'sts', torch.float32, (k, 5, c), dev)
    cluster, clusters = wgrad_parts(bsz, hh, ww, c, c, 1, 3, k)
    ws = (wgrad_workspace(k, cluster, clusters, c, c, 3, dev)
          if clusters > 1 else None)
    npix = bsz * hh * ww
    nch = -(-npix // CHUNK)
    # the bf16 dy of every conv, then the cotangents between blocks and dz
    bf = g.new_empty((k + 3, bsz, hh, ww, c))
    dx = torch.empty_like(g)
    sizes = dict(dws=k * 9 * c * c, dbs=k * c, sums=k * 2 * c, dal=n,
                 ring=bsz * 2 * (hh + ww) * c if reflect else 0,
                 part=_tiles(g) * 3 * c, sp=nch * 2 * c, dbpart=k * nch * c,
                 dbw=k * c)
    # each part 128-byte aligned (the kernels read the ring as float2)
    f32 = _f32(sum(-(-n // 32) * 32 for n in sizes.values()), dev=dev)
    v, at = {}, 0
    for name, size in sizes.items():
        v[name] = f32[at:at + size]
        at += -(-size // 32) * 32
    with _build.on(dev):
        err = _build.library().srt_bn_trunk_bwd(
            acts.data_ptr(), ys.data_ptr(), sts.data_ptr(), g.data_ptr(),
            w1s.data_ptr(), w2s.data_ptr(), wc.data_ptr(), g1s.data_ptr(),
            g2s.data_ptr(), gc.data_ptr(), alphas.data_ptr(), bf.data_ptr(),
            bf[k].data_ptr(), bf[k + 2].data_ptr(),
            v['ring'].data_ptr() if reflect else None,
            v['part'].data_ptr(), v['sp'].data_ptr(), v['dbpart'].data_ptr(),
            ws and ws[0].data_ptr(), ws and ws[1].data_ptr(),
            v['dbw'].data_ptr(), v['dws'].data_ptr(), v['dbs'].data_ptr(),
            v['sums'].data_ptr(), v['dal'].data_ptr(), dx.data_ptr(), n,
            bsz, hh, ww, int(reflect), cluster, clusters, _build.stream(dev))
    _build.check(err, 'srt_bn_trunk_bwd')
    _count(_TRUNK[1], reflect)
    return (dx, bf[:k], v['dws'].view(k, 3, 3, c, c), v['dbs'].view(k, c),
            v['sums'].view(k, 2, c), v['dal'])


# the trunk op's wrappers, whose counters each call adds to (a caller may
# wrap the module's names)
_TRUNK = (bn_trunk_fwd, bn_trunk_bwd)
for _k in _TRUNK:
    _k.launches = _k.launches_reflect = 0


class BNTrunkFn(torch.autograd.Function):
    """A BN trunk in training mode (srtpu's ``CSBNTrunk``: L
    ``bn_resblock_cs`` and ``bn_close_cs``), one host call each way:
    out = close(blocks(x)) + x with batch statistics; ``reflect`` as
    :class:`BNResBlockFn`. Takes the stacked f32 parameters of
    :class:`~srtpu_torch.models.common.BNTrunk` (conv weights cast to x's
    dtype inside), returns ``(out, sts)``: sts (2 L + 1, 5, C), each BN's
    batch statistics in acts' order (non-differentiable), and f32 grads
    for every parameter. ``plain`` runs the plain versions."""

    @staticmethod
    def forward(ctx, x, w1, b1, ga1, be1, alpha, w2, b2, ga2, be2, wc, bc,
                gac, bec, plain: bool, reflect: bool = False):
        w1d, w2d, wcd = (w.to(x.dtype).contiguous() for w in (w1, w2, wc))
        vf = [_f32c(t) for t in (b1, ga1, be1, alpha, b2, ga2, be2, bc, gac,
                                 bec)]
        fwd = bn_trunk_fwd_plain if plain else bn_trunk_fwd
        out, acts, ys, sts = fwd(x, w1d, *vf[:4], w2d, *vf[4:7], wcd,
                                 *vf[7:], reflect=reflect)
        ctx.save_for_backward(acts, ys, sts, w1d, w2d, wcd, vf[1], vf[5],
                              vf[8], vf[3])
        ctx.plain, ctx.reflect = plain, reflect
        ctx.meta = tuple((t.dtype, t.shape) for t in (
            w1, b1, ga1, be1, alpha, w2, b2, ga2, be2, wc, bc, gac, bec))
        ctx.mark_non_differentiable(sts)
        return out, sts

    @staticmethod
    def backward(ctx, g, _sts):
        acts, ys, sts, w1d, w2d, wcd, ga1, ga2, gac, al = ctx.saved_tensors
        bwd = bn_trunk_bwd_plain if ctx.plain else bn_trunk_bwd
        dx, _, dws, dbs, sums, dal = bwd(acts, ys, sts, g.contiguous(), w1d,
                                         w2d, wcd, ga1, ga2, gac, al,
                                         reflect=ctx.reflect)
        c = 2 * w1d.shape[0]
        grads = (dws[0:c:2], dbs[0:c:2], sums[0:c:2, 1], sums[0:c:2, 0], dal,
                 dws[1:c:2], dbs[1:c:2], sums[1:c:2, 1], sums[1:c:2, 0],
                 dws[c], dbs[c], sums[c, 1], sums[c, 0])
        return (dx, *(d.reshape(shape).to(dt)
                      for d, (dt, shape) in zip(grads, ctx.meta)),
                None, None)


def bn_trunk(x, w1, b1, ga1, be1, alpha, w2, b2, ga2, be2, wc, bc, gac, bec,
             plain: bool = False, reflect: bool = False):
    """A BN trunk in training mode (:class:`BNTrunkFn`): the stacked
    block parameters (L deep), the close's, x in the compute dtype.
    Returns ``(out, sts)``."""
    return BNTrunkFn.apply(x, w1, b1, ga1, be1, alpha, w2, b2, ga2, be2, wc,
                           bc, gac, bec, plain, reflect)


# --------------------------------------------------- eval mode (XLA's)


def _conv_ref(x, w, b, reflect: bool = False):
    """srtpu ``conv3x3_reference`` (``conv3x3_reflect_reference`` with
    reflect): f32 conv + f32 bias, one rounding to x's dtype (a stock
    PyTorch conv, not a kernel of the port)."""
    xc = x.permute(0, 3, 1, 2).float()
    if reflect:
        xc = F.pad(xc, (1, 1, 1, 1), mode='reflect')
    y = F.conv2d(xc, w.permute(3, 2, 0, 1).float(),
                 padding=0 if reflect else w.shape[0] // 2)
    # NHWC-contiguous whatever layout the conv chose: the tail's kernels
    # take contiguous tensors
    return (y.permute(0, 2, 3, 1) + b.float()).to(x.dtype).contiguous()


def _bn_apply_ref(y, mean, var, gamma, beta):
    """srtpu ``bn_apply_ref``: (a * y + c) in f32, rounded to y's dtype."""
    inv = torch.rsqrt(var + EPS)
    a = gamma * inv
    c = beta - mean * gamma * inv
    return (a * y.float() + c).to(y.dtype)


def bn_resblock_ref(u, w1, b1, ga1, be1, alpha, w2, b2, ga2, be2, rm1, rv1,
                    rm2, rv2, reflect: bool = False):
    """Eval-mode resblock with running statistics (srtpu
    ``bn_resblock_ref``, train=False): each conv rounds once, BN apply
    rounds again, PReLU (f32 slope) a third time, the skip is a bf16 add.
    Weights f32 or in u's dtype; they are cast to u's dtype."""
    dt = u.dtype
    h1 = _bn_apply_ref(_conv_ref(u, w1.to(dt), b1, reflect), rm1, rv1, ga1,
                       be1)
    h1 = torch.where(h1 >= 0, h1, alpha.float() * h1).to(dt)
    y2 = _conv_ref(h1, w2.to(dt), b2, reflect)
    return _bn_apply_ref(y2, rm2, rv2, ga2, be2) + u


def bn_close_ref(u, x_skip, wc, bc, gac, bec, rm, rv, reflect: bool = False):
    """Eval-mode closing conv + BN + skip (srtpu ``bn_close_ref``)."""
    y = _conv_ref(u, wc.to(u.dtype), bc, reflect)
    return _bn_apply_ref(y, rm, rv, gac, bec) + x_skip
