"""K9d's launch plan is the one chip_smoke.py holds on the card, its
epilogues round and store as the plain version does, and the plain
version is srtpu's Pallas backward.

K9d (``ops.resblock.resblock_bwd_fused``, the backward of
``resblock_fused_v3``) runs its two transposed 3x3 convs on K2's wgmma
engine (``csrc/conv_sm90.cuh``) over bf16 [hi | lo] pairs at cin 128,
the forward's weights read as they lie for both halves: dh1 at ``EPI``
16 (h1's mask, the split into hi and lo, the pair stored), dx at ``EPI``
17 (the sums + g, one rounding); its weight grads on W's engine at 64 ->
128, then a fold of the halves. ``bwd_plan`` is its launches in plain
Python, as ``csrc/resblock_bwd.cu`` makes them. Here, on the CPU (where
the wrapper runs its plain version):

- ``resblock_fused_v3`` forward and backward at a tiny size, res_scale
  1.0 and 0.1, records every K9d call; each call's plan must be among
  those of the calls chip_smoke.py's phase 2j holds on the card
  (``chip_smoke.k9d_held``), one call a backward.
- The plan follows the engines' rules: K2's 3x3 plan, N = K2's own pick
  for the class (``engine_bn``), transposed, cin 128; K9d's own
  epilogues and none of the other kernels' (the ``EPI`` values
  ``resblock_bwd.cu`` passes, in order); its W jobs a class W takes.
- An emulation of the launches in plain torch (g * res_scale split into
  bf16 hi and lo; the f32 conv over the pair with the weight stacked
  twice; h1's mask, then dh1's split; the second conv over dh1's pair
  plus g, one rounding; the weight grads over the pairs, then the fold)
  against ``resblock_bwd_fused_plain``: dx within one bf16 step of its
  largest magnitude, dW1, db1, dW2, db2 within 1e-4 of theirs; the
  stored dh1 hi is bf16 of the emulated f32 dh1 bit for bit and hi + lo
  is that dh1 to 2^-17; f32 and bf16 inputs, res_scale 1.0 and 0.1,
  H x W off the 8 x 16 tile (6 x 5, 20 x 28) and on it (8 x 16).
- ``resblock_bwd_fused_plain`` against srtpu's ``resblock_bwd_fused``
  itself (Pallas in interpret mode) on the same numpy-seeded x, the h1
  of srtpu's ``resblock_fused_h1``, g, W1 and W2: f32 within 1e-5 of
  each output's largest magnitude; bf16 dx within one bf16 step, the f32
  grads within 1e-5.

One test per case, so each counts.
"""

import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from srtpu.ops import resblock as jrb
from srtpu_torch.ops.conv import conv_f32
from srtpu_torch.ops.layout import w_t
from srtpu_torch.ops.rdn import engine_bn
from srtpu_torch.ops.wgrad import _kernel_takes

k8a = importlib.import_module('srtpu_torch.ops.resblock')
CSRC = Path(k8a.__file__).resolve().parent / 'csrc'
torch.set_num_threads(1)

C = 64
SCALES = [1.0, 0.1]
DTYPES = {'f32': (jnp.float32, torch.float32),
          'bf16': (jnp.bfloat16, torch.bfloat16)}


def _u(rng, bound, *shape):
    return rng.uniform(-bound, bound, shape).astype(np.float32)


@pytest.mark.parametrize('res_scale', SCALES)
def test_v3_plans_are_held_by_chip_smoke(monkeypatch, res_scale):
    seen = []
    bwd = k8a.resblock_bwd_fused

    def rec(x, h1, g, w1, w2, rs):
        seen.append(float(rs))
        return bwd(x, h1, g, w1, w2, rs)

    monkeypatch.setattr(k8a, 'resblock_bwd_fused', rec)
    rng = np.random.default_rng(3)
    cb = (9 * C) ** -0.5
    x = torch.from_numpy(_u(rng, 1.0, 2, 6, 5, C)).bfloat16() \
        .requires_grad_()
    prm = [torch.from_numpy(_u(rng, cb, *s)).requires_grad_()
           for s in ((3, 3, C, C), (C,), (3, 3, C, C), (C,))]
    k8a.resblock_fused_v3(x, *prm, res_scale).float().square().mean() \
        .backward()
    assert seen == [res_scale]
    held = {k8a.bwd_plan(s) for _, s in chip_smoke.k9d_held()}
    assert k8a.bwd_plan(seen[0]) in held


@pytest.mark.parametrize('res_scale', SCALES)
def test_k9d_plan_follows_the_engines(res_scale):
    plan = k8a.bwd_plan(res_scale)
    assert [lc[0] for lc in plan] == ['split', 'engine', 'engine', 'wgrad',
                                      'wgrad', 'fold']
    split = plan[0]
    assert split[3:5] == (C, 2 * C) and split[6] == float(res_scale)
    engine = [lc for lc in plan if lc[0] == 'engine']
    for name, epi, k, cin, cout, trans, s, writes in engine:
        assert k == 3 and trans and cin == 2 * C and cout == C
        assert engine_bn(cout) == cout == 64      # K2's plan: N = 64
    assert [lc[7] for lc in engine] == [('dh1p',), ('dx',)]
    # K9d's own epilogues, none of the other kernels' (0-15), in the
    # order resblock_bwd.cu launches them
    epis = [lc[1] for lc in engine]
    assert epis == [k8a.EPI_DH1, k8a.EPI_DX] == [16, 17]
    src = (CSRC / 'resblock_bwd.cu').read_text()
    assert [int(e) for e in re.findall(r'run_k9d<(\d+)>', src)] == epis
    assert 'tile_conv' not in src and not (CSRC / 'tile_conv.cuh').exists()
    for name, epi, k, cin, cout, *_ in plan:
        if name == 'wgrad':
            assert (k, cin, cout) == (3, C, 2 * C)
            assert _kernel_takes(cin, cout, 1, k)


def _pair(v):
    """EPI 12's split of an f32 tensor: hi = bf16(v), lo = bf16(v - hi)."""
    hi = v.bfloat16()
    return hi, (v - hi.float()).bfloat16()


def _corr(x, g):
    """W's dW (3, 3, cin, cout) and db (cout) of x and g, f32 sums."""
    w0 = torch.zeros((3, 3, x.shape[-1], g.shape[-1]))
    return k8a._conv_vjp(x.float(), w0, g.float())[1], g.float().sum(
        (0, 1, 2))


def _fold(dw, db):
    """rb_fold_kernel: the hi and lo halves of the 128 columns added."""
    return dw[..., :C] + dw[..., C:], db[:C] + db[C:]


def _emulate_k9d(x, h1, g, w1, w2, res_scale):
    """resblock_bwd.cu's launches in plain torch. Returns (dx, dW1, db1,
    dW2, db2, dh1, hi, lo): dh1 the f32 masked sums of the first conv,
    (hi, lo) the pair its epilogue stores."""
    gs = g.float() * float(np.float32(res_scale))
    gsp = torch.cat(_pair(gs), -1)                  # rb_split_kernel
    # EPI 16: the transposed conv over [hi | lo], W2 for both halves
    w2p = torch.cat([w_t(w2)] * 2, -2).bfloat16()
    dh1 = torch.where(h1.float() > 0, conv_f32(gsp, w2p), 0.0)
    hi, lo = _pair(dh1)
    dh1p = torch.cat((hi, lo), -1)
    # EPI 17: the sums + f32(g), one rounding
    w1p = torch.cat([w_t(w1)] * 2, -2).bfloat16()
    dx = (conv_f32(dh1p, w1p) + g.float()).to(x.dtype)
    dw1, db1 = _fold(*_corr(x, dh1p))
    dw2, db2 = _fold(*_corr(h1, gsp))
    return dx, dw1, db1, dw2, db2, dh1, hi, lo


def _within(got, ref, tol, name):
    top = ref.float().abs().max().item()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * top, (name, err, top)


SHAPES = {'6x5': (6, 5), '20x28': (20, 28), '8x16': (8, 16)}


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('res_scale', SCALES)
@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_k9d_epilogues_emulated_match_the_plain_version(dtype, res_scale,
                                                        shape):
    """The weights hold bf16 values, as on the card: every product with
    hi and lo is exact, and the pairs carry gs and dh1 to 2^-17."""
    tdt = DTYPES[dtype][1]
    h, w = SHAPES[shape]
    rng = np.random.default_rng(h * 100 + w)
    cb = (9 * C) ** -0.5
    x, g = (torch.from_numpy(_u(rng, 1.0, 2, h, w, C)).to(tdt)
            for _ in 'xg')
    h1 = torch.from_numpy(_u(rng, 1.0, 2, h, w, C)).clamp_min(0).to(tdt)
    w1, w2 = (torch.from_numpy(_u(rng, cb, 3, 3, C, C)).bfloat16().to(tdt)
              for _ in 'ab')
    got = _emulate_k9d(x, h1, g, w1, w2, res_scale)
    ref = k8a.resblock_bwd_fused_plain(x, h1, g, w1, w2, res_scale)
    assert got[0].dtype == ref[0].dtype == tdt
    _within(got[0], ref[0], 2.0 ** -7, 'dx')
    for name, a, b in zip(('dW1', 'db1', 'dW2', 'db2'), got[1:5], ref[1:]):
        assert a.shape == b.shape, name
        _within(a, b, 1e-4, name)
    dh1, hi, lo = got[5:]
    assert torch.equal(hi, dh1.bfloat16())
    resid = (dh1 - hi.float() - lo.float()).abs()
    assert bool((resid <= 2.0 ** -17 * dh1.abs()).all())
    # dh1 from the pair against the f32 conv VJP of the plain version
    gs = g.float() * res_scale
    dh1_ref = k8a._conv_vjp(h1.float(), w2.float(), gs)[0] \
        * (h1.float() > 0)
    _within(dh1, dh1_ref, 1e-5, 'dh1')


@pytest.mark.parametrize('res_scale', SCALES)
@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_plain_matches_srtpu_pallas_backward(dtype, res_scale):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(19)
    b, h, w = 2, 6, 5
    cb = (9 * C) ** -0.5
    x = _u(rng, 1.0, b, h, w, C)
    g = _u(rng, 1.0, b, h, w, C)
    w1, w2 = _u(rng, cb, 3, 3, C, C), _u(rng, cb, 3, 3, C, C)
    b1, b2 = _u(rng, cb, C), _u(rng, cb, C)
    jx, jg, jw1, jw2 = (jnp.asarray(a, jdt) for a in (x, g, w1, w2))
    _, jh1 = jrb.resblock_fused_h1(jx, jw1, jnp.asarray(b1), jw2,
                                   jnp.asarray(b2), res_scale,
                                   interpret=True)
    refs = jrb.resblock_bwd_fused(jx, jh1, jg, jw1, jw2, res_scale,
                                  interpret=True)

    def tt(a):
        return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))
                                ).to(tdt)
    got = k8a.resblock_bwd_fused_plain(tt(jx), tt(jh1), tt(jg), tt(jw1),
                                       tt(jw2), res_scale)
    names = ('dx', 'dW1', 'db1', 'dW2', 'db2')
    for i, (name, t, r) in enumerate(zip(names, got, refs)):
        ref = torch.from_numpy(np.asarray(r, np.float32)).reshape(t.shape)
        assert t.dtype == (tdt if i == 0 else torch.float32), name
        tol = 2.0 ** -7 if (i == 0 and dtype == 'bf16') else 1e-5
        _within(t, ref, tol, name)
