"""K7's launch plans cover what WDSR-B launches, the bottleneck's padding
is exact, the trunk op is its blocks, and K7's 3x3 epilogue rounds as the
plain forward does.

K7 (``ops.wdsr``: ``wdsr_trunk_fwd`` and ``wdsr_trunk_bwd``, one host
call per trunk each way; ``wdsr_fwd`` / ``wdsr_bwd`` a trunk of one) runs
the 1x1 pair as a chained-GEMM kernel and the 3x3 on K2's engine
(``csrc/conv_sm90.cuh``), its backward's dh2 on K2's transposed engine,
the pointwise backward as the chain run backwards and the weight grads on
W's engine (``csrc/wgrad.cu``); K8c is the chain's hi / lo form and the
3x3 over [hi | lo]. ``fwd_plan`` and ``bwd_plan`` are its launches in
plain Python, as ``csrc/wdsr.cu`` makes them. Here, on the CPU (where the
wrappers run their plain versions):

- WDSR-B (128 features, 16 blocks, x4) on a tiny image, on the 'cs'
  route in eval and train mode and on the True route (K8c) in eval
  mode, records every K7 / K8c call; each call's plan must be among those
  of the calls chip_smoke.py's phases 2g and 2i hold on the card
  (``chip_smoke.k7_held``).
- Each plan follows the engines' rules: the 3x3s on K2's plan at N =
  cout (64 or 128, ``run_3x3_wide``) at K7's own epilogues (8 forward,
  7 transposed), none of K6's (1-3), K5's (4, 5) or K1's (6); W at k = 1 only
  at 64-multiples (its K6 mode), at k = 3 at what ``srt_conv_wgrad``
  takes; the chains at C -> Lp = C, the kernels' width (64 or 128,
  narrower C padded to it); a gs step a block only where res_scale is
  not 1; the backward reads the h2 the forward saved.
- The plain versions with the bottleneck padded 112 -> 128 (the
  kernels' Lp) give the same output and the same unpadded gradients
  (within 1e-6 of each tensor's largest magnitude: f32 sums whose
  blocking over the longer K may differ), and exactly zero gradients in
  the padding.
- The plain versions with C 16, 48 and 80 zero-padded to the kernels'
  64 or 128 (``widen``: x's channels, W1's rows and columns, W3's output
  channels, b3) give the same output and the same gradients in the
  unpadded entries (within 1e-6 of each tensor's largest magnitude), as
  the kernel wrappers run such widths.
- The trunk op (``wdsr_trunk``) equals its blocks called one by one
  (``wdsr_block``, a trunk of one), output and every gradient bit for
  bit, at 3 blocks and res_scale 1.0 and 0.1.
- The trunk op's output and gradients against ``jax.grad`` of srtpu's
  ``wdsr_block_cs`` applied block after block (Pallas in interpret
  mode), as ``tests/test_torch_wdsr.py`` holds one block: f32 within
  1e-4, bf16 within 2^-6 of each tensor's largest magnitude (the
  per-block limits: both round at the same points).
- An f32 emulation of the 3x3 epilogue (``k7_epilogue``, ``EPI`` 8:
  bf16(f32(f32(v * res_scale) + x)), v = sums + b3) equals
  ``wdsr_fwd_plain``'s output bit for bit for every finite bf16 x, at
  res_scale 1.0, 0.5 and 0.1.

One test per case, so each counts.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from srtpu.ops import cs_conv, wdsr_cs
from srtpu_torch.models import create_model
from srtpu_torch.ops.rdn import engine_bn
from srtpu_torch.ops.wgrad import _kernel_takes

k7 = importlib.import_module('srtpu_torch.ops.wdsr')
k8c = importlib.import_module('srtpu_torch.ops.wdsr_block')
torch.set_num_threads(1)


def plan(kind, c, n_blocks, save, scale) -> tuple:
    """One K7 / K8c call's launches."""
    if kind == 'fwd':
        return kind, k7.fwd_plan(c, save, scale, n_blocks)
    if kind == 'k8c':
        return kind, k7.fwd_plan(c, False, scale, n_blocks, hilo=True)
    return kind, k7.bwd_plan(c, scale, n_blocks)


def held() -> set:
    """The plans of the calls chip_smoke's phases hold on the card."""
    return {plan(*case) for case in chip_smoke.k7_held()}


def record(monkeypatch) -> set:
    """Record each K7 / K8c call as (kind, C, blocks, save, res_scale)."""
    seen = set()
    fwd, bwd, fused = (k7.wdsr_trunk_fwd, k7.wdsr_trunk_bwd,
                       k8c.wdsr_block_fused_fwd)

    def fwd_rec(x, w1s, b1s, w2s, b2s, w3s, b3s, res_scale, save=False):
        seen.add(('fwd', x.shape[-1], w1s.shape[0], save, float(res_scale)))
        return fwd(x, w1s, b1s, w2s, b2s, w3s, b3s, res_scale, save)

    def bwd_rec(xs, h2s, g, w1s, b1s, w2s, b2s, w3s, res_scale):
        assert h2s is not None and h2s.shape[:-1] == xs.shape[:-1]
        seen.add(('bwd', g.shape[-1], w1s.shape[0], False, float(res_scale)))
        return bwd(xs, h2s, g, w1s, b1s, w2s, b2s, w3s, res_scale)

    def fused_rec(x, w1, b1, w2, b2, w3, b3, res_scale):
        seen.add(('k8c', x.shape[-1], 1, False, float(res_scale)))
        return fused(x, w1, b1, w2, b2, w3, b3, res_scale)

    monkeypatch.setattr(k7, 'wdsr_trunk_fwd', fwd_rec)
    monkeypatch.setattr(k7, 'wdsr_trunk_bwd', bwd_rec)
    monkeypatch.setattr(k8c, 'wdsr_block_fused_fwd', fused_rec)
    return seen


MODEL_CASES = {'cs-eval': ('cs', False), 'cs-train': ('cs', True),
               'true-eval': (True, False)}


@pytest.mark.parametrize('case', MODEL_CASES)
def test_wdsr_b_plans_are_held_by_chip_smoke(monkeypatch, case):
    use_pallas, train = MODEL_CASES[case]
    seen = record(monkeypatch)
    c, nb = chip_smoke.WDSR_C, chip_smoke.WDSR_L
    model = create_model('WDSR', scale_factor=4, n_feats=c, n_resblocks=nb,
                         use_pallas=use_pallas, dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(0))
    lr = torch.rand((1, 5, 6, 3), generator=torch.Generator().manual_seed(1))
    if train:
        model(lr).float().mean().backward()
        want = {('fwd', c, nb, True, 1.0), ('bwd', c, nb, False, 1.0)}
    else:
        with torch.no_grad():
            model(lr)
        want = ({('fwd', c, nb, False, 1.0)} if use_pallas == 'cs'
                else {('k8c', c, 1, False, 1.0)})
    assert seen == want, seen
    plans = held()
    for call in seen:
        assert plan(*call) in plans, call


CASES = {'fwd-save-1.0-64': ('fwd', 64, True, 1.0),
         'fwd-predict-0.1-128': ('fwd', 128, False, 0.1),
         'k8c-128': ('k8c', 128, False, 1.0),
         'bwd-1.0-128': ('bwd', 128, False, 1.0),
         'bwd-0.1-48': ('bwd', 48, False, 0.1)}


@pytest.mark.parametrize('case', CASES)
def test_k7_plans_follow_the_engines(case):
    kind, c, save, scale = CASES[case]
    n = 3
    launches = plan(kind, c, n, save, scale)[1]
    c = lp = k7.kernel_lp(c)
    assert c == k7.kernel_c(CASES[case][1]) and c in k7.KERNEL_C
    for name, epi, k, cin, cout, trans, s, _ in launches:
        if name == 'engine':        # K2's 3x3 plan at N = cout
            assert k == 3 and cin % 64 == 0 and cout in (64, 128)
            assert engine_bn(cout) == cout
            assert (epi, trans) in ((8, False), (7, True))
        elif name == 'wgrad':       # W's k = 1 mode, or its 3x3 classes
            assert (cin % 64 == 0 and cout % 64 == 0 if k == 1
                    else _kernel_takes(cin, cout, 1, k))
        elif name in ('chain', 'chain_bwd'):
            assert (k, cin, cout) == (1, c, lp)
        else:
            assert name in ('copy', 'gs', 'colsum')
    names = [lc[0] for lc in launches]
    if kind in ('fwd', 'k8c'):
        assert names == (['copy'] if save else []) + ['chain', 'engine'] * n
        skip = [lc for lc in launches if lc[0] == 'engine']
        assert all(lc[3] == (2 * lp if kind == 'k8c' else lp) and
                   lc[6] == scale for lc in skip)
        return
    block = ((['gs'] if scale != 1.0 else [])
             + ['engine', 'chain_bwd', 'wgrad', 'wgrad', 'wgrad'])
    assert names == block * n + ['colsum', 'colsum']
    dw = [lc for lc in launches if lc[0] == 'wgrad']
    assert [lc[2:5] for lc in dw[:3]] == [(1, c, 6 * c), (1, 6 * c, lp),
                                          (3, lp, c)]
    assert all(lc[6] == scale for lc in dw[2::3])


def _ops(rng, c, n_blocks, lv=None):
    """Stacked f32 weights at srtpu's init bounds: w1s (L, C, e), b1s,
    w2s (L, e, L_b), b2s, w3s (L, 3, 3, L_b, C), b3s."""
    e = 6 * c
    lv = lv or k7.wdsr_lp(c)[0]

    def u(bound, *shape):
        return torch.from_numpy(rng.uniform(-bound, bound, (n_blocks, *shape))
                                .astype(np.float32))
    return [u(c ** -0.5, c, e), u(c ** -0.5, e), u(e ** -0.5, e, lv),
            u(e ** -0.5, lv), u((9 * lv) ** -0.5, 3, 3, lv, c),
            u((9 * lv) ** -0.5, c)]


def _close(got, ref, rel, what=''):
    got, ref = (np.asarray(t.detach().float()) if torch.is_tensor(t)
                else np.asarray(t, np.float32) for t in (got, ref))
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * np.abs(ref).max(), err_msg=what)


@pytest.mark.parametrize('res_scale', [1.0, 0.1])
def test_lp_padding_to_128_changes_nothing(res_scale):
    """C 128: L 102 padded to srtpu's 112 and to the kernels' 128."""
    c = 128
    rng = np.random.default_rng(3)
    w1, b1, w2, b2, w3, b3 = (t[0] for t in _ops(rng, c, 1))
    x = torch.from_numpy(rng.standard_normal((2, 5, 6, c))
                         .astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 5, 6, c))
                         .astype(np.float32))
    lv = w2.shape[-1]
    outs, grads = [], []
    for lp in (k7.wdsr_lp(c)[1], k7.kernel_lp(c)):
        w2p, b2p, w3p = k7.pad_lp(w2, b2, w3, lp)
        outs.append(k7.wdsr_fwd_plain(x, w1, b1, w2p, b2p, w3p, b3,
                                      res_scale))
        gr = k7.wdsr_bwd_plain(x, g, w1, b1, w2p, b2p, w3p, res_scale)
        for t in (gr[3][:, lv:], gr[4][lv:], gr[5][:, :, lv:]):
            assert not t.any()          # the padding's grads are 0
        grads.append((gr[0], gr[1], gr[2], gr[3][:, :lv], gr[4][:lv],
                      gr[5][:, :, :lv], gr[6]))
    _close(outs[1], outs[0], 1e-6, 'out')
    for name, a, b in zip(('dx', 'dw1', 'db1', 'dw2', 'db2', 'dw3', 'db3'),
                          *grads):
        _close(b, a, 1e-6, name)


@pytest.mark.parametrize('c', [16, 48, 80])
def test_c_padding_to_the_kernels_width_changes_nothing(c):
    """C padded to 64 or 128 (e to 6 times that, Lp to it) as the kernel
    wrappers pad it: the plain forward and backward at the padded widths,
    sliced, against the plain versions at C."""
    rng = np.random.default_rng(c)
    lp = k7.wdsr_lp(c)[1]
    w1, b1, w2, b2, w3, b3 = (t[0] for t in _ops(rng, c, 1))
    w2, b2, w3 = k7.pad_lp(w2, b2, w3, lp)
    x, g = (torch.from_numpy(rng.standard_normal((2, 5, 6, c))
                             .astype(np.float32)) for _ in range(2))
    (xp, gp), *wp = k7.widen(c, (x, g), w1, b1, w2, b2, w3, b3)
    cp = k7.kernel_c(c)
    assert xp.shape[-1] == cp and wp[0].shape == (cp, 6 * cp)
    assert wp[2].shape == (6 * cp, cp) and wp[4].shape == (3, 3, cp, cp)
    out = k7.wdsr_fwd_plain(xp, *wp, 0.5)
    assert not out[..., c:].any()       # the padded channels stay 0
    _close(out[..., :c], k7.wdsr_fwd_plain(x, w1, b1, w2, b2, w3, b3, 0.5),
           1e-6, 'out')
    got = k7.wdsr_bwd_plain(xp, gp, *wp[:5], 0.5)
    ref = k7.wdsr_bwd_plain(x, g, w1, b1, w2, b2, w3, 0.5)
    e = 6 * c
    sliced = (got[0][..., :c], got[1][:c, :e], got[2][:e], got[3][:e, :lp],
              got[4][:lp], got[5][:, :, :lp, :c], got[6][:c])
    for name, a, b in zip(('dx', 'dw1', 'db1', 'dw2', 'db2', 'dw3', 'db3'),
                          sliced, ref):
        _close(a, b, 1e-6, name)


def _grads(fn, x, prm, g):
    x = x.detach().clone().requires_grad_()
    prm = [p.detach().clone().requires_grad_() for p in prm]
    out = fn(x, prm)
    out.backward(g)
    return out, [x.grad, *(p.grad for p in prm)]


@pytest.mark.parametrize('res_scale', [1.0, 0.1])
def test_trunk_op_is_its_blocks_bit_for_bit(res_scale):
    c, nb = 16, 3
    rng = np.random.default_rng(5)
    prm = _ops(rng, c, nb)
    x = torch.from_numpy(rng.standard_normal((2, 5, 7, c)).astype(
        np.float32)).to(torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal((2, 5, 7, c)).astype(
        np.float32)).to(torch.bfloat16)

    def trunk(x, p):
        return k7.wdsr_trunk(x, *p, res_scale=res_scale)

    def blocks(x, p):
        for i in range(nb):
            x = k7.wdsr_block(x, *(t[i] for t in p), res_scale=res_scale)
        return x
    out_t, grads_t = _grads(trunk, x, prm, g)
    out_b, grads_b = _grads(blocks, x, prm, g)
    assert torch.equal(out_t, out_b)
    for a, b in zip(grads_t, grads_b):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with torch.no_grad():       # the forward alone: the same bits
        assert torch.equal(trunk(x, prm), out_t)


B, H, W, K = 2, 8, 8, 2        # two 8x8 images per CS lane-row: S = 128
DTYPES = {'f32': (jnp.float32, torch.float32),
          'bf16': (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_trunk_op_grads_match_jax_grad(dtype):
    jdt, tdt = DTYPES[dtype]
    c, nb, rs = 16, 3, 0.8
    rng = np.random.default_rng(c + 7)
    x = rng.standard_normal((B, H, W, c)).astype(np.float32) * 0.5
    prm = _ops(rng, c, nb)
    lv, lp = k7.wdsr_lp(c)
    row_w = np.arange(1, c + 1, dtype=np.float32) / c

    def f_jax(x_cs, w1s, b1s, w2s, b2s, w3s, b3s):
        for i in range(nb):
            w2p = jnp.pad(w2s[i], ((0, lp - lv), (0, 0)))
            w3p = jnp.pad(w3s[i], ((0, 0), (0, 0), (0, lp - lv), (0, 0)))
            x_cs = wdsr_cs.wdsr_block_cs(
                x_cs, w1s[i].astype(jdt), b1s[i], w2p.astype(jdt),
                jnp.pad(b2s[i], (0, lp - lv)), w3p.astype(jdt), b3s[i], rs,
                W, K)
        return jnp.sum(jnp.sin(x_cs.astype(jnp.float32))
                       * row_w[None, :, None])

    npp = [p.numpy() for p in prm]
    args = (cs_conv.nhwc_to_cs(jnp.asarray(x, jdt), K),
            jnp.asarray(npp[0].transpose(0, 2, 1)), jnp.asarray(npp[1]),
            jnp.asarray(npp[2].transpose(0, 2, 1)), jnp.asarray(npp[3]),
            jnp.asarray(npp[4]), jnp.asarray(npp[5]))
    v_ref, g_ref = jax.value_and_grad(f_jax, argnums=tuple(range(7)))(*args)

    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    pt = [p.clone().requires_grad_() for p in prm]
    out = k7.wdsr_trunk(xt, *pt, res_scale=rs)
    assert out.dtype == tdt and out.shape == (B, H, W, c)
    v = (torch.sin(out.float()) * torch.from_numpy(row_w)).sum()
    v.backward()
    tol = 1e-4 if dtype == 'f32' else 2.0 ** -6
    np.testing.assert_allclose(v.item(), float(v_ref), rtol=tol)
    _close(xt.grad, np.asarray(cs_conv.cs_to_nhwc(
        jnp.asarray(g_ref[0], jnp.float32), K, H, W)), tol, 'dx')
    refs = (np.asarray(g_ref[1]).transpose(0, 2, 1), g_ref[2],
            np.asarray(g_ref[3]).transpose(0, 2, 1), g_ref[4], g_ref[5],
            g_ref[6])
    for name, t, r in zip(('w1s', 'b1s', 'w2s', 'b2s', 'w3s', 'b3s'), pt,
                          refs):
        assert t.grad.dtype == torch.float32 and t.grad.shape == t.shape
        _close(t.grad, np.asarray(r, np.float32), tol, name)


def bf16_rne(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bits (uint16), round to nearest even, as
    ``__floats2bfloat162_rn`` (finite values)."""
    u = x.astype(np.float32).view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


@pytest.mark.parametrize('res_scale', [1.0, 0.5, 0.1])
def test_epilogue_emulation_matches_wdsr_fwd_plain(res_scale):
    """x takes every finite bf16 value (one a pixel); W1 = 0 and b1 = 1
    make h1, h2 and so v = conv3x3(h2) + b3 the same at every interior
    pixel whatever x is, so the plain output is the epilogue of v and x
    alone."""
    every = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    every = every.view(torch.bfloat16)
    every = every[torch.isfinite(every.float())]
    c = 16
    n = every.numel()
    rng = np.random.default_rng(11)
    w1, b1, w2, b2, w3, b3 = (t[0] for t in _ops(rng, c, 1))
    w1, b1 = torch.zeros_like(w1), torch.ones_like(b1)
    # each value in channel 0 of an interior pixel of a 3 x (n + 2) image
    x = torch.zeros((1, 3, n + 2, c), dtype=torch.bfloat16)
    x[0, 1, 1:n + 1, 0] = every
    got = k7.wdsr_fwd_plain(x, w1.bfloat16(), b1, w2.bfloat16(), b2,
                            w3.bfloat16(), b3, res_scale)
    _, h2 = k7._recompute(x, w1.bfloat16(), b1, w2.bfloat16(), b2)
    v = k7.conv_f32(h2, w3.bfloat16(), b3)[0, 1, 1:n + 1, 0].numpy()
    xb = every.float().numpy()
    prod = (v.astype(np.float32) * np.float32(res_scale)).astype(np.float32)
    emu = bf16_rne((prod + xb).astype(np.float32))
    out = got[0, 1, 1:n + 1, 0].view(torch.int16).numpy().view(np.uint16)
    ok = np.isfinite(prod + xb)
    assert np.array_equal(emu[ok], out[ok])
