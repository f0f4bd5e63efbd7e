"""K8a's and K3's launch plans cover what the models launch, their new
epilogues round and store as the plain versions do, and K8a's trunk op is
its blocks.

K8a (``ops.resblock``: ``resblock_trunk_fwd``, EDSR's True-route trunk
in one host call; ``resblock_fused_fwd`` one block) runs each block as
two launches of K2's engine (``csrc/conv_sm90.cuh``): conv1 at ``EPI``
12, storing h1 as a bf16 [hi | lo] pair, and conv2 over that pair with
W2 stacked twice at ``EPI`` 15 (K1's skip as one fused multiply-add).
K3 (``ops.upsample``) runs its forward at ``EPI`` 13 (the pixel shuffle
in the store) and its dx on the transposed engine at ``EPI`` 14 (the
fine cotangent read phase-major through a 5-D tensor map). ``fwd_plan``
/ ``bwd_plan`` are their launches in plain Python, as
``csrc/resblock.cu`` and ``csrc/upsample.cu`` make them. Here, on the
CPU (where the wrappers run their plain versions):

- EDSR True (predict and a train step), EDSR ``'cs'`` x4 and x8 (predict
  and a train step) and SRResNet x4 (a train step) at full width and
  depth on a tiny image record every K8a and K3 call; each call's plan
  must be among those of the calls chip_smoke.py's phases hold on the
  card (``chip_smoke.k8a_held``, ``k3_held``). EDSR True makes one K8a
  trunk call forward per step and per image, and no per-block call.
- Each plan follows the engines' rules: K2's 3x3 plan, N = K2's own
  pick for the class (``engine_bn``), K8a's and K3's own epilogues (12;
  15 at cin 128; 13; 14 transposed) and none of the others'; K3's split
  as K2's ``split_cin`` picks it; its weight grads a class W takes.
- An emulation of K8a's epilogues in plain torch (h1 split into bf16 hi
  and lo, the conv over [hi | lo] with W2 stacked twice; the fused
  multiply-add of the skip in float64, exact before its one rounding)
  against ``resblock_fused_plain``: out within one bf16 step of its largest
  magnitude (the pair is h1 to 2^-17, the conv's f32 sums run in another
  order), the stored h1 (hi) bit for bit; f32 and bf16, res_scale 1.0
  and 0.1.
- An emulation of K3's forward store (each block's run of phases at the
  epilogue's fine-pixel address) against ``pixel_shuffle``, and of its
  dx's 5-D view of the fine cotangent against ``pm_from_fine``: bit for
  bit, r = 2, 3 and 4 (bit for bit: both are permutations).
- The trunk op (``resblock_fused_trunk``) equals L calls of
  ``resblock_fused``: output and every gradient bit for bit, f32 and
  bf16, res_scale 1.0 and 0.1; its forward alone too.
- The trunk op against ``jax.grad`` of srtpu's ``resblock_fused_v2``
  applied block after block (Pallas in interpret mode), as
  ``tests/test_torch_k8.py`` holds one block: f32 within 1e-4, bf16
  within 2^-6 of each tensor's largest magnitude.

One test per case, so each counts.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from srtpu.ops import resblock as jrb
from srtpu_torch.models import create_model
from srtpu_torch.ops.conv import conv_f32
from srtpu_torch.ops.layout import pixel_shuffle, pm_from_fine, w_pm_hwio
from srtpu_torch.ops.rdn import engine_bn
from srtpu_torch.ops.wgrad import _kernel_takes

k8a = importlib.import_module('srtpu_torch.ops.resblock')
k3 = importlib.import_module('srtpu_torch.ops.upsample')
torch.set_num_threads(1)


def k8a_plan(kind, n_blocks, save, scale) -> tuple:
    """One K8a call's launches: the trunk op and the per-block op run the
    same C entry point, so the kind leaves the plan alone."""
    return k8a.fwd_plan(save, scale, n_blocks)


def k3_plan(kind, r, bsz, h, w) -> tuple:
    return k3.fwd_plan(r) if kind == 'fwd' else k3.bwd_plan(r, bsz, h, w)


def record(monkeypatch) -> tuple[set, set]:
    """Record each K8a call as (kind, blocks, save, res_scale) and each K3
    call as (kind, r, batch, H, W) at the LR size."""
    k8a_seen, k3_seen = set(), set()
    trunk, block = k8a.resblock_trunk_fwd, k8a.resblock_fused_fwd
    fwd, bwd = k3.upsample_fwd, k3.upsample_bwd

    def trunk_rec(x, w1s, b1s, w2s, b2s, res_scale, save=False):
        k8a_seen.add(('trunk', w1s.shape[0], save, float(res_scale)))
        return trunk(x, w1s, b1s, w2s, b2s, res_scale, save)

    def block_rec(x, w1, b1, w2, b2, res_scale, save_h1=False):
        k8a_seen.add(('block', 1, save_h1, float(res_scale)))
        return block(x, w1, b1, w2, b2, res_scale, save_h1)

    def fwd_rec(x, w, b, r):
        k3_seen.add(('fwd', r, *x.shape[:3]))
        return fwd(x, w, b, r)

    def bwd_rec(x, w, g, r):
        k3_seen.add(('bwd', r, *x.shape[:3]))
        return bwd(x, w, g, r)

    monkeypatch.setattr(k8a, 'resblock_trunk_fwd', trunk_rec)
    monkeypatch.setattr(k8a, 'resblock_fused_fwd', block_rec)
    monkeypatch.setattr(k3, 'upsample_fwd', fwd_rec)
    monkeypatch.setattr(k3, 'upsample_bwd', bwd_rec)
    return k8a_seen, k3_seen


# (model, scale, use_pallas, train)
MODEL_CASES = {'edsr-true-eval': ('EDSR', 4, True, False),
               'edsr-true-train': ('EDSR', 4, True, True),
               'edsr-cs-x4-eval': ('EDSR', 4, 'cs', False),
               'edsr-cs-x4-train': ('EDSR', 4, 'cs', True),
               'edsr-cs-x8-eval': ('EDSR', 8, 'cs', False),
               'edsr-cs-x8-train': ('EDSR', 8, 'cs', True),
               'srresnet-x4-train': ('SRResNet', 4, 'cs', True)}


@pytest.mark.parametrize('case', MODEL_CASES)
def test_model_plans_are_held_by_chip_smoke(monkeypatch, case):
    name, scale, use_pallas, train = MODEL_CASES[case]
    k8a_seen, k3_seen = record(monkeypatch)
    c, nb = chip_smoke.C, chip_smoke.L
    kw = dict(n_feats=c, n_resblocks=nb)
    if name == 'EDSR':
        kw['use_pallas'] = use_pallas
    model = create_model(name, scale_factor=scale, dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(0), **kw)
    model.train(train)
    lr = torch.rand((2, 5, 6, 3), generator=torch.Generator().manual_seed(1))
    if train:
        model(lr).float().mean().backward()
    else:
        with torch.no_grad():
            model(lr)
    if use_pallas is True:
        assert k8a_seen == {('trunk', nb, train, 1.0)} and not k3_seen
    else:
        assert not k8a_seen
        stages = {('fwd', 2, 2, 5 * 2 ** i, 6 * 2 ** i)
                  for i in range(scale.bit_length() - 2)}
        want = stages | ({('bwd', *s[1:]) for s in stages} if train
                         else set())
        assert k3_seen == want, k3_seen
    k8a_plans = {k8a_plan(*c) for c in chip_smoke.k8a_held()}
    k3_plans = {k3_plan(*c) for c in chip_smoke.k3_held()}
    for call in k8a_seen:
        assert k8a_plan(*call) in k8a_plans, call
    for call in k3_seen:
        assert k3_plan(*call) in k3_plans, call


def test_chip_smoke_holds_k3_split_and_whole():
    """chip_smoke holds K3's dx both as a 2-block split (the training
    shape, LR 128x128) and whole (the x8 path's second stage)."""
    splits = {k3_plan(*c)[0][7] for c in chip_smoke.k3_held()
              if c[0] == 'bwd'}
    assert splits == {1, 2}


K8A_CASES = {'predict-1.0': (False, 1.0), 'train-1.0': (True, 1.0),
             'train-0.1': (True, 0.1)}


@pytest.mark.parametrize('case', K8A_CASES)
def test_k8a_plans_follow_the_engine(case):
    save, scale = K8A_CASES[case]
    n = 3
    launches = k8a.fwd_plan(save, scale, n)
    assert [lc[1] for lc in launches] == [12, 15] * n
    for name, epi, k, cin, cout, trans, s, writes in launches:
        assert name == 'engine' and k == 3 and not trans
        assert engine_bn(cout) == cout == 64      # K2's plan: N = 64
        if epi == 12:       # conv1: bias, ReLU, the pair (and h1)
            assert cin == 64 and s is None
            assert writes == (('vcat', 'h1') if save else ('vcat',))
        else:               # conv2 over [hi | lo]: W2 stacked twice
            assert cin == 128 and s == scale and writes == ('out',)


@pytest.mark.parametrize('r', [2, 3, 4])
def test_k3_plans_follow_the_engine(r):
    (name, epi, k, cin, cout, trans, bn, split, _), = k3.fwd_plan(r)
    d = k3.phases(r)
    assert (name, epi, k, cin, cout, trans) == ('engine', 13, 3, 64,
                                                r * r * 64, False)
    # N is K2's own pick for the class, a run of phases of one phase row
    assert bn == engine_bn(cout) == 64 * d and r % d == 0 and split == 1
    if r != 2:          # the backward takes r = 2 (ROADMAP F4)
        return
    for bsz, h, w, want in ((16, 32, 32, 2), (1, 128, 128, 2),
                            (16, 64, 64, 1), (2, 67, 45, 2)):
        dx, dw = k3.bwd_plan(r, bsz, h, w)
        name, epi, k, cin, cout, trans, bn, split, _ = dx
        assert (name, epi, k, cin, cout, trans, bn) == (
            'engine', 14, 3, r * r * 64, 64, True, 64)
        blocks = -(-w // 16) * -(-h // 8) * bsz
        assert split == want == (2 if blocks < 2 * k3.SMS else 1)
        assert dw[0] == 'wgrad' and _kernel_takes(dw[3], dw[4], r, dw[2])


def _emulate_k8a(x, w1, b1, w2, b2, res_scale):
    """K8a's two launches in plain torch: conv1's epilogue (EPI 12) splits
    h1 = relu(sums + b1) into hi = bf16(h1), lo = bf16(h1 - hi); conv2
    runs over [hi | lo] with W2 stacked twice along its input channels
    (EPI 15: fma(sums + b2, res_scale, x), the product exact in float64,
    then one rounding to f32 and one to x.dtype). Returns (out, hi)."""
    h1 = conv_f32(x, w1, b1).clamp_min(0.0)
    hi = h1.to(torch.bfloat16)
    lo = (h1 - hi.float()).to(torch.bfloat16)
    pair = torch.cat((hi, lo), -1)
    w2cat = torch.cat((w2, w2), -2).to(torch.bfloat16)
    v = conv_f32(pair, w2cat, b2).double()
    out = (v * float(np.float32(res_scale)) + x.double()).float()
    return out.to(x.dtype), hi.to(x.dtype)


@pytest.mark.parametrize('res_scale', [1.0, 0.1])
@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_k8a_epilogues_emulated_match_the_plain_version(dtype, res_scale):
    """W2 holds bf16 values on the card; here too, so that every product
    with hi and lo is exact and the pair carries h1 to 2^-17."""
    tdt = torch.float32 if dtype == 'f32' else torch.bfloat16
    rng = np.random.default_rng(7)
    cb = (9 * 64) ** -0.5

    def t(*shape, bound=1.0):
        return torch.from_numpy(rng.uniform(-bound, bound, shape).astype(
            np.float32))
    x = t(2, 9, 13, 64).to(tdt)
    w1, w2 = (t(3, 3, 64, 64, bound=cb).bfloat16().to(tdt) for _ in 'ab')
    b1, b2 = t(64, bound=cb), t(64, bound=cb)
    out, hi = _emulate_k8a(x, w1, b1, w2, b2, res_scale)
    ref, h1 = k8a.resblock_fused_plain(x, w1, b1, w2, b2, res_scale,
                                       save_h1=True)
    top = ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2.0 ** -7 * top, (err, top)
    if dtype == 'bf16':
        assert torch.equal(hi, h1)      # the stored h1 is hi, bit for bit


def _store_k3(y_pm, r):
    """K3's forward store (EPI 13), as ``shuffle_epilogue`` addresses it:
    block n-tile t holds phases p0 = t d .. p0 + d - 1 of phase row a =
    p0 // r from b0 = p0 % r; coarse pixel (gy, gx) of image b writes
    phase p0 + at at fine element (((b H + gy) r + a) r W + r gx + b0) 64
    + at 64 + c."""
    bsz, h, w, crr = y_pm.shape
    d = k3.phases(r)
    out = torch.full((bsz * r * h * r * w * 64,), float('nan'),
                     dtype=y_pm.dtype)
    b, gy, gx = torch.meshgrid(torch.arange(bsz), torch.arange(h),
                               torch.arange(w), indexing='ij')
    for tile in range(crr // (64 * d)):
        p0 = tile * d
        a, b0 = p0 // r, p0 % r
        base = (((b * h + gy) * r + a) * (r * w) + r * gx + b0) * 64
        for at in range(d):
            idx = base[..., None] + at * 64 + torch.arange(64)
            src = y_pm[..., (p0 + at) * 64:(p0 + at + 1) * 64]
            out[idx.reshape(-1)] = src.reshape(-1)
    return out.reshape(bsz, r * h, r * w, 64)


@pytest.mark.parametrize('r', [2, 3, 4])
def test_k3_store_emulated_is_pixel_shuffle(r):
    """The conv's phase-major output stored as K3's epilogue stores it
    equals pixel_shuffle of the PixelShuffle-order output: every fine
    element written once, bit for bit."""
    rng = np.random.default_rng(r)
    bsz, h, w = 2, 3, 5
    y_ps = torch.from_numpy(rng.standard_normal(
        (bsz, h, w, r * r * 64)).astype(np.float32)).bfloat16()
    # PixelShuffle channel c * r r + a r + b -> phase-major (a r + b) 64 + c
    y_pm = y_ps.reshape(bsz, h, w, 64, r * r).transpose(3, 4).reshape(
        bsz, h, w, r * r * 64)
    got = _store_k3(y_pm, r)
    assert torch.equal(got, pixel_shuffle(y_ps, r))
    # the phase-major weight the wrapper hands the kernel makes y_pm
    wt = torch.from_numpy(rng.standard_normal((3, 3, 64, r * r * 64)).astype(
        np.float32))
    x = torch.from_numpy(rng.standard_normal((1, 3, 4, 64)).astype(
        np.float32))
    ps = conv_f32(x, wt)
    pm = conv_f32(x, w_pm_hwio(wt, r))
    assert torch.equal(pm, ps.reshape(1, 3, 4, 64, r * r).transpose(3, 4)
                       .reshape(1, 3, 4, r * r * 64))


def _fine_view(g, r):
    """EPI 14's 5-D tensor map of the fine cotangent g (B, r H, r W, 64),
    as ``launch`` in conv_sm90.cuh encodes it: dims (r 64, W, r, H, B),
    strides (in elements) 1, r 64, a fine row r W 64, r fine rows, H r
    fine rows; as a strided view, (B, H, r, W, r 64)."""
    bsz, fh, fw, c = g.shape
    h, w = fh // r, fw // r
    frow = r * w * 64
    return g.as_strided((bsz, h, r, w, r * 64),
                        (h * r * frow, r * frow, frow, r * 64, 1))


@pytest.mark.parametrize('r', [2, 3, 4])
def test_k3_dx_fine_view_is_pm_from_fine(r):
    """The 64-channel K slice s of the dx is phase (a, b) = (s // r, s %
    r): channels b 64 .. b 64 + 63 of the map at its index a. Slices in
    order give the phase-major view bit for bit."""
    rng = np.random.default_rng(10 + r)
    g = torch.from_numpy(rng.standard_normal((2, 3 * r, 5 * r, 64)).astype(
        np.float32)).bfloat16()
    view = _fine_view(g, r)
    slices = []
    for s in range(r * r):
        c = s * 64
        ph = c // 64
        b0 = (ph % r) * 64 + c % 64
        slices.append(view[:, :, ph // r, :, b0:b0 + 64])
    assert torch.equal(torch.cat(slices, -1), pm_from_fine(g, r))


def _grads(fn, x, prm, g):
    x = x.detach().clone().requires_grad_()
    prm = [p.detach().clone().requires_grad_() for p in prm]
    out = fn(x, prm)
    out.backward(g)
    return out, [x.grad, *(p.grad for p in prm)]


def _stack(rng, n_blocks, c):
    cb = (9 * c) ** -0.5

    def u(*shape):
        return torch.from_numpy(rng.uniform(-cb, cb, (n_blocks, *shape))
                                .astype(np.float32))
    return [u(3, 3, c, c), u(c), u(3, 3, c, c), u(c)]


@pytest.mark.parametrize('res_scale', [1.0, 0.1])
@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_trunk_op_is_its_blocks_bit_for_bit(dtype, res_scale):
    tdt = torch.float32 if dtype == 'f32' else torch.bfloat16
    c, nb = 16, 3
    rng = np.random.default_rng(5)
    prm = _stack(rng, nb, c)
    x, g = (torch.from_numpy(rng.standard_normal((2, 5, 7, c)).astype(
        np.float32)).to(tdt) for _ in 'xg')

    def trunk(x, p):
        return k8a.resblock_fused_trunk(x, *p, res_scale=res_scale)

    def blocks(x, p):
        for i in range(nb):
            x = k8a.resblock_fused(x, *(t[i] for t in p),
                                   res_scale=res_scale)
        return x
    out_t, grads_t = _grads(trunk, x, prm, g)
    out_b, grads_b = _grads(blocks, x, prm, g)
    assert torch.equal(out_t, out_b)
    for a, b in zip(grads_t, grads_b):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with torch.no_grad():       # the forward alone: the same bits
        assert torch.equal(trunk(x, prm), out_t)
        assert torch.equal(k8a.resblock_trunk_plain(
            x, *k8a._cast(x, *prm), res_scale), out_t)


DTYPES = {'f32': (jnp.float32, torch.float32),
          'bf16': (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_trunk_op_grads_match_jax_grad(dtype):
    jdt, tdt = DTYPES[dtype]
    c, nb, rs = 16, 3, 0.8
    bsz, h, w = 2, 8, 8
    rng = np.random.default_rng(c + 3)
    x = rng.standard_normal((bsz, h, w, c)).astype(np.float32) * 0.5
    prm = _stack(rng, nb, c)
    row_w = np.arange(1, c + 1, dtype=np.float32) / c

    def f_jax(xx, w1s, b1s, w2s, b2s):
        for i in range(nb):
            xx = jrb.resblock_fused_v2(xx, w1s[i].astype(jdt), b1s[i],
                                       w2s[i].astype(jdt), b2s[i], rs)
        return jnp.sum(jnp.sin(xx.astype(jnp.float32)) * row_w)

    v_ref, g_ref = jax.value_and_grad(f_jax, argnums=tuple(range(5)))(
        jnp.asarray(x, jdt), *(jnp.asarray(p.numpy()) for p in prm))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    pt = [p.clone().requires_grad_() for p in prm]
    out = k8a.resblock_fused_trunk(xt, *pt, res_scale=rs)
    assert out.dtype == tdt and out.shape == (bsz, h, w, c)
    v = (torch.sin(out.float()) * torch.from_numpy(row_w)).sum()
    v.backward()
    tol = 1e-4 if dtype == 'f32' else 2.0 ** -6
    np.testing.assert_allclose(v.item(), float(v_ref), rtol=tol)
    for name, t, r in zip(('dx', 'w1s', 'b1s', 'w2s', 'b2s'),
                          (xt, *pt), g_ref):
        got = np.asarray(t.grad.float())
        ref = np.asarray(r, np.float32)
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=tol * np.abs(ref).max(),
                                   err_msg=name)
