"""K4's launch plans cover what SRResNet and SRGAN launch, they keep to
K4's own epilogues, the trunk op is its blocks, and it matches srtpu's
BN blocks; K8b's block size at the shapes RCAN runs.

K4 (``ops.bn_block``: ``bn_trunk_fwd`` and ``bn_trunk_bwd``, one host
call per BN trunk each way; the per-function wrappers ``f1_conv_stats``
... ``b3_call`` behind ``bn_resblock`` and ``bn_close``) runs its four
convs on K2's engine (``csrc/conv_sm90.cuh``) at K4's epilogues (``EPI``
9 forward, 10 and 11 transposed) and its weight grads on W's engine
(``csrc/wgrad.cu``), with REFLECT boundaries for SRGAN's generator (K4r).
``fwd_plan``, ``bwd_plan`` and ``fn_plan`` are its launches in plain
Python, as ``csrc/bn_block.cu`` makes them. Here, on the CPU (where the
wrappers run their plain versions):

- SRResNet (SAME) and SRGAN's generator (REFLECT) at 64 features and 16
  blocks, in train mode on a tiny image, record every K4 / K4r call; each
  call's plan must be among those of the calls chip_smoke.py's phases
  2d, 2h and 2n hold on the card (``chip_smoke.k4_held``).
- Each plan keeps to K4's own EPI values (9 forward; 10, 11 transposed)
  and to none of K6's (1-3), K5's (4, 5), K1's (6) or K7's (7, 8); a
  'ring' launch before each transposed conv exactly with reflect; one
  weight-grad launch of 2 L + 1 jobs a trunk backward.
- The trunk op's plain versions equal L calls of ``bn_resblock`` and one
  of ``bn_close`` (``chip_smoke.bn_trunk_by_blocks``): the same output, the
  same gradients and the same running statistics after a step, bit for
  bit, in f32 and bf16, both modes.
- The trunk op against srtpu's ``bn_resblock_cs`` applied block after
  block and ``bn_close_cs`` (Pallas in interpret mode, ``jax.vjp``):
  output, batch statistics, dx and every parameter gradient, f32 within
  1e-4 of each tensor's largest magnitude, bf16 within 2^-5 (the per-block
  limits of tests/test_torch_srresnet.py, 2^-6, doubled for two blocks
  and the close in a row: each batch norm divides a one-step difference
  by its channel's deviation and passes it on), the BN scale and PReLU
  slope grads 2^-4 (as there), the pre-BN conv biases (rounding noise on
  both sides) to the scale of the same conv's weight grad, and with
  REFLECT BN2's shift grads (noise too: every block's output cotangent
  sums to 0) to the scale of BN2's scale grad.
- K8b's pixels a block (``ca_layer.block_pixels``) at RCAN's training
  shape, 1 x 128 x 128, 1 x 512 x 352 and a ragged batch; RCAN's True
  route calls K8b on its RCABs' residuals, and every block size RCAN's
  True route takes in chip_smoke.py's runs is among those phase 2i
  holds.

One test per case, so each counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from srtpu.ops import bn_resblock_cs as jbn
from srtpu.ops import cs_conv
from srtpu_torch.models import create_model
from srtpu_torch.ops import bn_block
from srtpu_torch.ops import ca_layer as k8b
from srtpu_torch.ops.layout import w_hwio_from_cs

torch.set_num_threads(1)

OTHER_EPI = {1, 2, 3, 4, 5, 6, 7, 8}     # K6's, K5's, K1's and K7's
K4_EPI = {bn_block.EPI_F: False, bn_block.EPI_B2: True,
          bn_block.EPI_B3: True}          # EPI -> transposed


def plan(kind, n_blocks, reflect) -> tuple:
    """One K4 call's launches."""
    if kind == 'trunk_fwd':
        return kind, bn_block.fwd_plan(n_blocks, reflect)
    if kind == 'trunk_bwd':
        return kind, bn_block.bwd_plan(n_blocks, reflect)
    return kind, bn_block.fn_plan(kind, reflect)


def held() -> set:
    """The plans of the calls chip_smoke's phases hold on the card."""
    return {plan(*case) for case in chip_smoke.k4_held()}


def record(monkeypatch) -> set:
    """Record each K4 call as (kind, blocks, reflect): the trunk op's
    two wrappers and the per-function ones."""
    seen = set()
    fwd, bwd = bn_block.bn_trunk_fwd, bn_block.bn_trunk_bwd

    def fwd_rec(x, w1s, *rest, reflect=False):
        seen.add(('trunk_fwd', w1s.shape[0], bool(reflect)))
        return fwd(x, w1s, *rest, reflect=reflect)

    def bwd_rec(acts, ys, sts, g, w1s, *rest, reflect=False):
        seen.add(('trunk_bwd', w1s.shape[0], bool(reflect)))
        return bwd(acts, ys, sts, g, w1s, *rest, reflect=reflect)

    monkeypatch.setattr(bn_block, 'bn_trunk_fwd', fwd_rec)
    monkeypatch.setattr(bn_block, 'bn_trunk_bwd', bwd_rec)
    for key in ('f1', 'f2', 'f3', 'b1', 'b2', 'b3'):
        def call(*args, _fn=bn_block.KERNELS[key], _key=key):
            seen.add((_key, None, bool(args[-1]) if _key not in ('f3', 'b1')
                      else False))
            return _fn(*args)
        monkeypatch.setitem(bn_block.KERNELS, key, call)
    return seen


@pytest.mark.parametrize('model', ['SRResNet', 'SRGAN'])
def test_k4_plans_are_held_by_chip_smoke(monkeypatch, model):
    seen = record(monkeypatch)
    c, nb, rf = chip_smoke.C, chip_smoke.L, model == 'SRGAN'
    gen = torch.Generator().manual_seed(0)
    if rf:
        net = create_model('SRGAN', scale_factor=4, ngf=c, ndf=c,
                           n_blocks=nb, use_pallas='cs',
                           dtype=torch.bfloat16, generator=gen).generator
    else:
        net = create_model('SRResNet', scale_factor=4, n_feats=c,
                           n_resblocks=nb, dtype=torch.bfloat16,
                           generator=gen)
    net.train()
    lr = torch.rand((1, 4, 5, 3), generator=torch.Generator().manual_seed(1))
    net(lr).float().mean().backward()
    assert seen == {('trunk_fwd', nb, rf), ('trunk_bwd', nb, rf)}, seen
    plans = held()
    for call in seen:
        assert plan(*call) in plans, call


PLAN_CASES = {f'{kind}-{"reflect" if rf else "same"}': (kind, rf)
              for kind in ('trunk_fwd', 'trunk_bwd', 'f1', 'f2', 'f3', 'b1',
                           'b2', 'b3')
              for rf in (False, True)}


@pytest.mark.parametrize('case', PLAN_CASES)
def test_k4_plans_keep_to_k4s_epilogues(case):
    kind, rf = PLAN_CASES[case]
    n = 3
    launches = plan(kind, n, rf)[1]
    names = [lc[0] for lc in launches]
    for name, epi, trans, reflect, _ in launches:
        if name == 'engine':
            assert epi in K4_EPI and epi not in OTHER_EPI
            assert trans == K4_EPI[epi] and reflect == rf
        else:
            assert epi is None
            assert name in ('copy', 'reduce', 'act', 'norm_skip', 'sums',
                            'dy', 'ring', 'wgrad')
            assert reflect == (rf and name in ('ring', 'wgrad'))
    # a fold ring before each transposed conv exactly with reflect
    trans = [i for i, lc in enumerate(launches)
             if lc[0] == 'engine' and lc[2]]
    for i in trans:
        assert (launches[i - 1][0] == 'ring') == rf
    assert names.count('ring') == (len(trans) if rf else 0)
    if kind == 'trunk_fwd':
        assert names.count('engine') == 2 * n + 1
        assert names[0] == 'copy' and names[-1] == 'norm_skip'
    elif kind == 'trunk_bwd':
        assert names.count('engine') == 2 * n + 1
        assert [lc[1] for lc in launches if lc[0] == 'engine'] == (
            [bn_block.EPI_B3] + [bn_block.EPI_B2, bn_block.EPI_B3] * n)
        assert names.count('wgrad') == 1 and names[-2:] == ['wgrad',
                                                            'reduce']
    elif kind in ('f3', 'b1'):
        assert 'engine' not in names
    else:
        assert names.count('engine') == 1


# ---------------------------------------- the trunk op and its blocks

C, L = 16, 2
B, H, W, K = 2, 8, 8, 2        # two 8x8 images side by side (srtpu's CS)
STEP = 2.0 ** -7
DTYPES = {'f32': (jnp.float32, torch.float32),
          'bf16': (jnp.bfloat16, torch.bfloat16)}


def _trunk(rf, seed=3):
    """A BNTrunk at (C, L), its BN scales and shifts, slopes and biases
    off their init."""
    t = create_model('SRResNet', scale_factor=4, n_feats=C, n_resblocks=L,
                     generator=torch.Generator().manual_seed(seed)).trunk
    t.reflect = rf
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name in ('bn1_scale', 'bn2_scale', 'close_bn_scale'):
            getattr(t, name).add_(torch.rand(getattr(t, name).shape,
                                             generator=g) - 0.5)
        for name in ('bn1_bias', 'bn2_bias', 'close_bn_bias'):
            getattr(t, name).add_(0.6 * torch.rand(getattr(t, name).shape,
                                                   generator=g) - 0.3)
        t.alpha.add_(0.2 * torch.rand(t.alpha.shape, generator=g))
    return t.train()


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('rf', [False, True], ids=['same', 'reflect'])
def test_trunk_op_plain_equals_its_blocks(rf, dtype):
    tdt = DTYPES[dtype][1]
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(
        np.float32)).to(tdt)
    g = torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(
        np.float32)).to(tdt)
    base = _trunk(rf)
    got = []
    for by_blocks in (False, True):
        m = _trunk(rf)
        m.load_state_dict(base.state_dict())
        xi = x.clone().requires_grad_()
        out = (chip_smoke.bn_trunk_by_blocks(m, xi, tdt) if by_blocks
               else m(xi, tdt))
        out.backward(g)
        got.append((out, xi.grad, {n: p.grad for n, p in
                                   m.named_parameters()},
                    dict(m.named_buffers())))
    (o1, d1, g1, b1), (o2, d2, g2, b2) = got
    assert torch.equal(o1, o2) and torch.equal(d1, d2)
    for n in g1:
        assert torch.equal(g1[n], g2[n]), n
    for n in b1:
        assert torch.equal(b1[n], b2[n]), n
        assert not torch.equal(b1[n], base.state_dict()[n]), n


def _cs(x, jdt):
    return cs_conv.nhwc_to_cs(jnp.asarray(x, jdt), K)


def _nhwc(x_cs):
    return np.asarray(cs_conv.cs_to_nhwc(x_cs, K, H, W), np.float32)


def _np(t):
    return np.array(t.detach().float() if torch.is_tensor(t) else t,
                    dtype=np.float32)


def _close(got, ref, rel, what=''):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * np.abs(ref).max(), err_msg=what)


def _to_cs(w):
    """An HWIO (3, 3, C, C) weight as srtpu's CS (1, 3C, 3C) slice: the
    inverse of w_hwio_from_cs, found by a probe (the layout is a
    permutation)."""
    idx = torch.arange(9 * C * C, dtype=torch.float32).reshape(1, 3 * C,
                                                               3 * C)
    perm = w_hwio_from_cs(idx, C, C)[0].reshape(-1).long()
    out = torch.empty(9 * C * C)
    out[perm] = w.reshape(-1)
    return out.reshape(1, 3 * C, 3 * C).numpy()


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv('SRTPU_CS_OFF_TPU', '1')


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('rf', [False, True], ids=['same', 'reflect'])
def test_trunk_op_matches_srtpu_blocks(interpret, rf, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    g = rng.standard_normal((B, H, W, C)).astype(np.float32)
    m = _trunk(rf, 9)
    names = ['w1', 'b1', 'bn1_scale', 'bn1_bias', 'alpha', 'w2', 'b2',
             'bn2_scale', 'bn2_bias']
    close = ['close_w', 'close_b', 'close_bn_scale', 'close_bn_bias']

    def jp(name, t):
        t = t.detach()
        if name in ('w1', 'w2', 'close_w'):
            return jnp.asarray(_to_cs(t))
        return jnp.asarray(t.numpy().reshape(1, -1))
    blocks = [[jp(n, getattr(m, n)[i]) for n in names] for i in range(L)]
    cl = [jp(n, getattr(m, n)) for n in close]

    def fn(u, blocks, cl):
        xs, stats = u, []
        for prm in blocks:
            u, st = jbn.bn_resblock_cs(u, *prm, W, K, rf)
            stats.append(st)
        out, st = jbn.bn_close_cs(u, xs, *cl, W, K, rf)
        return out, (stats, st)
    (out_cs, stats), vjp = jax.vjp(fn, _cs(x, jdt), blocks, cl)
    dx_cs, dblocks, dcl = vjp((_cs(g, jdt), jax.tree_util.tree_map(
        jnp.zeros_like, stats)))

    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    out = m(xt, tdt)
    out.backward(torch.from_numpy(g).to(tdt))
    f32 = dtype == 'f32'
    act, grad = (1e-4, 1e-4) if f32 else (2.0 ** -5, 2.0 ** -5)
    _close(out, _nhwc(out_cs), act, 'out')
    _close(xt.grad, _nhwc(dx_cs), act, 'dx')
    # the running statistics moved by one step from (0, 1): their batch
    # values, 10 (ra - 0.9 ra0)
    for i, st in enumerate(stats[0]):
        for name, k in (('mean1', 0), ('var1', 1), ('mean2', 2),
                        ('var2', 3)):
            ra0 = 0.0 if name.startswith('mean') else 1.0
            batch = (getattr(m, name)[i] - 0.9 * ra0) / 0.1
            _close(batch, np.asarray(st[k]).reshape(-1), act, name)

    def check(name, got, ref):
        if name in ('b1', 'b2', 'close_b'):
            # a conv bias ahead of a batch norm: rounding noise on both
            # sides (the sum of the BN's input gradient, 0 in exact
            # arithmetic), held to the scale of the same conv's weight
            # grad, a sum over the same pixels of that gradient times x
            wname = {'b1': 'w1', 'b2': 'w2', 'close_b': 'close_w'}[name]
            scale = np.abs(_np(getattr(m, wname).grad)).max()
            np.testing.assert_allclose(_np(got), _np(ref), rtol=0,
                                       atol=grad * scale, err_msg=name)
            return
        if rf and name == 'bn2_bias':
            # with REFLECT every block's output cotangent sums to 0 over
            # the pixels (transposed reflect convs of zero-mean BN input
            # gradients, and their skips): BN2's shift grad, that sum, is
            # rounding noise too, held to the scale of BN2's scale grad
            # (a sum over the same pixels of that cotangent times xhat)
            scale = np.abs(_np(m.bn2_scale.grad)).max()
            np.testing.assert_allclose(_np(got), _np(ref), rtol=0,
                                       atol=grad * scale, err_msg=name)
            return
        tol = grad if f32 or name not in ('bn1_scale', 'bn2_scale',
                                          'alpha') else 2.0 ** -4
        _close(got, ref, tol, name)

    def port(name, r):
        r = torch.from_numpy(np.array(r, np.float32))
        if name in ('w1', 'w2', 'close_w'):
            return w_hwio_from_cs(r.reshape(1, 3 * C, 3 * C), C, C)[0]
        return r.reshape(-1)
    for j, n in enumerate(names):
        ref = torch.stack([port(n, dblocks[i][j]) for i in range(L)])
        check(n, getattr(m, n).grad, ref.reshape(getattr(m, n).shape))
    for j, n in enumerate(close):
        check(n, getattr(m, n).grad, port(n, dcl[j]).reshape(
            getattr(m, n).shape))


# ------------------------------------------------------------ K8b's form

FORMS = {'training': ((16, 32, 32, 64), 128),
         'predict-128': ((1, 128, 128, 64), 128),
         'predict-512x352': ((1, 512, 352, 64), 704),
         'ragged': ((2, 67, 45, 64), 128),
         'one-pixel': ((3, 1, 1, 8), 128)}


@pytest.mark.parametrize('case', FORMS)
def test_k8b_form(case):
    """K8b's two launches: K_PIX pixels a block, more only where an image
    would give more than MAX_SPLITS blocks."""
    shape, want = FORMS[case]
    bsz, h, w, c = shape
    kpix = k8b.block_pixels(h, w)
    assert kpix == want
    assert kpix >= k8b.K_PIX and -(-h * w // kpix) <= k8b.MAX_SPLITS
    assert kpix == k8b.K_PIX or -(-h * w // (kpix - 1)) > k8b.MAX_SPLITS


def test_k8b_held_forms_cover_rcan_true_route(monkeypatch):
    """RCAN's True route calls K8b once per RCAB on its residual (here a
    tiny RCAN, recorded); at chip_smoke's RCAN True runs (the training
    batch, and each predict slice's LR image) every block size is among
    those phase 2i holds (its three shapes and K8B_SHAPES)."""
    seen = []
    fwd = k8b.ca_layer_fwd

    def rec(x, *rest):
        seen.append(tuple(x.shape))
        return fwd(x, *rest)
    monkeypatch.setattr(k8b, 'ca_layer_fwd', rec)
    net = create_model('RCAN', scale_factor=4, n_feats=16, n_resgroups=2,
                       n_resblocks=2, reduction=4, use_pallas=True,
                       generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        net(torch.rand((1, 6, 5, 3)))
    assert seen == [(1, 6, 5, 16)] * 4
    cs = chip_smoke
    lr = cs.TRAIN_PATCH // cs.SCALE
    held = {k8b.block_pixels(h, w) for b, h, w in
            ((cs.TRAIN_BATCH, lr, lr), (1, 128, 128), (2, 67, 45),
             *cs.K8B_SHAPES)}
    runs = [(cs.TRAIN_BATCH, lr, lr)] + [(1, h // cs.SCALE, w // cs.SCALE)
                                         for h, w in cs.SLICE_SIZES]
    for b, h, w in runs:
        assert k8b.block_pixels(h, w) in held, (b, h, w)
