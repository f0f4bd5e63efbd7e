"""srtpu_torch's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; they skip on a host without a card. On the card (which
has no JAX, so the repo's conftest is left out)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: kernel and plain version round at the
same points and differ only in the order of the f32 sums, so an output
may land one bf16 step (2^-7 of the largest magnitude) away; K1's
skips carry such steps on through the blocks. The backward kernels'
dW and db sum the same bf16 products in f32 in another order: 1e-4 of
the largest magnitude; the trunk's weight grads read its bf16 dh1 chain,
which may sit one step apart: one step of the largest magnitude.
K5 (RCAB): the forward's out, h1 and r2 within one step, the backward's
dx within one step and its weight grads within one step (they read the
bf16 dr2 and dh1, computed from a gate whose f32 pool and MLP sums run in
another order); over a group, as K1's trunk.
K4 (SRResNet's BN block): within the per-element limits of
``bn_block.kernel_limits``: every bf16 output within one step; an f32
sum within its f32 rounding (2^-20 of the sum of its terms' magnitudes)
plus what the bf16 values it reads differ by; the backward fed sums that
make db a real value.
K2's general path (DDBPN's shapes, the x3 tails' 576 -> 32) as K2.
K6 (RDN's dense blocks): the bf16 outputs (cat, the buffers, dx, dout)
within two steps: a value a step apart is read by the later layers of
its block; the chain's bias grads db within one step of their largest
magnitude (they sum f32 dout behind such a value), its dwf, dbf and the
pair weight grads (the same bf16 operands) within 1e-4.
K7 (WDSR-B's block): out and dx within two steps (h1 and h2 round at the
same points, but a value a step apart is read by the next product), the
f32 weight and bias grads within one step (they sum products of those
bf16 values).
K4r (K4 with REFLECT boundaries, SRGAN's block): as K4, within
``bn_block.kernel_limits``; the SAME kernel on the same inputs (a halo
left at zero, a dropped fold) must fail them.
"""

import pytest
import torch

from srtpu_torch.models import create_model
from srtpu_torch.models import rdn as rdn_model
from srtpu_torch.ops import (b1_plain, b1_sums, b2_call, b2_plain, b3_call,
                             b3_plain, bn_block, f1_conv_stats, f1_plain,
                             f2_norm_act_conv_stats, f2_plain, f3_norm_skip,
                             f3_plain)
from srtpu_torch.ops import (conv3x3_bwd, conv3x3_bwd_plain, conv3x3_fwd,
                             conv3x3_plain, conv_wgrad, rcab_bwd,
                             rcab_bwd_plain, rcab_fwd, rcab_fwd_plain,
                             resgroup_bwd, resgroup_bwd_plain, resgroup_fwd,
                             resgroup_plain, trunk_bwd, trunk_bwd_plain,
                             trunk_fwd, trunk_plain, upsample_bwd,
                             upsample_bwd_plain, upsample_fwd, upsample_plain)
from srtpu_torch.ops import rdn as k6
from srtpu_torch.ops import wdsr as k7
from srtpu_torch.ops.layout import w_t

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cudnn.allow_tf32 = False   # f32 plain references
    return torch.device('cuda', 0)


def _u(gen, shape, bound, device, dtype=torch.bfloat16):
    t = torch.empty(shape).uniform_(-bound, bound, generator=gen)
    return t.to(device, dtype)


def _conv(gen, cin, cout, device, lead=()):
    bound = (9 * cin) ** -0.5
    return (_u(gen, (*lead, 3, 3, cin, cout), bound, device),
            _u(gen, (*lead, cout), bound, device, torch.float32))


@pytest.mark.parametrize('h,w', [(1, 1), (7, 16), (9, 33), (40, 17)])
@pytest.mark.parametrize('case', ['close', 'pm', 'pd', 'ups', 'trunk'])
def test_kernel_matches_plain(device, case, h, w):
    gen = torch.Generator().manual_seed(h * 100 + w)
    batch = 2
    if case == 'trunk':
        w1, b1 = _conv(gen, 64, 64, device, (3,))
        w2, b2 = _conv(gen, 64, 64, device, (3,))
        args = (_u(gen, (batch, h, w, 64), 1.0, device), w1, b1, w2, b2, 0.5)
        fn, plain, steps = trunk_fwd, trunk_plain, 2
    elif case == 'ups':
        args = (_u(gen, (batch, h, w, 64), 1.0, device),
                *_conv(gen, 64, 256, device), 2)
        fn, plain, steps = upsample_fwd, upsample_plain, 1
    else:
        cin, cout = {'close': (64, 64), 'pm': (64, 256), 'pd': (256, 16)}[case]
        args = (_u(gen, (batch, h, w, cin), 1.0, device),
                *_conv(gen, cin, cout, device))
        fn, plain, steps = conv3x3_fwd, conv3x3_plain, 1
    before = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches > before
    ref = plain(*args)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    tol = steps * 2.0 ** -7 * ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= tol


def _bwd_case(gen, case, batch, h, w, device):
    """(kernel, plain, args, dx steps, weight-grad tolerance in steps or
    None for 1e-4 relative) of one backward at an h x w LR."""
    if case == 'trunk':
        w1, b1 = _conv(gen, 64, 64, device, (3,))
        w2, b2 = _conv(gen, 64, 64, device, (3,))
        x = _u(gen, (batch, h, w, 64), 1.0, device)
        _, xs, h1s = trunk_fwd(x, w1, b1, w2, b2, 0.5, save=True)
        args = (xs, h1s, _u(gen, (batch, h, w, 64), 1.0, device), w1, w2,
                0.5)
        return trunk_bwd, trunk_bwd_plain, args, 2, 1
    if case == 'ups':
        wt, _ = _conv(gen, 64, 256, device)
        args = (_u(gen, (batch, h, w, 64), 1.0, device), wt,
                _u(gen, (batch, 2 * h, 2 * w, 64), 1.0, device), 2)
        return upsample_bwd, upsample_bwd_plain, args, 1, None
    cin, cout = {'close': (64, 64), 'pm': (64, 256), 'pd': (256, 16)}[case]
    wt, _ = _conv(gen, cin, cout, device)
    args = (_u(gen, (batch, h, w, cin), 1.0, device), wt,
            _u(gen, (batch, h, w, cout), 1.0, device))
    return conv3x3_bwd, conv3x3_bwd_plain, args, 1, None


def _assert_close(got, ref, steps=None):
    assert got.shape == ref.shape and got.dtype == ref.dtype
    top = ref.float().abs().max().item()
    tol = steps * 2.0 ** -7 * top if steps else 1e-4 * top
    assert (got.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize('h,w', [(1, 1), (7, 16), (9, 33), (40, 17)])
@pytest.mark.parametrize('case', ['close', 'pm', 'pd', 'ups', 'trunk'])
def test_bwd_kernel_matches_plain(device, case, h, w):
    """Each backward kernel (dx, and dW / db through the weight-grad
    kernel) against its plain backward, and bit-identical on a second
    call (no float atomics)."""
    gen = torch.Generator().manual_seed(h * 100 + w + 7)
    fn, plain, args, dx_steps, dw_steps = _bwd_case(gen, case, 2, h, w,
                                                    device)
    before = fn.launches, conv_wgrad.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches > before[0] and conv_wgrad.launches > before[1]
    ref = plain(*args)
    _assert_close(got[0], ref[0], dx_steps)
    for g_t, r_t in zip(got[1:], ref[1:]):
        assert g_t.dtype == torch.float32
        _assert_close(g_t, r_t, dw_steps)
    again = fn(*args)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_train_step_kernel_path_matches_plain(device):
    """One EDSR x4 step (L1, Adam), kernel path against plain path from
    the same params and batch: the loss within 2^-7 relative, every
    gradient within 2^-4 of its largest magnitude (the two paths' bf16
    activations may sit a rounding step apart, which the backward
    carries on)."""
    from srtpu_torch.losses import parse_losses
    from srtpu_torch.optim import build_optimizer
    from srtpu_torch.train import TrainState, make_train_step
    gen = torch.Generator().manual_seed(5)
    lr = torch.rand((2, 12, 20, 3), generator=gen).to(device)
    hr = torch.rand((2, 48, 80, 3), generator=gen).to(device)
    grads, losses = [], []
    for plain in (False, True):
        model = create_model('EDSR', scale_factor=4, n_feats=64,
                             n_resblocks=2, dtype=torch.bfloat16,
                             device=device,
                             generator=torch.Generator().manual_seed(4))
        state = TrainState(model, build_optimizer(
            'ADAM', ['lr=1e-4'], model.parameters()))
        step = make_train_step(parse_losses('l1'), plain=plain)
        logs = step(state, lr, hr)
        losses.append(float(logs['loss']))
        grads.append([p.grad for p in model.parameters()])
    assert abs(losses[0] - losses[1]) <= 2.0 ** -7 * losses[1]
    for got, ref in zip(*grads):
        assert got.dtype == torch.float32
        top = ref.abs().max().item()
        assert (got - ref).abs().max().item() <= 2.0 ** -4 * top


@pytest.mark.parametrize('scale', [2, 3, 4, 8])
def test_edsr_kernel_path_matches_plain(device, scale):
    model = create_model('EDSR', scale_factor=scale, n_feats=64,
                         n_resblocks=2, dtype=torch.bfloat16, device=device,
                         generator=torch.Generator().manual_seed(scale))
    gen = torch.Generator().manual_seed(0)
    lr = torch.rand((1, 20, 28, 3), generator=gen).to(device)
    with torch.inference_mode():
        got = model(lr).float()
        ref = model(lr, plain=True).float()
    assert got.shape == (1, 20 * scale, 28 * scale, 3)
    assert (got - ref).abs().max().item() <= 2.0 ** -6


def test_wrapper_rejects_unsupported_shapes(device):
    x = torch.zeros(1, 4, 4, 24, dtype=torch.bfloat16, device=device)
    w = torch.zeros(3, 3, 24, 32, dtype=torch.bfloat16, device=device)
    b = torch.zeros(32, device=device)
    with pytest.raises(ValueError, match='no kernel'):
        conv3x3_fwd(x, w, b)
    with pytest.raises(TypeError):
        conv3x3_fwd(torch.zeros(1, 4, 4, 64, device=device),
                    torch.zeros(3, 3, 64, 64, device=device),
                    torch.zeros(64, device=device))


def _mlp(gen, device, lead=(), c=64, cr=4):
    return (_u(gen, (*lead, c, cr), c ** -0.5, device, torch.float32),
            _u(gen, (*lead, cr), c ** -0.5, device, torch.float32),
            _u(gen, (*lead, cr, c), cr ** -0.5, device, torch.float32),
            _u(gen, (*lead, c), cr ** -0.5, device, torch.float32))


@pytest.mark.parametrize('h,w', [(1, 1), (7, 16), (9, 33), (40, 17)])
def test_rcab_kernel_matches_plain(device, h, w):
    """K5 forward (saving: out, h1, r2) and backward (dx and the eight
    f32 grads) against the plain versions; the backward bit-identical
    on a second call."""
    gen = torch.Generator().manual_seed(h * 100 + w + 11)
    w1, b1 = _conv(gen, 64, 64, device)
    w2, b2 = _conv(gen, 64, 64, device)
    prm = (w1, b1, w2, b2, *_mlp(gen, device))
    x = _u(gen, (2, h, w, 64), 1.0, device)
    before = rcab_fwd.launches
    got = rcab_fwd(x, *prm, save=True)
    torch.cuda.synchronize()
    assert rcab_fwd.launches == before + 1
    ref = rcab_fwd_plain(x, *prm, save=True)
    for g_t, r_t in zip(got, ref):
        _assert_close(g_t, r_t, 1)
    assert torch.equal(rcab_fwd(x, *prm), got[0])
    _, h1, r2 = ref
    g = _u(gen, (2, h, w, 64), 1.0, device)
    args = (x, h1, r2, g, w1, w2, *prm[4:])
    before = rcab_bwd.launches, conv_wgrad.launches
    got = rcab_bwd(*args)
    torch.cuda.synchronize()
    assert rcab_bwd.launches == before[0] + 1
    assert conv_wgrad.launches == before[1] + 2
    ref = rcab_bwd_plain(*args)
    for g_t, r_t in zip(got, ref):
        assert g_t.dtype == r_t.dtype
        _assert_close(g_t, r_t, 1)
    assert all(torch.equal(a, b) for a, b in zip(got, rcab_bwd(*args)))


@pytest.mark.parametrize('h,w', [(7, 16), (9, 33)])
def test_resgroup_kernel_matches_plain(device, h, w):
    """A 3-block group forward (saving) and backward, kernel path against
    plain: activations and dx within 2 steps, weight grads within 2 steps
    (2^-6) of their largest magnitude."""
    gen = torch.Generator().manual_seed(h * 100 + w + 13)
    w1, b1 = _conv(gen, 64, 64, device, (3,))
    w2, b2 = _conv(gen, 64, 64, device, (3,))
    wc, bc = _conv(gen, 64, 64, device)
    prm = (w1, b1, w2, b2, *_mlp(gen, device, (3,)), wc, bc)
    x = _u(gen, (2, h, w, 64), 1.0, device)
    got = resgroup_fwd(x, *prm, save=True)
    ref = resgroup_plain(x, *prm, save=True)
    for g_t, r_t in zip(got, ref):
        _assert_close(g_t, r_t, 2)
    g = _u(gen, (2, h, w, 64), 1.0, device)
    saved, weights = ref[1:], (w1, w2, *prm[4:8], wc)
    got = resgroup_bwd(*saved, g, *weights)
    ref = resgroup_bwd_plain(*saved, g, *weights)
    for g_t, r_t in zip(got, ref):
        _assert_close(g_t, r_t, 2)


@pytest.mark.parametrize('scale', [2, 3, 4])
def test_rcan_kernel_path_matches_plain(device, scale):
    """RCAN (2 groups of 2 RCABs, 64 features) on the card, kernel path
    against plain path; x3 runs here because RCAN's tail is cuDNN."""
    model = create_model('RCAN', scale_factor=scale, n_feats=64,
                         n_resblocks=2, n_resgroups=2, dtype=torch.bfloat16,
                         device=device,
                         generator=torch.Generator().manual_seed(scale))
    gen = torch.Generator().manual_seed(1)
    lr = torch.rand((2, 20, 28, 3), generator=gen).to(device)
    with torch.inference_mode():
        got = model(lr).float()
        ref = model(lr, plain=True).float()
    assert got.shape == (2, 20 * scale, 28 * scale, 3)
    assert (got - ref).abs().max().item() <= 2.0 ** -6


def _bn_case(gen, device, h, w, batch=2):
    """Inputs of one BN block at 64 channels: activations, a weight, f32
    vectors, and the statistics of y1 and y2 as F1 and F2 give them."""
    f32 = torch.float32
    u = _u(gen, (batch, h, w, 64), 1.0, device)
    w1, b1 = _conv(gen, 64, 64, device)
    w2, b2 = _conv(gen, 64, 64, device)
    gam = [_u(gen, (64,), 0.5, device, f32) + 1.0 for _ in range(2)]
    bet = [_u(gen, (64,), 0.3, device, f32) for _ in range(2)]
    alpha = torch.full((1,), 0.25, device=device)
    y1, st1 = f1_plain(u, w1, b1, gam[0], bet[0])
    y2, h1, st2 = f2_plain(y1, st1, alpha, w2, b2, gam[1], bet[1])
    g = _u(gen, (batch, h, w, 64), 1.0, device)
    return dict(u=u, w1=w1, b1=b1, w2=w2, b2=b2, gam=gam, bet=bet,
                alpha=alpha, y1=y1, st1=st1, y2=y2, h1=h1, st2=st2, g=g)


def _off_sums(gen, t):
    """Backward sums (2, 64) at the scale of t's but not t's, so that db
    = sum dy is a real value."""
    m = t.shape[0] * t.shape[1] * t.shape[2]
    rms = t.float().pow(2).mean().sqrt().item()
    return _u(gen, (2, 64), m ** 0.5 * rms, t.device, torch.float32)


def _k4_calls(gen, c):
    """(kernel, plain, args) of the six K4 functions on one case."""
    sums2 = _off_sums(gen, c['g'])
    dz = b2_plain(c['g'], c['y2'], c['st2'], c['gam'][1], sums2, c['y1'],
                  c['st1'], c['alpha'], c['w2'])[0]
    sums1 = _off_sums(gen, dz)
    return {
        'f1': (f1_conv_stats, f1_plain,
               (c['u'], c['w1'], c['b1'], c['gam'][0], c['bet'][0])),
        'f2': (f2_norm_act_conv_stats, f2_plain,
               (c['y1'], c['st1'], c['alpha'], c['w2'], c['b2'], c['gam'][1],
                c['bet'][1])),
        'f3': (f3_norm_skip, f3_plain, (c['y2'], c['st2'], c['u'])),
        'b1': (b1_sums, b1_plain, (c['g'], c['y2'], c['st2'])),
        'b2': (b2_call, b2_plain,
               (c['g'], c['y2'], c['st2'], c['gam'][1], sums2, c['y1'],
                c['st1'], c['alpha'], c['w2'])),
        'b3': (b3_call, b3_plain,
               (dz, c['y1'], c['st1'], c['gam'][0], sums1, c['w1'], c['g'])),
    }


def _flat(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


@pytest.mark.parametrize('h,w', [(1, 1), (7, 16), (9, 33), (40, 17)])
@pytest.mark.parametrize('fn', ['f1', 'f2', 'f3', 'b1', 'b2', 'b3'])
def test_k4_kernel_matches_plain(device, fn, h, w):
    """Each K4 kernel against its plain version on the same inputs, one
    launch counted, and bit-identical on a second call (no float
    atomics)."""
    gen = torch.Generator().manual_seed(h * 100 + w + 17)
    kernel, plain, args = _k4_calls(gen, _bn_case(gen, device, h, w))[fn]
    before = kernel.launches
    got = _flat(kernel(*args))
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref = _flat(plain(*args))
    assert len(got) == len(ref)
    lims = bn_block.kernel_limits(fn, args, ref, got)
    for g_t, r_t, lim in zip(got, ref, lims):
        assert g_t.dtype == r_t.dtype and g_t.shape == r_t.shape
        assert bool(((g_t.float() - r_t.float()).abs() <= lim).all())
    assert all(torch.equal(a, b) for a, b in zip(got, _flat(kernel(*args))))


@pytest.mark.parametrize('h,w', [(1, 1), (6, 16), (9, 33), (40, 17)])
def test_conv5x5_kernel_matches_plain(device, h, w):
    """K2 at 5x5, SRResNet's phase-dense 256 -> 16 conv: the forward
    within one step, the backward's dx within one step and dW, db within
    1e-4 of their largest magnitude; the backward bit-identical twice."""
    gen = torch.Generator().manual_seed(h * 100 + w + 19)
    x = _u(gen, (2, h, w, 256), 1.0, device)
    wt = _u(gen, (5, 5, 256, 16), (25 * 256) ** -0.5, device)
    b = _u(gen, (16,), 0.1, device, torch.float32)
    before = conv3x3_fwd.launches_5x5, conv3x3_fwd.launches
    got = conv3x3_fwd(x, wt, b)
    torch.cuda.synchronize()
    assert (conv3x3_fwd.launches_5x5, conv3x3_fwd.launches) == (
        before[0] + 1, before[1])
    _assert_close(got, conv3x3_plain(x, wt, b), 1)
    g = _u(gen, (2, h, w, 16), 1.0, device)
    before = conv3x3_bwd.launches_5x5, conv3x3_bwd.launches
    got = conv3x3_bwd(x, wt, g)
    assert (conv3x3_bwd.launches_5x5, conv3x3_bwd.launches) == (
        before[0] + 1, before[1])
    ref = conv3x3_bwd_plain(x, wt, g)
    assert got[1].shape == (5, 5, 256, 16)
    _assert_close(got[0], ref[0], 1)
    for g_t, r_t in zip(got[1:], ref[1:]):
        _assert_close(g_t, r_t)
    assert all(torch.equal(a, b) for a, b in zip(got, conv3x3_bwd(x, wt, g)))


@pytest.mark.parametrize('scale', [2, 3, 4, 8])
@pytest.mark.parametrize('train', [False, True])
def test_srresnet_kernel_path_matches_plain(device, scale, train):
    """SRResNet (2 resblocks, 64 features) on the card, kernel path
    against plain path: eval mode (K2, K3; the BN trunk on running
    statistics) and train mode (K4 too, batch statistics); x3's 576 -> 32
    5x5 tail on K2's general path."""
    model = create_model('SRResNet', scale_factor=scale, n_feats=64,
                         n_resblocks=2, dtype=torch.bfloat16, device=device,
                         generator=torch.Generator().manual_seed(scale))
    model.train(train)
    gen = torch.Generator().manual_seed(2)
    lr = torch.rand((2, 20, 28, 3), generator=gen).to(device)
    with torch.no_grad():
        got = model(lr).float()
        ref = model(lr, plain=True).float()
    assert got.shape == (2, 20 * scale, 28 * scale, 3)
    # batch norm rescales a step's difference by the batch deviation
    assert (got - ref).abs().max().item() <= 2.0 ** -5


# K2's general path: DDBPN x4 (nr 32) and x2, the x3 tails; (cin, cout, k)
GENERAL_SHAPES = [(32, 512, 3), (512, 32, 3), (512, 48, 3), (32, 128, 3),
                  (128, 32, 3), (128, 16, 3), (576, 32, 3), (576, 32, 5)]


@pytest.mark.parametrize('h,w', [(1, 1), (7, 16), (9, 33)])
@pytest.mark.parametrize('cin,cout,k', GENERAL_SHAPES)
def test_k2_general_path_matches_plain(device, cin, cout, k, h, w):
    """K2 at the general path's shapes: the forward within one step,
    the backward's dx (the reverse shape) within one step and dW, db
    within 1e-4 of their largest magnitude, one launch of each counted,
    the backward bit-identical twice."""
    from srtpu_torch.ops.conv import _own_instance
    gen = torch.Generator().manual_seed(cin * 7 + cout + k + h * 100 + w)
    x = _u(gen, (2, h, w, cin), 1.0, device)
    wt = _u(gen, (k, k, cin, cout), (k * k * cin) ** -0.5, device)
    b = _u(gen, (cout,), 0.1, device, torch.float32)
    sfx = '_5x5' if k == 5 else ''
    before = getattr(conv3x3_fwd, 'launches_general' + sfx)
    got = conv3x3_fwd(x, wt, b)
    torch.cuda.synchronize()
    assert getattr(conv3x3_fwd, 'launches_general' + sfx) == before + 1
    _assert_close(got, conv3x3_plain(x, wt, b), 1)
    g = _u(gen, (2, h, w, cout), 1.0, device)
    # dx is the reverse shape: DDBPN x2's 16 -> 128 has an own instance
    dx_attr = ('launches' if _own_instance(cout, cin, k)
               else 'launches_general') + sfx
    before = getattr(conv3x3_bwd, dx_attr), conv_wgrad.launches_general
    got = conv3x3_bwd(x, wt, g)
    torch.cuda.synchronize()
    assert (getattr(conv3x3_bwd, dx_attr), conv_wgrad.launches_general) == (
        before[0] + 1, before[1] + 1)
    ref = conv3x3_bwd_plain(x, wt, g)
    _assert_close(got[0], ref[0], 1)
    for g_t, r_t in zip(got[1:], ref[1:]):
        _assert_close(g_t, r_t)
    assert all(torch.equal(a, c) for a, c in zip(got, conv3x3_bwd(x, wt, g)))


def _ddbpn(device, scale, seed=0):
    return create_model('DDBPN', scale_factor=scale, n0=32, nr=32, depth=3,
                        dtype=torch.bfloat16, device=device,
                        generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize('scale', [2, 4])
def test_ddbpn_kernel_path_matches_plain(device, scale):
    """DDBPN (nr 32, depth 3) on the card, kernel path against plain
    path: 3 K2 launches per unit (5 units) and one per HR block (3)."""
    model = _ddbpn(device, scale, scale)
    lr = torch.rand((2, 20, 28, 3),
                    generator=torch.Generator().manual_seed(3)).to(device)
    before = conv3x3_fwd.launches_general
    with torch.inference_mode():
        got = model(lr).float()
        assert conv3x3_fwd.launches_general == before + 15 + 3
        ref = model(lr, plain=True).float()
    assert got.shape == (2, 20 * scale, 28 * scale, 3)
    assert (got - ref).abs().max().item() <= 2.0 ** -6


def test_ddbpn_train_step_kernel_path_matches_plain(device):
    """One DDBPN x4 step (L1, Adam), kernel path against plain path from
    the same params and batch (as EDSR's); every dead-tap slot's gradient
    exactly 0 on the card."""
    from srtpu_torch.losses import parse_losses
    from srtpu_torch.optim import build_optimizer
    from srtpu_torch.train import TrainState, make_train_step
    gen = torch.Generator().manual_seed(6)
    lr = torch.rand((2, 12, 20, 3), generator=gen).to(device)
    hr = torch.rand((2, 48, 80, 3), generator=gen).to(device)
    grads, losses = [], []
    for plain in (False, True):
        model = _ddbpn(device, 4, 1)
        state = TrainState(model, build_optimizer(
            'ADAM', ['lr=1e-4'], model.parameters()))
        logs = make_train_step(parse_losses('l1'), plain=plain)(state, lr, hr)
        losses.append(float(logs['loss']))
        grads.append({n: p.grad for n, p in model.named_parameters()})
    assert abs(losses[0] - losses[1]) <= 2.0 ** -7 * losses[1]
    for n, got in grads[0].items():
        assert got.dtype == torch.float32
        top = grads[1][n].abs().max().item()
        assert (got - grads[1][n]).abs().max().item() <= 2.0 ** -4 * top, n
    masks = {True: model.m_up, False: model.m_down}
    for i, unit in enumerate(model.units):
        for name, is_up in (('a0', unit.up), ('b0', not unit.up),
                            ('a1', unit.up)):
            g = grads[0][f'units.{i}.{name}_weight']
            assert torch.all(g[masks[is_up] == 0] == 0), (i, name)


def _k6_case(gen, device, h, w, batch=2, d=2, c=3):
    """Inputs of the K6 functions at G0 = 64 (x, packed dense weights,
    biases, fusion weight and bias) at srtpu's init bounds."""
    f32 = torch.float32
    c_tot = 64 * (c + 1)
    ws = [_u(gen, (d, 3, 3, 64 * (i + 1), 64), (576 * (i + 1)) ** -0.5,
             device) for i in range(c)]
    return (_u(gen, (batch, h, w, 64), 1.0, device), k6.pack(ws),
            _u(gen, (d, c, 64), 0.05, device, f32),
            _u(gen, (d, c_tot, 64), c_tot ** -0.5, device),
            _u(gen, (d, 64), c_tot ** -0.5, device, f32))


@pytest.mark.parametrize('h,w', [(1, 1), (7, 16), (9, 33), (40, 17)])
def test_k6_fwd_kernel_matches_plain(device, h, w):
    """K6's forward (2 blocks of 3 layers) against its plain version: cat
    and every saved buffer, one call counted, bit-identical twice; the
    predict variant (one shared buffer) gives the same cat."""
    gen = torch.Generator().manual_seed(h * 100 + w + 23)
    args = _k6_case(gen, device, h, w)
    before = k6.rdn_fwd.launches
    cat, bufs = k6.rdn_fwd(*args, save=True)
    torch.cuda.synchronize()
    assert k6.rdn_fwd.launches == before + 1
    ref_cat, ref_bufs = k6.rdn_fwd_plain(*args, save=True)
    _assert_close(cat, ref_cat, 2)
    _assert_close(bufs, ref_bufs, 2)
    again = k6.rdn_fwd(*args, save=True)
    assert torch.equal(again[0], cat) and torch.equal(again[1], bufs)
    assert torch.equal(k6.rdn_fwd(*args), cat)


@pytest.mark.parametrize('h,w', [(1, 1), (7, 16), (9, 33), (40, 17)])
def test_k6_bwd_kernels_match_plain(device, h, w):
    """K6's chain and weight grads against their plain versions, block by
    block in reverse from the plain forward's buffers, each bit-identical
    on a second call (no float atomics)."""
    gen = torch.Generator().manual_seed(h * 100 + w + 29)
    x, wpk, b, wf, bf = _k6_case(gen, device, h, w)
    _, bufs = k6.rdn_fwd_plain(x, wpk, b, wf, bf, save=True)
    d = bufs.shape[0]
    g = _u(gen, x.shape, 1.0, device)
    ct = _u(gen, (*x.shape[:3], 64 * d), 1.0, device)
    wtpk, wft = w_t(wpk).contiguous(), wf.transpose(1, 2).contiguous()
    for l in reversed(range(d)):
        before = k6.rdb_bwd_chain.launches, k6.rdb_bwd_dw.launches
        got = k6.rdb_bwd_chain(bufs, l, g, ct, wtpk, wft)
        torch.cuda.synchronize()
        ref = k6.rdb_bwd_chain_plain(bufs, l, g, ct, wtpk, wft)
        for g_t, r_t, steps in zip(got, ref, (2, 2, None, None, 1)):
            _assert_close(g_t, r_t, steps)
        assert all(torch.equal(a, c) for a, c in
                   zip(got, k6.rdb_bwd_chain(bufs, l, g, ct, wtpk, wft)))
        dw = k6.rdb_bwd_dw(bufs, l, ref[1])
        assert (k6.rdb_bwd_chain.launches, k6.rdb_bwd_dw.launches) == (
            before[0] + 2, before[1] + 1)
        _assert_close(dw, k6.rdb_bwd_dw_plain(bufs, l, ref[1]))
        assert torch.equal(dw, k6.rdb_bwd_dw(bufs, l, ref[1]))
        g = ref[0]


def _rdn(monkeypatch, device, scale):
    """RDN at 2 blocks of 3 layers, G = G0 = 64, bf16."""
    monkeypatch.setitem(rdn_model.RDN_CONFIGS, 'T', (2, 3, 64))
    return create_model('RDN', scale_factor=scale, rdn_config='T',
                        growth0=64, dtype=torch.bfloat16, device=device,
                        generator=torch.Generator().manual_seed(scale))


@pytest.mark.parametrize('scale', [2, 3, 4])
def test_rdn_kernel_path_matches_plain(device, monkeypatch, scale):
    """RDN on the card, kernel path against plain path; x3 runs (the tail
    is cuDNN). Per forward: K6 once, K2 twice (SFE2, GFF2)."""
    model = _rdn(monkeypatch, device, scale)
    lr = torch.rand((2, 20, 28, 3),
                    generator=torch.Generator().manual_seed(3)).to(device)
    before = k6.rdn_fwd.launches, conv3x3_fwd.launches
    with torch.inference_mode():
        got = model(lr).float()
        assert (k6.rdn_fwd.launches, conv3x3_fwd.launches) == (
            before[0] + 1, before[1] + 2)
        ref = model(lr, plain=True).float()
    assert got.shape == (2, 20 * scale, 28 * scale, 3)
    assert (got - ref).abs().max().item() <= 2.0 ** -6


def test_rdn_train_step_kernel_path_matches_plain(device, monkeypatch):
    """One RDN x4 step (L1, Adam), kernel path against plain path from
    the same params and batch: the loss within 2^-7 relative, every
    gradient f32 and within 2^-4 of its largest magnitude (as EDSR's);
    K6 forward once, chain and weight grads once per block."""
    from srtpu_torch.losses import parse_losses
    from srtpu_torch.optim import build_optimizer
    from srtpu_torch.train import TrainState, make_train_step
    gen = torch.Generator().manual_seed(6)
    lr = torch.rand((2, 12, 20, 3), generator=gen).to(device)
    hr = torch.rand((2, 48, 80, 3), generator=gen).to(device)
    grads, losses = [], []
    counters = (k6.rdn_fwd, k6.rdb_bwd_chain, k6.rdb_bwd_dw)
    for plain in (False, True):
        model = _rdn(monkeypatch, device, 4)
        state = TrainState(model, build_optimizer(
            'ADAM', ['lr=1e-4'], model.parameters()))
        before = [fn.launches for fn in counters]
        logs = make_train_step(parse_losses('l1'), plain=plain)(state, lr, hr)
        torch.cuda.synchronize()
        assert [fn.launches - n for fn, n in zip(counters, before)] == (
            [0, 0, 0] if plain else [1, 2, 2])
        losses.append(float(logs['loss']))
        grads.append([p.grad for p in model.parameters()])
    assert abs(losses[0] - losses[1]) <= 2.0 ** -7 * losses[1]
    for got, ref in zip(*grads):
        assert got.dtype == torch.float32
        top = ref.abs().max().item()
        assert (got - ref).abs().max().item() <= 2.0 ** -4 * top


def test_k6_wrappers_reject_what_the_kernels_do_not_take(device):
    gen = torch.Generator().manual_seed(0)
    x, wpk, b, wf, bf = _k6_case(gen, device, 4, 4)
    with pytest.raises(ValueError, match='no kernel'):
        k6.rdn_fwd(x[..., :32].contiguous(), wpk, b, wf, bf)
    with pytest.raises(TypeError):
        k6.rdn_fwd(x.float(), wpk, b, wf, bf)
    with pytest.raises(ValueError):
        k6.rdn_fwd(x, wpk, b, wf[:, :128].contiguous(), bf)


def _k7_case(gen, device, bsz, h, w, c):
    """K7's operands at width c (e = 6c; the bottleneck L = int(0.8 c)
    zero-padded to Lp, as wdsr_block pads it) at srtpu's init bounds, and
    a cotangent."""
    f32 = torch.float32
    e = 6 * c
    lv, lp = k7.wdsr_lp(c)
    w2 = _u(gen, (e, lp), e ** -0.5, device)
    w2[:, lv:] = 0
    b2 = _u(gen, (lp,), e ** -0.5, device, f32)
    b2[lv:] = 0
    w3 = _u(gen, (3, 3, lp, c), (9 * lv) ** -0.5, device)
    w3[:, :, lv:] = 0
    return (_u(gen, (bsz, h, w, c), 1.0, device),
            _u(gen, (c, e), c ** -0.5, device),
            _u(gen, (e,), c ** -0.5, device, f32), w2, b2, w3,
            _u(gen, (c,), (9 * lv) ** -0.5, device, f32),
            _u(gen, (bsz, h, w, c), 1.0, device))


@pytest.mark.parametrize('h,w', [(1, 1), (7, 16), (9, 33), (40, 17)])
@pytest.mark.parametrize('c', [16, 64, 128])
def test_k7_kernels_match_plain(device, c, h, w):
    """K7's forward and backward against their plain versions at res_scale
    0.5: out and dx within two bf16 steps of their largest magnitude (h1
    and h2 round at the same points, but a value next to a rounding
    boundary may land a step apart and the next product reads it), the
    f32 grads within one step; each call counted once, bit-identical on a
    second call (no float atomics)."""
    gen = torch.Generator().manual_seed(c * 1000 + h * 100 + w)
    x, w1, b1, w2, b2, w3, b3, g = _k7_case(gen, device, 2, h, w, c)
    before = k7.wdsr_fwd.launches, k7.wdsr_bwd.launches
    out = k7.wdsr_fwd(x, w1, b1, w2, b2, w3, b3, 0.5)
    torch.cuda.synchronize()
    _assert_close(out, k7.wdsr_fwd_plain(x, w1, b1, w2, b2, w3, b3, 0.5), 2)
    assert torch.equal(out, k7.wdsr_fwd(x, w1, b1, w2, b2, w3, b3, 0.5))
    got = k7.wdsr_bwd(x, g, w1, b1, w2, b2, w3, 0.5)
    torch.cuda.synchronize()
    ref = k7.wdsr_bwd_plain(x, g, w1, b1, w2, b2, w3, 0.5)
    for g_t, r_t, steps in zip(got, ref, (2, 1, 1, 1, 1, 1, 1)):
        _assert_close(g_t, r_t, steps)
    assert all(torch.equal(a, b) for a, b in
               zip(got, k7.wdsr_bwd(x, g, w1, b1, w2, b2, w3, 0.5)))
    assert (k7.wdsr_fwd.launches, k7.wdsr_bwd.launches) == (
        before[0] + 2, before[1] + 2)


def test_k7_wrappers_reject_what_the_kernels_do_not_take(device):
    """C not a multiple of 16, or wider than 128, raises on the card."""
    gen = torch.Generator().manual_seed(0)
    for c in (24, 144):
        x, w1, b1, w2, b2, w3, b3, g = _k7_case(gen, device, 1, 4, 4, c)
        with pytest.raises(ValueError, match='no kernel'):
            k7.wdsr_fwd(x, w1, b1, w2, b2, w3, b3, 1.0)
        with pytest.raises(ValueError, match='no kernel'):
            k7.wdsr_bwd(x, g, w1, b1, w2, b2, w3, 1.0)


def _wdsr(device, scale, n_feats=128, seed=0):
    """WDSR-B on K7's route ('cs'), 2 blocks, bf16."""
    return create_model('WDSR', scale_factor=scale, n_feats=n_feats,
                        n_resblocks=2, use_pallas='cs', dtype=torch.bfloat16,
                        device=device,
                        generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize('scale', [2, 3, 4, 8])
def test_wdsr_kernel_path_matches_plain(device, scale):
    """WDSR-B predict on the card, kernel path against plain path at every
    scale (the tail is cuDNN): one K7 forward per block, the SR image
    within 2^-6."""
    model = _wdsr(device, scale)
    lr = torch.rand((2, 20, 28, 3),
                    generator=torch.Generator().manual_seed(5)).to(device)
    before = k7.wdsr_fwd.launches
    with torch.inference_mode():
        got = model(lr).float()
        assert k7.wdsr_fwd.launches == before + 2
        ref = model(lr, plain=True).float()
    assert got.shape == (2, 20 * scale, 28 * scale, 3)
    assert (got - ref).abs().max().item() <= 2.0 ** -6


def test_wdsr_train_step_kernel_path_matches_plain(device):
    """One WDSR-B x4 step (L1, Adam), kernel path against plain path from
    the same params and batch: the loss within 2^-7 relative, every
    gradient (v, g and bias of every conv) f32 and within 2^-4 of its
    largest magnitude (as RDN's); K7 once each way per block."""
    from srtpu_torch.losses import parse_losses
    from srtpu_torch.optim import build_optimizer
    from srtpu_torch.train import TrainState, make_train_step
    gen = torch.Generator().manual_seed(6)
    lr = torch.rand((2, 12, 20, 3), generator=gen).to(device)
    hr = torch.rand((2, 48, 80, 3), generator=gen).to(device)
    grads, losses = [], []
    for plain in (False, True):
        model = _wdsr(device, 4)
        state = TrainState(model, build_optimizer(
            'ADAM', ['lr=1e-4'], model.parameters()))
        before = k7.wdsr_fwd.launches, k7.wdsr_bwd.launches
        logs = make_train_step(parse_losses('l1'), plain=plain)(state, lr, hr)
        torch.cuda.synchronize()
        assert (k7.wdsr_fwd.launches - before[0],
                k7.wdsr_bwd.launches - before[1]) == ((0, 0) if plain
                                                       else (2, 2))
        losses.append(float(logs['loss']))
        grads.append([p.grad for p in model.parameters()])
    assert abs(losses[0] - losses[1]) <= 2.0 ** -7 * losses[1]
    for got, ref in zip(*grads):
        assert got.dtype == torch.float32
        top = ref.abs().max().item()
        assert (got - ref).abs().max().item() <= 2.0 ** -4 * top


# ------------------------------------------------------ K4r and SRGAN

def _k4r_calls(gen, device, bsz, h, w):
    """(kernel, plain, args) of K4r's four functions (reflect=True last)
    on one block's inputs at 64 channels."""
    f32 = torch.float32
    u, g = (_u(gen, (bsz, h, w, 64), 1.0, device) for _ in range(2))
    w1, b1 = _conv(gen, 64, 64, device)
    w2, b2 = _conv(gen, 64, 64, device)
    gam = [_u(gen, (64,), 0.5, device, f32) + 1.0 for _ in range(2)]
    bet = [_u(gen, (64,), 0.3, device, f32) for _ in range(2)]
    al = torch.full((1,), 0.25, device=device)
    y1, st1 = f1_plain(u, w1, b1, gam[0], bet[0], True)
    y2, _, st2 = f2_plain(y1, st1, al, w2, b2, gam[1], bet[1], True)
    sums2 = _off_sums(gen, g)
    dz = b2_plain(g, y2, st2, gam[1], sums2, y1, st1, al, w2, True)[0]
    return {
        'f1': (f1_conv_stats, f1_plain, (u, w1, b1, gam[0], bet[0], True)),
        'f2': (f2_norm_act_conv_stats, f2_plain,
               (y1, st1, al, w2, b2, gam[1], bet[1], True)),
        'b2': (b2_call, b2_plain,
               (g, y2, st2, gam[1], sums2, y1, st1, al, w2, True)),
        'b3': (b3_call, b3_plain,
               (dz, y1, st1, gam[0], _off_sums(gen, dz), w1, g, True))}


@pytest.mark.parametrize('bsz,h,w', [(16, 32, 32), (2, 23, 37), (2, 3, 5),
                                     (1, 2, 2)])
@pytest.mark.parametrize('fn', ['f1', 'f2', 'b2', 'b3'])
def test_k4r_kernel_matches_plain(device, fn, bsz, h, w):
    """Each K4r kernel against its plain version (reflect=True) at the
    training shape, a ragged one, H = 3 (rows 1 and H - 2 one row) and the
    smallest image a mirror takes: within the limits, one reflect launch
    counted (none on K4's SAME counter), bit-identical twice; the SAME
    kernel on the same inputs (F: a halo left at zero; B: the fold
    dropped) fails the limits."""
    gen = torch.Generator().manual_seed(bsz * 1000 + h * 100 + w + 23)
    kernel, plain, args = _k4r_calls(gen, device, bsz, h, w)[fn]
    before = kernel.launches, kernel.launches_reflect
    got = _flat(kernel(*args))
    torch.cuda.synchronize()
    assert (kernel.launches, kernel.launches_reflect) == (before[0],
                                                          before[1] + 1)
    ref = _flat(plain(*args))
    lims = bn_block.kernel_limits(fn, args, ref, got)
    for g_t, r_t, lim in zip(got, ref, lims):
        assert g_t.dtype == r_t.dtype and g_t.shape == r_t.shape
        assert bool(((g_t.float() - r_t.float()).abs() <= lim).all())
    assert all(torch.equal(a, b) for a, b in zip(got, _flat(kernel(*args))))
    bad = _flat(kernel(*args[:-1], False))
    assert any(bool(((b_t.float() - r_t.float()).abs() > lim).any())
               for b_t, r_t, lim in zip(bad, ref, lims))


def test_k4r_and_reflect_wgrad_refuse_what_they_do_not_take(device):
    """A mirror needs two pixels each way (torch's ReflectionPad2d(1)
    too); the reflect weight grad takes 64 -> 64-multiple channels."""
    x = torch.zeros(2, 1, 5, 64, device=device, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 64, 64, device=device, dtype=torch.bfloat16)
    v = torch.zeros(64, device=device)
    with pytest.raises(ValueError, match='reflect needs'):
        f1_conv_stats(x, w, v, v, v, True)
    y = torch.zeros(2, 4, 4, 32, device=device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='no kernel'):
        conv_wgrad(y, y, reflect=True)


@pytest.mark.parametrize('bsz,h,w', [(16, 32, 32), (2, 23, 37), (2, 3, 5)])
def test_reflect_wgrad_kernel_matches_plain(device, bsz, h, w):
    """The weight grad of a REFLECT conv (x's halo mirrored): dW and db
    within 1e-4 of their largest magnitude, counted on ``launches``."""
    from srtpu_torch.ops.wgrad import conv_wgrad_plain
    gen = torch.Generator().manual_seed(bsz + h + w)
    x, g = (_u(gen, (bsz, h, w, 64), 1.0, device) for _ in range(2))
    before = conv_wgrad.launches
    got = conv_wgrad(x, g, reflect=True)
    torch.cuda.synchronize()
    assert conv_wgrad.launches == before + 1
    for a, b in zip(got, conv_wgrad_plain(x, g, reflect=True)):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


def _srgan(device, scale, ngf=64, seed=0):
    return create_model('SRGAN', scale_factor=scale, ngf=ngf, ndf=64,
                        n_blocks=2, use_pallas='cs', dtype=torch.bfloat16,
                        device=device,
                        generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize('scale', [2, 3, 4, 8])
@pytest.mark.parametrize('train', [False, True])
def test_srgan_kernel_path_matches_plain(device, scale, train):
    """SRGAN's generator (2 blocks, 64 features) on the card at every
    scale: eval mode runs no kernel of the port (the same image on both
    paths); train mode runs K4r (F1 three times: two blocks and the
    close), the SR image within 2^-5 of the plain path's (batch norm
    rescales a step's difference by the batch deviation)."""
    model = _srgan(device, scale)
    model.train(train)
    lr = torch.rand((2, 20, 28, 3),
                    generator=torch.Generator().manual_seed(3)).to(device)
    before = f1_conv_stats.launches_reflect
    with torch.no_grad():
        got = model(lr).float()
        assert f1_conv_stats.launches_reflect == before + (3 if train else 0)
        ref = model(lr, plain=True).float()
    assert got.shape == (2, 20 * scale, 28 * scale, 3)
    assert bool(torch.isfinite(got).all())
    assert (got - ref).abs().max().item() <= (2.0 ** -5 if train else 0.0)


def test_srgan_gan_step_kernel_path_matches_plain(device):
    """One adversarial step (D then G, VGG19 relu5_4) at x4 on the kernel
    path, the plain path and the plain path in f32 (the generator and
    discriminator unrounded), from the same params and batch: K4r's
    launches per step (F1 and B3: blocks + close); every log of the
    kernel path within 2^-7 relative of the plain path's (vgg_loss, a
    feature MSE of ~1e-16 on random weights, and adv_loss at 2^-4: they
    sum differences the two paths' images move most); each generator
    gradient f32 and, as chip_smoke's BN checks, held to the f32 step:
    within twice the plain path's error plus one bf16 step of its
    largest magnitude (through the batch norms the two bf16 paths part by
    more than a few steps), but the biases whose gradient reflect
    padding makes exactly 0 (rounding noise on every path)."""
    from srtpu_torch.losses import VGGLoss
    from srtpu_torch.train import create_gan_state, make_gan_train_step
    gen = torch.Generator().manual_seed(8)
    lr = torch.rand((2, 16, 24, 3), generator=gen).to(device)
    hr = torch.rand((2, 64, 96, 3), generator=gen).to(device)
    vgg = VGGLoss(device=device)
    grads, logs = [], []
    for plain, dtype in ((False, torch.bfloat16), (True, torch.bfloat16),
                         (True, None)):
        model = _srgan(device, 4).train()
        model.generator.dtype = model.discriminator.dtype = dtype
        state = create_gan_state(model, 1e-4)
        before = [k.launches_reflect for k in (f1_conv_stats, b2_call,
                                               b3_call)]
        logs.append(make_gan_train_step(vgg_loss=vgg, plain=plain)(
            state, lr, hr))
        torch.cuda.synchronize()
        after = [k.launches_reflect for k in (f1_conv_stats, b2_call,
                                              b3_call)]
        assert [a - b for a, b in zip(after, before)] == (
            [0, 0, 0] if plain else [3, 2, 3])
        grads.append(dict(model.generator.named_parameters()))
    for k, ref in logs[1].items():
        tol = 2.0 ** -4 if k in ('vgg_loss', 'adv_loss') else 2.0 ** -7
        assert abs(logs[0][k].item() - ref.item()) <= tol * abs(ref.item()), k
    noise = ('trunk.b1', 'trunk.b2', 'trunk.bn2_bias', 'trunk.close_b')
    for n, p in grads[0].items():
        assert p.grad.dtype == torch.float32
        if n in noise:
            continue
        f32 = grads[2][n].grad
        e_k = (p.grad - f32).abs().max().item()
        e_p = (grads[1][n].grad - f32).abs().max().item()
        assert e_k <= 2 * e_p + 2.0 ** -7 * f32.abs().max().item(), n


def test_srgan_train_mode_takes_64_channels_on_cuda(device):
    """K4's kernels take 64 channels: a narrower SRGAN trains on the card
    only on the plain path; eval mode runs any width."""
    model = _srgan(device, 4, ngf=32)
    lr = torch.rand((1, 8, 8, 3), device=device)
    with torch.no_grad():
        assert model.eval()(lr).shape == (1, 32, 32, 3)
        with pytest.raises(ValueError, match='64 channels'):
            model.train()(lr)
        assert model(lr, plain=True).shape == (1, 32, 32, 3)
