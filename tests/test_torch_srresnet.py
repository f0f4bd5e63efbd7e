"""The port's SRResNet (K4, K2 at 5x5 and the model around them) against
srtpu on the CPU.

Small sizes: n_feats 16, 2 resblocks, batch 2; the kernel-level cases
at LR 8x8 (two images side by side in srtpu's CS packing, 128 lanes),
the model at LR 8x8 and, on srtpu's kernel path, at 32x32 (where
r * w * k = 128, so srtpu's x4 tail stays on 'cs'). srtpu's kernels run
as its own tests run them off the TPU: SRTPU_CS_OFF_TPU=1, Pallas in
interpret mode, and cs_conv.PATH_LOG shows which path each module took.

Tolerances. f32: 1e-4 of each tensor's largest magnitude (the same f32
products summed in another order). bf16: tensors the kernels store in
bf16 within one bf16 step (2^-7) of their largest magnitude, since both
sides round at the same points and only a value next to a rounding
boundary lands a step apart; f32 sums and weight grads within 2^-6 of
their largest magnitude, as they sum products of those bf16 values, a
few of which may sit a step apart. Wider, with the reason beside it:
the BN scale and PReLU slope grads in bf16 (each is a sum over every
pixel of a product with xhat or z, quantities that the other side's
one-step flips move most), and the trained model's outputs.

(a) each plain K4 function (F1, F2, F3, B1, B2, B3) against srtpu's
    Pallas function, and the limits the card holds each K4 kernel to:
    exact sums pass them, planted faults fail them; (b) BNResBlockFn
    and BNCloseFn against bn_resblock_cs and bn_close_cs: output,
    statistics and every grad;
(c) K2 at 5x5, forward and backward, against conv3x3_cs with kk=5;
(d) SRResNet on both parameter trees, train and eval modes, x2 and x4,
    the running statistics after a train-mode forward against srtpu's
    mutated batch_stats; (e) 8 Adam steps against srtpu's train step;
(f) ``python -m srtpu_torch predict --model SRResNet`` PNGs against
    srtpu's Trainer.predict; (g) the converter with batch_stats; (h) the
    Trainer's train and eval modes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from srtpu.models import create_model as jax_create_model
from srtpu.ops import bn_resblock_cs as jbn
from srtpu.ops import cs_conv
from srtpu_torch.convert import load_npz, params_from_jax
from srtpu_torch.models import create_model
from srtpu_torch.ops import bn_block, conv3x3, conv3x3_bwd_plain
from srtpu_torch.ops.layout import w_hwio_from_cs
from srtpu_torch.ops.wgrad import conv_wgrad_plain

torch.set_num_threads(1)

C, L = 16, 2
KW = dict(n_feats=C, n_resblocks=L)
B, H, W, K = 2, 8, 8, 2        # two 8x8 images side by side: S = 128 lanes
M = float(B * H * W)
STEP = 2.0 ** -7


def _np(t):
    return np.array(t.detach().float() if torch.is_tensor(t) else t,
                    dtype=np.float32)


def _close(got, ref, rel, what=''):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * np.abs(ref).max(), err_msg=what)


def _dt(dtype):
    return {'f32': (jnp.float32, torch.float32),
            'bf16': (jnp.bfloat16, torch.bfloat16)}[dtype]


def _cs(x, jdt):
    return cs_conv.nhwc_to_cs(jnp.asarray(x, jdt), K)


def _nhwc(x_cs):
    return np.asarray(cs_conv.cs_to_nhwc(x_cs, K, H, W), np.float32)


def _col(v):
    return jnp.asarray(v, jnp.float32).reshape(-1, 1)


def _tree_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv('SRTPU_CS_OFF_TPU', '1')


# ------------------------------------------- (a) the plain K4 functions

def _case(seed, jdt, tdt):
    """Random inputs of one BN block at (B, H, W, C): activations rounded
    to the compute dtype, weights (HWIO, and CS for srtpu), f32 vectors,
    and the statistics rows a JAX finalize gives (st: mean, var, inv, a,
    c)."""
    rng = np.random.default_rng(seed)

    def act(scale=1.0):
        x = rng.standard_normal((B, H, W, C)).astype(np.float32) * scale
        return np.asarray(torch.from_numpy(x).to(tdt).float())

    def vec(lo, hi):
        return rng.uniform(lo, hi, C).astype(np.float32)

    def weight():
        w = rng.uniform(-1, 1, (3, 3, C, C)).astype(np.float32) / 12
        return np.asarray(torch.from_numpy(w).to(tdt).float())

    def st(y):
        yf = y.astype(np.float32)
        sm, sq = yf.sum((0, 1, 2)), (yf * yf).sum((0, 1, 2))
        gamma, beta = vec(0.5, 1.5), vec(-0.3, 0.3)
        out = jbn._finalize(_col(sm), _col(sq), jnp.float32(M), _col(gamma),
                            _col(beta))
        return np.stack([np.asarray(v)[:, 0] for v in out]), gamma, beta

    return act, vec, weight, st


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _wcs(w, jdt):
    return cs_conv.w_cs(jnp.asarray(w))[None].astype(jdt)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('fn', ['f1', 'f2', 'f3', 'b1', 'b2', 'b3'])
def test_k4_plain_matches_pallas(interpret, fn, dtype):
    jdt, tdt = _dt(dtype)
    act, vec, weight, stats = _case(['f1', 'f2', 'f3', 'b1', 'b2',
                                     'b3'].index(fn) + 10, jdt, tdt)
    rel_act, rel_sum = (1e-4, 1e-4) if dtype == 'f32' else (STEP, 2. ** -6)
    x, w, b = act(), weight(), vec(-0.1, 0.1)
    if fn in ('f1', 'f2'):
        gamma, beta = vec(0.5, 1.5), vec(-0.3, 0.3)
        al = 0.25
        if fn == 'f1':
            yj, smj, sqj = jbn.f1_conv_stats(_cs(x, jdt), _wcs(w, jdt),
                                             _col(b)[None], W, K)
            got_y, st = bn_block.f1_plain(_t(x, tdt), _t(w, tdt), _t(b),
                                          _t(gamma), _t(beta))
        else:
            st1, _, _ = stats(x)
            yj, smj, sqj = jbn.f2_norm_act_conv_stats(
                _cs(x, jdt), _col(st1[3]), _col(st1[4]),
                jnp.full((C, 1), al, jnp.float32), _wcs(w, jdt),
                _col(b)[None], W, K)
            got_y, h1, st = bn_block.f2_plain(
                _t(x, tdt), _t(st1), _t([al]), _t(w, tdt), _t(b), _t(gamma),
                _t(beta))
            z = st1[3] * x + st1[4]
            _close(h1, np.where(z >= 0, z, al * z).astype(np.float32),
                   rel_act, 'h1')
        ref = jbn._finalize(smj, sqj, jnp.float32(M), _col(gamma),
                            _col(beta))
        _close(got_y, _nhwc(yj), rel_act, 'y')
        for i, name in enumerate(('mean', 'var', 'inv', 'a', 'c')):
            _close(st[i], np.asarray(ref[i])[:, 0], rel_sum, name)
        return
    y = act()
    st, gamma, _ = stats(y)
    if fn == 'f3':
        ref = jbn.f3_norm_skip(_cs(y, jdt), _col(st[3]), _col(st[4]),
                               _cs(x, jdt))
        got = bn_block.f3_plain(_t(y, tdt), _t(st), _t(x, tdt))
        _close(got, _nhwc(ref), rel_act, 'out')
        return
    g = act()
    if fn == 'b1':
        sg, sgx = jbn.b1_sums(_cs(g, jdt), _cs(y, jdt), _col(st[0]),
                              _col(st[2]))
        got = bn_block.b1_plain(_t(g, tdt), _t(y, tdt), _t(st))
        _close(got[0], np.asarray(sg)[:, 0], rel_sum, 'S_g')
        _close(got[1], np.asarray(sgx)[:, 0], rel_sum, 'S_gx')
        return
    # the backward's input sums, scaled as a batch's would be
    sums = np.stack([vec(-1, 1), vec(-1, 1)]) * np.sqrt(M)
    coef = np.float32(gamma * st[2])
    t1, t2 = sums[0] / np.float32(M), sums[1] / np.float32(M)
    if fn == 'b2':
        y1 = act()
        st1, _, _ = stats(y1)
        al = 0.25
        dz, dw2t, db2, dal, sdz, sdzx = jbn.b2_call(
            _cs(g, jdt), _cs(y, jdt), _cs(y1, jdt), _col(st[0]),
            _col(st[2]), _col(coef), _col(t1), _col(t2), _col(st1[3]),
            _col(st1[4]), jnp.full((C, 1), al, jnp.float32),
            cs_conv.w_cs_T_from_cs(_wcs(w, jdt), C, C), _col(st1[0]),
            _col(st1[2]), W, K)
        got = bn_block.b2_plain(_t(g, tdt), _t(y, tdt), _t(st), _t(gamma),
                                _t(sums), _t(y1, tdt), _t(st1), _t([al]),
                                _t(w, tdt))
        z = st1[3] * y1 + st1[4]
        h1 = _t(np.where(z >= 0, z, al * z), tdt)
        dw2 = conv_wgrad_plain(h1, got[1])[0]
        _close(got[0], _nhwc(dz), rel_act, 'dz')
        _close(dw2, w_hwio_from_cs(_t(dw2t).reshape(1, 3 * C, 3 * C), C,
                                   C)[0], rel_sum, 'dW2')
        _close(got[2], np.asarray(db2)[:, 0], rel_sum, 'db2')
        _close(got[3], [np.asarray(dal).sum()], rel_sum, 'dalpha')
        _close(got[4][0], np.asarray(sdz)[:, 0], rel_sum, 'S_dz')
        _close(got[4][1], np.asarray(sdzx)[:, 0], rel_sum, 'S_dz*xhat1')
        return
    u = act()
    du, dw1t, db1 = jbn.b3_call(
        _cs(g, jdt), _cs(y, jdt), _col(st[0]), _col(st[2]), _col(coef),
        _col(t1), _col(t2), _cs(u, jdt), _cs(x, jdt),
        cs_conv.w_cs_T_from_cs(_wcs(w, jdt), C, C), W, K, skip=True)
    got = bn_block.b3_plain(_t(g, tdt), _t(y, tdt), _t(st), _t(gamma),
                            _t(sums), _t(w, tdt), _t(x, tdt))
    dw1 = conv_wgrad_plain(_t(u, tdt), got[1])[0]
    _close(got[0], _nhwc(du), rel_act, 'du')
    _close(dw1, w_hwio_from_cs(_t(dw1t).reshape(1, 3 * C, 3 * C), C, C)[0],
           rel_sum, 'dW1')
    _close(got[2], np.asarray(db1)[:, 0], rel_sum, 'db1')


# ---------------- (a2) the limits the card holds each K4 kernel to

def _limit_case():
    """Inputs of the four K4 functions with f32 sums, bf16 at (2, 32, 32,
    C); the backward's sums drawn apart from their cotangents (as the
    card's checks feed them), so db = sum dy is a real value."""
    rng = np.random.default_rng(5)
    shape, m = (2, 32, 32, C), 2 * 32 * 32

    def t(a, dt=torch.bfloat16):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dt)

    def sums(x):
        rms = x.float().pow(2).mean().sqrt().item()
        return t(rng.uniform(-1, 1, (2, C)) * m ** 0.5 * rms, torch.float32)

    u, g = t(rng.uniform(-1, 1, shape)), t(rng.uniform(-1, 1, shape))
    w1, w2 = (t(rng.uniform(-1, 1, (3, 3, C, C)) / (9 * C) ** 0.5)
              for _ in range(2))
    b1, b2 = (t(rng.uniform(-0.1, 0.1, C), torch.float32) for _ in range(2))
    gam = [t(rng.uniform(0.5, 1.5, C), torch.float32) for _ in range(2)]
    bet = [t(rng.uniform(-0.3, 0.3, C), torch.float32) for _ in range(2)]
    al = torch.full((1,), 0.25)
    y1, st1 = bn_block.f1_plain(u, w1, b1, gam[0], bet[0])
    y2, _, st2 = bn_block.f2_plain(y1, st1, al, w2, b2, gam[1], bet[1])
    s2 = sums(g)
    dz = bn_block.b2_plain(g, y2, st2, gam[1], s2, y1, st1, al, w2)[0]
    return {'f1': (u, w1, b1, gam[0], bet[0]), 'b1': (g, y2, st2),
            'b2': (g, y2, st2, gam[1], s2, y1, st1, al, w2),
            'b3': (dz, y1, st1, gam[0], sums(dz), w1, g)}


def _exact(kind, args, ref):
    """The plain outputs with every f32 sum taken in f64: what a kernel
    that sums in another order approaches."""
    got, d = list(ref), (lambda x: x.double())
    if kind == 'f1':
        y, gamma, beta = d(ref[0]), d(args[3]), d(args[4])
        m = y.shape[0] * y.shape[1] * y.shape[2]
        mean = y.sum((0, 1, 2)) / m
        var = ((y * y).sum((0, 1, 2)) / m - mean * mean).clamp_min(0.0)
        inv = 1.0 / torch.sqrt(var + bn_block.EPS)
        got[1] = torch.stack([mean, var, inv, gamma * inv,
                              beta - mean * gamma * inv]).float()
    elif kind == 'b1':
        g, y, st = args
        xh = (d(y) - d(st[0])) * d(st[2])
        got[0] = torch.stack([d(g).sum((0, 1, 2)),
                              (d(g) * xh).sum((0, 1, 2))]).float()
    else:
        got[2] = d(bn_block._dy(*args[:5])).sum((0, 1, 2)).float()
    if kind == 'b2':
        y1, st1, w2 = args[5], args[6], args[8]
        z = d(bn_block._z(y1, st1))
        dh1 = d(bn_block.conv_f32(ref[1], bn_block.w_t(w2)))
        got[3] = torch.where(z < 0, dh1 * z, 0.0).sum().reshape(1).float()
        dz, xh = d(ref[0]), d(bn_block._xhat(y1, st1))
        got[4] = torch.stack([dz.sum((0, 1, 2)),
                              (dz * xh).sum((0, 1, 2))]).float()
    return got


def _fault(kind, fault, args, ref):
    got = list(ref)
    if fault == 'stats of the unrounded y':   # trap: not the stored y
        y = bn_block.conv_f32(*args[:3])
        m = y.shape[0] * y.shape[1] * y.shape[2]
        got[1] = bn_block._finalize(y.sum((0, 1, 2)), (y * y).sum((0, 1, 2)),
                                    m, args[3], args[4])
    elif fault == 'db of the bf16 dy':      # trap: not the f32 dy
        got[2] = ref[1].float().sum((0, 1, 2))
    elif fault == 'db zero':
        got[2] = torch.zeros_like(ref[2])
    elif fault == 'S_g of half the pixels':
        got[0] = ref[0].clone()
        got[0][0] = bn_block.b1_plain(args[0][:1], args[1][:1], args[2])[0]
    return got


@pytest.mark.parametrize('kind,fault', [
    ('f1', None), ('b1', None), ('b2', None), ('b3', None),
    ('f1', 'stats of the unrounded y'), ('b1', 'S_g of half the pixels'),
    ('b2', 'db of the bf16 dy'), ('b2', 'db zero'),
    ('b3', 'db of the bf16 dy'), ('b3', 'db zero')])
def test_k4_kernel_limits_pass_exact_sums_catch_faults(kind, fault):
    """bn_block.kernel_limits, which the card's tests and chip_smoke hold
    each K4 kernel to: the plain outputs with their f32 sums taken in f64
    lie within them (at most a fifth of each limit); each planted fault
    lies outside them somewhere."""
    args = _limit_case()[kind]
    out = getattr(bn_block, kind + '_plain')(*args)
    ref = list(out) if isinstance(out, tuple) else [out]
    got = (_exact(kind, args, ref) if fault is None
           else _fault(kind, fault, args, ref))
    lims = bn_block.kernel_limits(kind, args, ref, got)
    worst = max(((a.float() - r.float()).abs() / lim).max().item()
                for a, r, lim in zip(got, ref, lims))
    if fault is None:
        assert worst <= 0.2
    else:
        assert worst > 4.0


# ------------------------------- (b) BNResBlockFn and BNCloseFn, grads

def _block_params(seed):
    """One block's parameters, srtpu's shapes (CS conv weights (1, 3C,
    3C), vectors (1, C), alpha (1, 1)), gamma and beta off their init."""
    rng = np.random.default_rng(seed)

    def u(lo, hi, *shape):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    cb = (9 * C) ** -0.5
    return dict(w1=u(-cb, cb, 1, 3 * C, 3 * C), b1=u(-cb, cb, 1, C),
                ga1=u(0.5, 1.5, 1, C), be1=u(-0.3, 0.3, 1, C),
                alpha=np.full((1, 1), 0.25, np.float32),
                w2=u(-cb, cb, 1, 3 * C, 3 * C), b2=u(-cb, cb, 1, C),
                ga2=u(0.5, 1.5, 1, C), be2=u(-0.3, 0.3, 1, C))


def _port_param(name, a):
    t = torch.from_numpy(np.array(a, np.float32))
    if name.startswith('w'):
        return w_hwio_from_cs(t.reshape(1, 3 * C, 3 * C), C, C)[0] \
            .contiguous()
    return t.reshape(1) if name == 'alpha' else t[0]


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('close', [False, True])
def test_bn_fns_match_pallas(interpret, close, dtype):
    jdt, tdt = _dt(dtype)
    rng = np.random.default_rng(30 + close)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    skip = rng.standard_normal((B, H, W, C)).astype(np.float32)
    g = rng.standard_normal((B, H, W, C)).astype(np.float32)
    prm = _block_params(31)
    if close:
        names = ['w1', 'b1', 'ga1', 'be1']

        def fn(u, xs, *ps):
            return jbn.bn_close_cs(u, xs, *ps, W, K)
        args = (_cs(x, jdt), _cs(skip, jdt))
    else:
        names = list(prm)

        def fn(u, *ps):
            return jbn.bn_resblock_cs(u, *ps, W, K)
        args = (_cs(x, jdt),)
    (out_cs, stats), vjp = jax.vjp(fn, *args,
                                   *(jnp.asarray(prm[n]) for n in names))
    ref_grads = vjp((_cs(g, jdt), jax.tree_util.tree_map(jnp.zeros_like,
                                                         stats)))

    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    st_ = torch.from_numpy(skip).to(tdt).requires_grad_()
    pt = [_port_param(n, prm[n]).requires_grad_() for n in names]
    if close:
        out, got_stats = bn_block.bn_close(xt, st_, *pt)
    else:
        out, got_stats = bn_block.bn_resblock(xt, *pt)
    assert out.dtype == tdt
    out.backward(torch.from_numpy(g).to(tdt))

    f32 = dtype == 'f32'
    act, grad = (1e-4, 1e-4) if f32 else (STEP, 2.0 ** -6)
    _close(out, _nhwc(out_cs), act, 'out')
    for i, (s_got, s_ref) in enumerate(zip(got_stats, stats)):
        _close(s_got, s_ref, 1e-4 if f32 else 2.0 ** -6, f'stat {i}')
    _close(xt.grad, _nhwc(ref_grads[0]), act, 'du')
    if close:
        _close(st_.grad, _nhwc(ref_grads[1]), act, 'dx_skip')
    refs = {n: _port_param(n, r) for n, r in zip(names, ref_grads[len(args):])}
    for n, p in zip(names, pt):
        assert p.grad.dtype == torch.float32
        if n in ('b1', 'b2'):
            # a conv bias ahead of a batch norm gets no gradient: the sum
            # of the BN's input gradient over the batch is 0 but for
            # rounding, so both sides hold rounding noise. Held to the
            # scale of the BN shift's grad, the same sum of g.
            beta = refs['be' + n[1]].abs().max().item()
            np.testing.assert_allclose(_np(p.grad), _np(refs[n]), rtol=0,
                                       atol=grad * beta, err_msg=n)
            continue
        # bf16: the BN scale and the PReLU slope grads sum xhat * g or
        # z * dh1 over every pixel, and a one-step flip in a stored dz
        # or y on one side moves such a sum most relative to its size
        # (it is a difference of large terms): 2^-4
        tol = grad if f32 or n not in ('ga1', 'ga2', 'alpha') else 2.0 ** -4
        _close(p.grad, refs[n], tol, n)


# ---------------------------------------------------- (c) K2 at 5x5

@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_conv5x5_plain_matches_pallas(interpret, dtype):
    """The phase-dense shape narrowed: 4C -> 16 at 5x5 (srtpu's
    conv3x3_cs_fwd / _bwd with kk=5), forward and backward."""
    jdt, tdt = _dt(dtype)
    rng = np.random.default_rng(40)
    cin, cout = 4 * C, 16
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    w = (rng.standard_normal((5, 5, cin, cout)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    g = rng.standard_normal((B, H, W, cout)).astype(np.float32)

    def fn(xc, wc, bc):
        return cs_conv.conv3x3_cs(xc, wc, bc, W, K)
    out, vjp = jax.vjp(fn, _cs(x, jdt), jnp.asarray(w), jnp.asarray(b))
    dx, dw, db = vjp(_cs(g, jdt))
    xt = torch.from_numpy(x).to(tdt)
    got = conv3x3(xt, torch.from_numpy(w), torch.from_numpy(b))
    act = 1e-4 if dtype == 'f32' else STEP
    _close(got, _nhwc(out), act, 'y')
    gdx, gdw, gdb = conv3x3_bwd_plain(xt, torch.from_numpy(w).to(tdt),
                                      torch.from_numpy(g).to(tdt))
    assert gdw.shape == (5, 5, cin, cout) and gdw.dtype == torch.float32
    _close(gdx, _nhwc(dx), act, 'dx')
    _close(gdw, dw, 1e-4, 'dW')     # sums of the same bf16 products in f32
    _close(gdb, db, 1e-4, 'db')


# --------------------------------------------------------- (d) model

def _jax_model(scale, use_pallas='cs', dtype=None):
    return jax_create_model('SRResNet', scale_factor=scale,
                            use_pallas=use_pallas, dtype=dtype, **KW)


def _perturbed(variables, seed):
    """The tree with its BN scales, shifts and running statistics moved
    off their init values (so eval mode has something to read)."""
    rng = np.random.default_rng(seed)
    v = _tree_np(variables)

    def walk(node, path):
        for k, a in node.items():
            if isinstance(a, dict):
                walk(a, path + (k,))
            elif 'scale' in k or k.startswith('var'):
                node[k] = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            elif 'bias' in k and ('BatchNorm' in ''.join(path) or 'bn' in k) \
                    or k.startswith('mean'):
                node[k] = rng.uniform(-0.2, 0.2, a.shape).astype(np.float32)
    walk(v, ())
    return v


def _port(scale, tree, dtype=None):
    model = create_model('SRResNet', scale_factor=scale, dtype=dtype,
                         generator=torch.Generator().manual_seed(0), **KW)
    model.load_state_dict(params_from_jax(_tree_np(tree)))
    return model


def _stats_close(model, params, batch_stats, rel):
    """The model's running statistics against srtpu's batch_stats."""
    got = model.state_dict()
    want = params_from_jax({'params': params,
                            'batch_stats': _tree_np(batch_stats)})
    for k in ('mean1', 'var1', 'mean2', 'var2', 'mean_close', 'var_close'):
        _close(got[f'trunk.{k}'], want[f'trunk.{k}'], rel, k)


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('use_pallas', ['cs', False])
@pytest.mark.parametrize('scale', [2, 4])
def test_srresnet_matches_jax_xla_path(scale, use_pallas, train):
    """f32, srtpu's XLA path (its kernels off): eval mode with running
    statistics; train mode with batch statistics, and then the running
    statistics against srtpu's mutated batch_stats."""
    x = np.random.default_rng(scale).random((2, 6, 7, 3), np.float32)
    m = _jax_model(scale, use_pallas)
    v = _perturbed(m.init(jax.random.PRNGKey(scale), jnp.asarray(x)), scale)
    model = _port(scale, v)
    model.train(train)
    if train:
        ref, mut = m.apply(v, jnp.asarray(x), train=True,
                           mutable=['batch_stats'])
        got = model(torch.from_numpy(x))
        _stats_close(model, v['params'], mut['batch_stats'], 1e-4)
    else:
        ref = m.apply(v, jnp.asarray(x))
        with torch.inference_mode():
            got = model(torch.from_numpy(x))
    assert got.shape == ref.shape == (2, 6 * scale, 7 * scale, 3)
    _close(got, ref, 1e-4)


@pytest.mark.parametrize('train', [False, True])
def test_bn_trunk_output_is_nhwc_contiguous(train):
    """The trunk hands the tail's kernels NHWC-contiguous activations in
    both modes, whatever layout a conv or the input had (batch 1, and a
    channels-last view as input)."""
    model = create_model('SRResNet', scale_factor=4,
                         generator=torch.Generator().manual_seed(0), **KW)
    model.train(train)
    x = torch.rand(1, C, 5, 6).permute(0, 2, 3, 1)     # a strided view
    with torch.no_grad():
        out = model.trunk(x, torch.bfloat16)
    assert out.shape == (1, 5, 6, C) and out.is_contiguous()


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_srresnet_train_matches_jax_pallas_interpret(interpret, dtype):
    """x4 in train mode at (2, 32, 32): srtpu's trunk and tail take their
    kernels (CSBNTrunk and CSUpscaleTail 'cs' in cs_conv.PATH_LOG), run
    in interpret mode; the running statistics after the step too."""
    jdt, tdt = {'f32': (None, None),
                'bf16': (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = np.random.default_rng(5).random((2, 32, 32, 3), np.float32)
    m = _jax_model(4, dtype=jdt)
    v = _perturbed(m.init(jax.random.PRNGKey(5), jnp.asarray(x)), 5)
    cs_conv.PATH_LOG.clear()
    ref, mut = m.apply(v, jnp.asarray(x), train=True, mutable=['batch_stats'])
    assert cs_conv.PATH_LOG == {('CSBNTrunk', (2, 32, 32, C)): 'cs',
                                ('CSUpscaleTail', (2, 32, 32, C)): 'cs'}
    model = _port(4, v, tdt)
    got = model(torch.from_numpy(x))
    # bf16: batch norm divides by each channel's batch deviation, so a
    # one-step difference before a BN can come out larger after it; over
    # two blocks, the close and the tail, 2^-5 of the largest output
    # (which is below 2) and 2^-6 on the running statistics
    out_tol, st_tol = (1e-4, 1e-4) if dtype == 'f32' else (2.0 ** -5,
                                                           2.0 ** -6)
    _close(got, np.asarray(ref.astype(jnp.float32)), out_tol)
    _stats_close(model, v['params'], mut['batch_stats'], st_tol)


# ---------------------------------------------------- (e) train step

OPT = ['lr=1e-3', 'eps=1e-4']


def test_train_step_matches_srtpu():
    """8 steps of L1 + Adam (lr 1e-3, eps 1e-4 as tests/test_torch_train.py
    explains), f32, srtpu's XLA path: the loss at every step within 1e-5
    relative, then the params within 1e-4 of each tensor's largest
    magnitude and the running statistics within 1e-4."""
    from srtpu.losses import parse_losses as jax_parse_losses
    from srtpu.optim import build_optimizer as jax_build_optimizer
    from srtpu.train import create_train_state
    from srtpu.train import make_train_step as jax_make_train_step
    from srtpu_torch.losses import parse_losses
    from srtpu_torch.optim import build_optimizer
    from srtpu_torch.train import TrainState, make_train_step

    rng = np.random.default_rng(2)
    batches = []
    for _ in range(8):
        hr = rng.random((2, 32, 32, 3), np.float32)
        batches.append((hr.reshape(2, 8, 4, 8, 4, 3).mean((2, 4))
                        .astype(np.float32), hr))
    jstate = create_train_state(_jax_model(4),
                                jax_build_optimizer('ADAM', OPT),
                                jax.random.PRNGKey(5),
                                jnp.asarray(batches[0][0]))
    model = _port(4, {'params': jstate.params,
                      'batch_stats': jstate.batch_stats})
    model.train()
    pstate = TrainState(model, build_optimizer('ADAM', OPT,
                                               model.parameters()))
    jstep = jax_make_train_step(jax_parse_losses('l1'), donate=False)
    pstep = make_train_step(parse_losses('l1'))
    for lr, hr in batches:
        jstate, jlogs = jstep(jstate, jnp.asarray(lr), jnp.asarray(hr))
        plogs = pstep(pstate, torch.from_numpy(lr), torch.from_numpy(hr))
        np.testing.assert_allclose(float(plogs['loss']), float(jlogs['loss']),
                                   rtol=1e-5)
    want = params_from_jax(_tree_np({'params': jstate.params,
                                     'batch_stats': jstate.batch_stats}))
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k, ref in want.items():
        np.testing.assert_allclose(got[k].numpy(), ref.numpy(), rtol=0,
                                   atol=1e-4 * ref.abs().max().item(),
                                   err_msg=k)


# ------------------------------------------------------- (f) predict

def test_predict_cli_matches_srtpu_trainer(tmp_path):
    """Eval mode with running statistics (moved off their init) on an
    image that needs bucket padding: PNGs within one uint8 level."""
    from PIL import Image

    from srtpu.data import SRData as JaxSRData
    from srtpu.optim import build_optimizer as jax_build_optimizer
    from srtpu.train import Trainer as JaxTrainer
    from srtpu.train import TrainerConfig as JaxTrainerConfig
    from srtpu.train import create_train_state
    from srtpu_torch import cli

    demo = tmp_path / 'datasets' / 'Demo'
    demo.mkdir(parents=True)
    rng = np.random.default_rng(7)
    lo = rng.random((7, 11, 3))
    img = np.kron(lo, np.ones((4, 4, 1)))[:24, :40]   # bucket-pads to 32x64
    Image.fromarray((img * 255).astype(np.uint8)).save(demo / 'a.png')

    state = create_train_state(_jax_model(4), jax_build_optimizer('ADAM', []),
                               jax.random.PRNGKey(3), jnp.zeros((1, 8, 8, 3)))
    v = _perturbed({'params': state.params,
                    'batch_stats': state.batch_stats}, 3)
    state = state.replace(params=v['params'], batch_stats=v['batch_stats'])
    JaxTrainer(JaxTrainerConfig(default_root_dir=str(tmp_path / 'jax'))) \
        .predict(state, JaxSRData(datasets_dir=str(tmp_path / 'datasets'),
                                  predict_datasets=['Demo'], scale_factor=4,
                                  eval_datasets=[], train_datasets=[]))
    torch.save(params_from_jax(v), tmp_path / 'w.pt')
    assert cli.main([
        'predict', '--model', 'SRResNet', '--weights', str(tmp_path / 'w.pt'),
        '--n_feats', str(C), '--n_resblocks', str(L), '--datasets_dir',
        str(tmp_path / 'datasets'), '--predict_datasets', 'Demo',
        '--precision', '32', '--device', 'cpu', '--default_root_dir',
        str(tmp_path / 'port')]) == 0
    for name in ('a', 'a_center'):
        port = np.asarray(Image.open(tmp_path / 'port' / 'Demo' /
                                     f'{name}.png'), np.int16)
        ref = np.asarray(Image.open(tmp_path / 'jax' / 'Demo' /
                                    f'{name}.png'), np.int16)
        assert port.shape == ref.shape
        assert np.abs(port - ref).max() <= 1
    assert port.shape == (96, 96, 3)


# ----------------------------------------------------- (g) converter

@pytest.mark.parametrize('use_pallas', ['cs', False])
def test_convert_npz_roundtrip(tmp_path, use_pallas):
    """A flat .npz holding params/... and batch_stats/... keys converts to
    the same state dict as the tree, which loads into the port's SRResNet
    (buffers included), and the CLI writes a loadable .pt; without
    batch_stats the converter refuses."""
    from srtpu_torch.convert import main
    m = _jax_model(4, use_pallas)
    tree = _perturbed(m.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 3))),
                      0)
    flat = {'/'.join(k.key for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert any(k.startswith('batch_stats/') for k in flat)
    np.savez(tmp_path / 'p.npz', **flat)
    sd = params_from_jax(load_npz(tmp_path / 'p.npz'))
    ref = params_from_jax(tree)
    assert sd.keys() == ref.keys()
    for k in sd:
        torch.testing.assert_close(sd[k], ref[k], rtol=0, atol=0)
    assert main([str(tmp_path / 'p.npz'), str(tmp_path / 'p.pt')]) == 0
    model = _port(4, tree)
    model.load_state_dict(torch.load(tmp_path / 'p.pt', weights_only=True))
    assert torch.equal(model.trunk.var_close, ref['trunk.var_close'])
    with pytest.raises(ValueError, match='batch_stats'):
        params_from_jax({'params': tree['params']})


# ----------------------------------------------------- (h) the modes

class _BNNet(nn.Module):
    """A model whose output and state depend on its mode: a conv and a
    batch norm, then a x2 pixel shuffle (NHWC in and out)."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 12, 3, padding=1)
        self.bn = nn.BatchNorm2d(12)

    def forward(self, x, plain=False):
        y = self.bn(self.conv(x.permute(0, 3, 1, 2)))
        return nn.functional.pixel_shuffle(y, 2).permute(0, 2, 3, 1)


def test_trainer_fit_trains_and_predict_evaluates(tmp_path):
    """Trainer.fit runs the model in train mode (the batch norm's running
    statistics move, whatever mode the caller left it in) and restores
    the caller's mode; Trainer.predict runs it in eval mode, so predicting
    leaves the running statistics as they are."""
    from srtpu_torch.data import SRData
    from srtpu_torch.train import Trainer, TrainerConfig

    data = tmp_path / 'datasets'
    hr_dir, lr_dir = data / 'Train' / 'HR', data / 'Train' / 'LR' / 'X2'
    for d in (hr_dir, lr_dir, data / 'Demo'):
        d.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(4):
        hr = rng.random((32, 32, 3)).astype(np.float32)
        np.save(hr_dir / f'{i}.npy', hr)
        lr = hr.reshape(16, 2, 16, 2, 3).mean((1, 3)).astype(np.float32)
        np.save(lr_dir / f'{i}.npy', lr)
        np.save(data / 'Demo' / f'{i}.npy', lr)
    torch.manual_seed(0)
    model = _BNNet().eval()
    before = model.bn.running_mean.clone()
    trainer = Trainer(TrainerConfig(default_root_dir=str(tmp_path / 'run'),
                                    max_epochs=1))
    trainer.fit(model, SRData(datasets_dir=str(data), train_datasets=['Train'],
                              batch_size=2, patch_size=16, scale_factor=2))
    assert not torch.equal(model.bn.running_mean, before)
    assert not model.training           # the caller's mode, restored
    model.train()
    stats = {k: v.clone() for k, v in model.bn.state_dict().items()}
    written = trainer.predict(model, SRData(
        datasets_dir=str(data), predict_datasets=['Demo'], scale_factor=2))
    assert len(written) == 4 and model.training
    for k, v in model.bn.state_dict().items():
        assert torch.equal(v, stats[k]), k


def test_cli_refuses_srresnet_x3_on_cuda():
    """SRResNet's x3 tail, a 576 -> 32 5x5 phase-dense conv, is on K2's
    general path, so x3 is one of the card's scales with x2, x4 and x8
    and is no longer refused; x3 in f32 still is (the kernels take
    bf16), at model build, naming ROADMAP's F4, before any card is
    touched."""
    from srtpu_torch import cli
    from srtpu_torch.models import SRResNet
    from srtpu_torch.ops import conv
    assert SRResNet.CARD_SCALES == (2, 3, 4, 8)
    assert conv._engine_takes(576, 32, 5) and conv._engine_takes(32, 576, 5)
    args = cli.build_parser().parse_args(
        ['fit', '--model', 'SRResNet', '--scale_factor', '3',
         '--precision', '32', '--train_datasets', 'Train', '--device',
         'cuda'])
    with pytest.raises(ValueError, match='F4'):
        cli.build_model(args, torch.device('cuda'))


def test_k4_wrappers_reject_other_devices():
    """K4's wrappers take the plain versions only for CPU tensors; on any
    other device they launch a kernel or raise, never fall back."""
    x = torch.zeros(1, 4, 4, 64, device='meta')
    w = torch.zeros(3, 3, 64, 64, device='meta')
    v = torch.zeros(64, device='meta')
    st = torch.zeros(5, 64, device='meta')
    sums = torch.zeros(2, 64, device='meta')
    al = torch.zeros(1, device='meta')
    calls = [lambda: bn_block.f1_conv_stats(x, w, v, v, v),
             lambda: bn_block.f2_norm_act_conv_stats(x, st, al, w, v, v, v),
             lambda: bn_block.f3_norm_skip(x, st, x),
             lambda: bn_block.b1_sums(x, x, st),
             lambda: bn_block.b2_call(x, x, st, v, sums, x, st, al, w),
             lambda: bn_block.b3_call(x, x, st, v, sums, w, x)]
    for call in calls:
        with pytest.raises(ValueError, match='no kernel'):
            call()
