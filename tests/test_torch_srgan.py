"""The port's SRGAN (K4r, the generator, the discriminator, the losses and
the adversarial step) against srtpu on the CPU.

Small sizes: ngf 16, 2 blocks, ndf 8, batch 2, LR 8x8 -> HR 32x32 (two
LR images side by side in srtpu's CS packing: S = 128 lanes; relu5_4 of
the VGG19 at 2x2). srtpu's kernels run as its own tests run them off the
TPU: SRTPU_CS_OFF_TPU=1, Pallas in interpret mode, and cs_conv.PATH_LOG
shows the path each module took. srtpu's parameter trees come from
``jax.eval_shape`` of its init, filled from numpy (a flax init off the
TPU takes tens of seconds), with BN scales, shifts and running
statistics off their init values.

Tolerances. f32: 1e-4 of each tensor's largest magnitude (the same f32
products summed in another order). bf16: tensors the kernels store in
bf16 within one bf16 step (2^-7) of their largest magnitude; f32 sums
and weight grads within 2^-6 (sums of products of those bf16 values, a
few of which may sit a step apart). Wider ones carry their reason.

(a) K4r: the plain F1, F2, B2 and B3 with ``reflect=True`` against
    srtpu's Pallas functions with reflect=True (fold rows 1 and 6 inside
    the 8x8 image), and the limits the card holds each K4r kernel to:
    exact sums pass them, a zero halo (F1, F2) and a dropped fold (B2,
    B3) fail them; (b) BNResBlockFn and BNCloseFn with reflect against
    bn_resblock_cs and bn_close_cs: output, statistics and every grad;
(c) the generator on both of srtpu's trees, train and eval, x2 and x4,
    the running statistics after a train-mode forward; srtpu's 'cs' tree
    on its Pallas path in f32 and bf16; (d) the discriminator (flax's
    BatchNorm, not torch's): values and running statistics after two
    train-mode calls, and eval mode;
(e) VGGLoss (vgg19, relu2_2 and relu5_4), gan_loss (three modes), tv_loss;
(f) three adversarial steps against srtpu's make_gan_train_step: every
    log, the G and D params, both sets of batch statistics; the
    schedule of steplr_adam;
(g) F8: Trainer.fit trains the bf16 generator an SRGAN built with
    use_pallas='cs' holds, its running statistics moving once per step;
    ``fit`` and ``predict --model SRGAN`` through the CLI; the registry
    and the CLI's flags.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from srtpu.losses import gan_loss as jax_gan_loss
from srtpu.losses import tv_loss as jax_tv_loss
from srtpu.losses.vgg import VGGLoss as JaxVGGLoss
from srtpu.models.srgan import SRGAN as JaxSRGAN
from srtpu.models.srgan import SRGANDiscriminator as JaxD
from srtpu.models.srgan import SRGANGenerator as JaxG
from srtpu.ops import bn_resblock_cs as jbn
from srtpu.ops import cs_conv
from srtpu.train.gan import GANTrainState as JaxGANTrainState
from srtpu.train.gan import make_gan_train_step as jax_make_gan_train_step
from srtpu_torch.convert import params_from_jax
from srtpu_torch.losses import VGGLoss, gan_loss, tv_loss
from srtpu_torch.models import create_model
from srtpu_torch.ops import bn_block
from srtpu_torch.ops.layout import w_hwio_from_cs
from srtpu_torch.ops.wgrad import conv_wgrad_plain

torch.set_num_threads(1)

C, L, NDF = 16, 2, 8
KW = dict(ngf=C, ndf=NDF, n_blocks=L)
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


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _copy(tree):
    """numpy copies of a JAX tree (srtpu's step donates its state)."""
    return jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32, copy=True), tree)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv('SRTPU_CS_OFF_TPU', '1')


def _fill(shapes, seed):
    """Values for a tree of ShapeDtypeStructs of srtpu's SRGAN, by leaf
    name: conv kernels (HWIO, and the CS-stacked trunk weights (L, 3C,
    3C)) at torch's U(+-1/sqrt(fan_in)), conv biases U(+-0.05), BN scales
    U(0.5, 1.5) and shifts U(+-0.2), PReLU slopes U(0.2, 0.3), running
    means U(+-0.2) and variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        parent = path[-2].key if len(path) > 1 else ''

        def u(lo, hi):
            return rng.uniform(lo, hi, s.shape).astype(np.float32)
        if name.startswith('var') or 'scale' in name:
            return u(0.5, 1.5)
        if name.startswith('mean') or name.startswith('bn') or \
                name == 'close_bn_bias' or 'BatchNorm' in parent:
            return u(-0.2, 0.2)
        if name == 'alpha':
            return u(0.2, 0.3)
        if name in ('kernel', 'w1', 'w2', 'close_w'):
            fan = np.prod(s.shape[:-1]) if name == 'kernel' \
                else 3 * s.shape[-1]
            return u(-fan ** -0.5, fan ** -0.5)
        return u(-0.05, 0.05)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_gan(scale, use_pallas, dtype=None):
    m = JaxSRGAN(scale_factor=scale, use_pallas=use_pallas, dtype=dtype,
                 **KW)
    x = jnp.zeros((B, H, W, 3))
    shapes = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0), x,
                                           method=m.init_all))
    return m, _fill(shapes, scale + 10 * (use_pallas == 'cs'))


def _port(scale, tree, use_pallas='cs', dtype=None):
    model = create_model('SRGAN', scale_factor=scale, use_pallas=use_pallas,
                         dtype=dtype,
                         generator=torch.Generator().manual_seed(0), **KW)
    model.load_state_dict(params_from_jax(tree))
    return model


def _stats_close(model, tree, rel, prefix='generator.'):
    """The port's running statistics against srtpu's batch_stats."""
    want = params_from_jax(tree)
    got = model.state_dict()
    keys = [k for k in want if k.startswith(prefix)
            and ('.mean' in k or '.var' in k)]
    assert keys
    for k in keys:
        _close(got[k], want[k], rel, k)


# -------------------------------------------- (a) the plain K4r functions

def _case(seed, tdt):
    rng = np.random.default_rng(seed)

    def act():
        x = rng.standard_normal((B, H, W, C)).astype(np.float32)
        return np.asarray(torch.from_numpy(x).to(tdt).float())

    def vec(lo, hi):
        return rng.uniform(lo, hi, C).astype(np.float32)

    def weight():
        w = rng.uniform(-1, 1, (3, 3, C, C)).astype(np.float32) / 12
        return np.asarray(torch.from_numpy(w).to(tdt).float())

    def st(y):
        gamma, beta = vec(0.5, 1.5), vec(-0.3, 0.3)
        out = jbn._finalize(_col(y.sum((0, 1, 2))), _col((y * y).sum(
            (0, 1, 2))), jnp.float32(M), _col(gamma), _col(beta))
        return np.stack([np.asarray(v)[:, 0] for v in out]), gamma, beta

    return act, vec, weight, st


def _wcs(w, jdt):
    return cs_conv.w_cs(jnp.asarray(w))[None].astype(jdt)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('fn', ['f1', 'f2', 'b2', 'b3'])
def test_k4r_plain_matches_pallas(interpret, fn, dtype):
    """reflect=True on both sides. bf16 B2 / B3: srtpu adds the column
    fold's two bf16 dy values in bf16 before its matrix product (the port
    folds in f32, the exact adjoint), so dz and du get two steps."""
    jdt, tdt = _dt(dtype)
    act, vec, weight, stats = _case(['f1', 'f2', 'b2', 'b3'].index(fn) + 50,
                                    tdt)
    bf = dtype == 'bf16'
    rel_act, rel_sum = (STEP, 2. ** -6) if bf else (1e-4, 1e-4)
    x, w, b = act(), weight(), vec(-0.1, 0.1)
    if fn in ('f1', 'f2'):
        gamma, beta = vec(0.5, 1.5), vec(-0.3, 0.3)
        if fn == 'f1':
            yj, smj, sqj = jbn.f1_conv_stats(_cs(x, jdt), _wcs(w, jdt),
                                             _col(b)[None], W, K,
                                             reflect=True)
            got_y, st = bn_block.f1_plain(_t(x, tdt), _t(w, tdt), _t(b),
                                          _t(gamma), _t(beta), True)
        else:
            st1, _, _ = stats(x)
            yj, smj, sqj = jbn.f2_norm_act_conv_stats(
                _cs(x, jdt), _col(st1[3]), _col(st1[4]),
                jnp.full((C, 1), 0.25, jnp.float32), _wcs(w, jdt),
                _col(b)[None], W, K, reflect=True)
            got_y, _, st = bn_block.f2_plain(
                _t(x, tdt), _t(st1), _t([0.25]), _t(w, tdt), _t(b),
                _t(gamma), _t(beta), True)
        ref = jbn._finalize(smj, sqj, jnp.float32(M), _col(gamma),
                            _col(beta))
        _close(got_y, _nhwc(yj), rel_act, 'y')
        for i, name in enumerate(('mean', 'var', 'inv', 'a', 'c')):
            _close(st[i], np.asarray(ref[i])[:, 0], rel_sum, name)
        return
    y = act()
    st, gamma, _ = stats(y)
    g = act()
    sums = np.stack([vec(-1, 1), vec(-1, 1)]) * np.sqrt(M)
    coef = np.float32(gamma * st[2])
    t1, t2 = sums[0] / np.float32(M), sums[1] / np.float32(M)
    wt = cs_conv.w_cs_T_from_cs(_wcs(w, jdt), C, C)
    rel_out = 2 * STEP if bf else 1e-4
    if fn == 'b2':
        y1 = act()
        st1, _, _ = stats(y1)
        dz, dw2t, db2, dal, sdz, sdzx = jbn.b2_call(
            _cs(g, jdt), _cs(y, jdt), _cs(y1, jdt), _col(st[0]),
            _col(st[2]), _col(coef), _col(t1), _col(t2), _col(st1[3]),
            _col(st1[4]), jnp.full((C, 1), 0.25, jnp.float32), wt,
            _col(st1[0]), _col(st1[2]), W, K, reflect=True)
        got = bn_block.b2_plain(_t(g, tdt), _t(y, tdt), _t(st), _t(gamma),
                                _t(sums), _t(y1, tdt), _t(st1), _t([0.25]),
                                _t(w, tdt), True)
        z = st1[3] * y1 + st1[4]
        h1 = _t(np.where(z >= 0, z, 0.25 * z), tdt)
        dw2 = conv_wgrad_plain(h1, got[1], reflect=True)[0]
        _close(got[0], _nhwc(dz), rel_out, 'dz')
        _close(dw2, w_hwio_from_cs(_t(dw2t).reshape(1, 3 * C, 3 * C), C,
                                   C)[0], rel_sum, 'dW2')
        _close(got[2], np.asarray(db2)[:, 0], rel_sum, 'db2')
        # bf16: dalpha sums dh1 * z over z < 0, dh1 off by srtpu's fold
        _close(got[3], [np.asarray(dal).sum()], 2 ** -5 if bf else 1e-4,
               'dalpha')
        _close(got[4][0], np.asarray(sdz)[:, 0], rel_sum, 'S_dz')
        _close(got[4][1], np.asarray(sdzx)[:, 0], rel_sum, 'S_dz*xhat1')
        return
    u = act()
    du, dw1t, db1 = jbn.b3_call(
        _cs(g, jdt), _cs(y, jdt), _col(st[0]), _col(st[2]), _col(coef),
        _col(t1), _col(t2), _cs(u, jdt), _cs(x, jdt), wt, W, K, skip=True,
        reflect=True)
    got = bn_block.b3_plain(_t(g, tdt), _t(y, tdt), _t(st), _t(gamma),
                            _t(sums), _t(w, tdt), _t(x, tdt), True)
    dw1 = conv_wgrad_plain(_t(u, tdt), got[1], reflect=True)[0]
    _close(got[0], _nhwc(du), rel_out, 'du')
    _close(dw1, w_hwio_from_cs(_t(dw1t).reshape(1, 3 * C, 3 * C), C, C)[0],
           rel_sum, 'dW1')
    _close(got[2], np.asarray(db1)[:, 0], rel_sum, 'db1')


def _limit_case():
    """The four K4r functions' inputs at (2, 16, 16, C), bf16 with f32
    sums, reflect=True last; the backward's sums drawn apart from their
    cotangents, so db = sum dy is a real value."""
    rng = np.random.default_rng(7)
    shape, m = (2, 16, 16, C), 2 * 16 * 16

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
    y1, st1 = bn_block.f1_plain(u, w1, b1, gam[0], bet[0], True)
    y2, _, st2 = bn_block.f2_plain(y1, st1, al, w2, b2, gam[1], bet[1], True)
    s2 = sums(g)
    dz = bn_block.b2_plain(g, y2, st2, gam[1], s2, y1, st1, al, w2, True)[0]
    return {'f1': (u, w1, b1, gam[0], bet[0], True),
            'f2': (y1, st1, al, w2, b2, gam[1], bet[1], True),
            'b2': (g, y2, st2, gam[1], s2, y1, st1, al, w2, True),
            'b3': (dz, y1, st1, gam[0], sums(dz), w1, g, True)}


def _as_list(out):
    return list(out) if isinstance(out, tuple) else [out]


def _exact(kind, args, ref):
    """The plain outputs with every f32 sum taken in f64 (what a kernel
    that sums in another order approaches); B2's dalpha from the f64
    transposed conv with its reflect fold."""
    got, d = list(ref), (lambda x: x.double())
    if kind == 'f1':
        y, gamma, beta = d(ref[0]), d(args[3]), d(args[4])
        m = y.shape[0] * y.shape[1] * y.shape[2]
        mean = y.sum((0, 1, 2)) / m
        var = ((y * y).sum((0, 1, 2)) / m - mean * mean).clamp_min(0.0)
        inv = 1.0 / torch.sqrt(var + bn_block.EPS)
        got[1] = torch.stack([mean, var, inv, gamma * inv,
                              beta - mean * gamma * inv]).float()
        return got
    got[2] = d(bn_block._dy(*args[:5])).sum((0, 1, 2)).float()
    if kind == 'b2':
        y1, st1, w2 = args[5], args[6], args[8]
        z = d(bn_block._z(y1, st1))
        dh1 = bn_block._conv_t(d(ref[1]), d(w2), True).double()
        got[3] = torch.where(z < 0, dh1 * z, 0.0).sum().reshape(1).float()
        dz, xh = d(ref[0]), d(bn_block._xhat(y1, st1))
        got[4] = torch.stack([dz.sum((0, 1, 2)),
                              (dz * xh).sum((0, 1, 2))]).float()
    return got


@pytest.mark.parametrize('kind,fault', [
    ('f1', None), ('b2', None), ('b3', None), ('f1', 'zero halo'),
    ('f2', 'zero halo'), ('b2', 'fold dropped'), ('b3', 'fold dropped')])
def test_k4r_kernel_limits_catch_reflect_faults(kind, fault):
    """bn_block.kernel_limits with reflect (the card's checks): the plain
    outputs with their f32 sums taken in f64 lie within a fifth of each
    limit; the faults chip_smoke plants, the SAME result in place of the
    reflect one (a halo left at zero in F1 / F2, B2 / B3 without the
    fold), lie far outside them."""
    args = _limit_case()[kind]
    plain = getattr(bn_block, kind + '_plain')
    ref = _as_list(plain(*args))
    got = (_exact(kind, args, ref) if fault is None
           else _as_list(plain(*args[:-1], False)))
    lims = bn_block.kernel_limits(kind, args, ref, got)
    worst = max(((a.float() - r.float()).abs() / lim).max().item()
                for a, r, lim in zip(got, ref, lims))
    if fault is None:
        assert worst <= 0.2
    else:
        assert worst > 4.0


# ----------------------------- (b) BNResBlockFn / BNCloseFn with reflect

def _block_params(seed):
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
def test_bn_fns_reflect_match_pallas(interpret, close, dtype):
    """Value, statistics and every grad against jax.vjp of srtpu's
    reflect functions (Pallas, interpret mode). bf16: du two steps
    (srtpu's bf16 column fold, see (a)); the BN scale and PReLU slope
    grads 2^-4 (sums over every pixel of xhat * g or z * dh1, which a
    one-step flip on one side moves most)."""
    jdt, tdt = _dt(dtype)
    rng = np.random.default_rng(60 + close)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    skip = rng.standard_normal((B, H, W, C)).astype(np.float32)
    g = rng.standard_normal((B, H, W, C)).astype(np.float32)
    prm = _block_params(61)
    if close:
        names = ['w1', 'b1', 'ga1', 'be1']

        def fn(u, xs, *ps):
            return jbn.bn_close_cs(u, xs, *ps, W, K, True)
        args = (_cs(x, jdt), _cs(skip, jdt))
    else:
        names = list(prm)

        def fn(u, *ps):
            return jbn.bn_resblock_cs(u, *ps, W, K, True)
        args = (_cs(x, jdt),)
    (out_cs, stats), vjp = jax.vjp(fn, *args,
                                   *(jnp.asarray(prm[n]) for n in names))
    ref_grads = vjp((_cs(g, jdt), jax.tree_util.tree_map(jnp.zeros_like,
                                                         stats)))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    st_ = torch.from_numpy(skip).to(tdt).requires_grad_()
    pt = [_port_param(n, prm[n]).requires_grad_() for n in names]
    if close:
        out, got_stats = bn_block.bn_close(xt, st_, *pt, reflect=True)
    else:
        out, got_stats = bn_block.bn_resblock(xt, *pt, reflect=True)
    assert out.dtype == tdt
    out.backward(torch.from_numpy(g).to(tdt))
    f32 = dtype == 'f32'
    act, grad = (1e-4, 1e-4) if f32 else (STEP, 2.0 ** -6)
    _close(out, _nhwc(out_cs), act, 'out')
    for i, (s_got, s_ref) in enumerate(zip(got_stats, stats)):
        _close(s_got, s_ref, 1e-4 if f32 else 2.0 ** -6, f'stat {i}')
    _close(xt.grad, _nhwc(ref_grads[0]), act if f32 else 2 * STEP, 'du')
    if close:
        _close(st_.grad, _nhwc(ref_grads[1]), act, 'dx_skip')
    refs = {n: _port_param(n, r) for n, r in zip(names, ref_grads[len(args):])}
    for n, p in zip(names, pt):
        assert p.grad.dtype == torch.float32
        if n in ('b1', 'b2'):
            # a conv bias ahead of a batch norm gets no gradient (rounding
            # noise on both sides): held to the scale of the BN shift's
            beta = refs['be' + n[1]].abs().max().item()
            np.testing.assert_allclose(_np(p.grad), _np(refs[n]), rtol=0,
                                       atol=grad * beta, err_msg=n)
            continue
        tol = grad if f32 or n not in ('ga1', 'ga2', 'alpha') else 2.0 ** -4
        _close(p.grad, refs[n], tol, n)


# ------------------------------------------------------ (c) the generator

@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('use_pallas', ['cs', False])
@pytest.mark.parametrize('scale', [2, 4])
def test_generator_matches_srtpu(scale, use_pallas, train):
    """f32 on srtpu's XLA path (its kernels off): eval mode on the running
    statistics; train mode on batch statistics, then the running
    statistics against srtpu's mutated batch_stats."""
    x = np.random.default_rng(scale).random((B, H, W, 3), np.float32)
    m, v = _jax_gan(scale, use_pallas)
    model = _port(scale, v, use_pallas)
    model.train(train)
    if train:
        ref, mut = m.apply(v, jnp.asarray(x), train=True,
                           mutable=['batch_stats'])
        got = model(torch.from_numpy(x))
        _stats_close(model, {'params': v['params'],
                             'batch_stats': _copy(mut['batch_stats'])}, 1e-4)
    else:
        ref = m.apply(v, jnp.asarray(x))
        with torch.inference_mode():
            got = model(torch.from_numpy(x))
    assert got.shape == ref.shape == (B, H * scale, W * scale, 3)
    _close(got, ref, 1e-4)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_generator_train_matches_srtpu_pallas_interpret(interpret, dtype):
    """x4 in train mode: srtpu's trunk takes its reflect kernels
    (CSBNTrunk 'cs' in cs_conv.PATH_LOG, interpret mode). bf16: batch
    norm divides a one-step difference by its channel's deviation, so
    2^-5 of the largest output (below 1) and 2^-6 on the running
    statistics, as SRResNet's."""
    jdt, tdt = {'f32': (None, None),
                'bf16': (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = np.random.default_rng(5).random((B, H, W, 3), np.float32)
    m, v = _jax_gan(4, 'cs', jdt)
    cs_conv.PATH_LOG.clear()
    ref, mut = m.apply(v, jnp.asarray(x), train=True, mutable=['batch_stats'])
    assert cs_conv.PATH_LOG == {('CSBNTrunk', (B, H, W, C)): 'cs'}
    model = _port(4, v, 'cs', tdt)
    model.train()
    got = model(torch.from_numpy(x))
    assert got.dtype == (tdt or torch.float32)
    out_tol, st_tol = (1e-4, 1e-4) if dtype == 'f32' else (2.0 ** -5,
                                                           2.0 ** -6)
    _close(got, np.asarray(ref.astype(jnp.float32)), out_tol)
    _stats_close(model, {'params': v['params'],
                         'batch_stats': _copy(mut['batch_stats'])}, st_tol)


# -------------------------------------------------- (d) the discriminator

@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_discriminator_matches_srtpu(dtype):
    """Two train-mode calls (hr, then sr: srtpu's D step), each output and
    the running statistics after both, then eval mode on them. bf16: the
    outputs are sigmoids below 1, each within one bf16 step (2^-8 of 1);
    the statistics, f32 means of bf16 activations, within 2^-6."""
    jdt, tdt = _dt(dtype)
    m, v = _jax_gan(4, 'cs', jdt if dtype == 'bf16' else None)
    model = _port(4, v, 'cs', tdt if dtype == 'bf16' else None)
    rng = np.random.default_rng(9)
    hr, sr = (rng.random((B, 4 * H, 4 * W, 3), np.float32) for _ in range(2))
    d_vars = {'params': v['params']['discriminator'],
              'batch_stats': v['batch_stats']['discriminator']}
    jd = JaxD(ndf=NDF, dtype=jdt if dtype == 'bf16' else None)
    model.discriminator.train()
    stats = d_vars['batch_stats']
    for img in (hr, sr):
        ref, mut = jd.apply({'params': d_vars['params'],
                             'batch_stats': stats}, jnp.asarray(img),
                            train=True, mutable=['batch_stats'])
        stats = mut['batch_stats']
        got = model.discriminator(torch.from_numpy(img))
        assert got.shape == ref.shape == (B, 1, 1, 1)
        np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32),
                                   rtol=0, atol=1e-5 if dtype == 'f32'
                                   else 2.0 ** -8)
    tree = {'params': v['params'],
            'batch_stats': {'generator': v['batch_stats']['generator'],
                            'discriminator': _copy(stats)}}
    _stats_close(model, tree, 1e-4 if dtype == 'f32' else 2.0 ** -6,
                 'discriminator.')
    model.discriminator.eval()
    with torch.inference_mode():
        got = model.discriminator(torch.from_numpy(hr))
    ref = jd.apply({'params': d_vars['params'], 'batch_stats': stats},
                   jnp.asarray(hr))
    np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32), rtol=0,
                               atol=1e-5 if dtype == 'f32' else 2.0 ** -8)


# ------------------------------------------------------------- (e) losses

@pytest.mark.parametrize('layer', ['relu2_2', 'relu5_4'])
def test_vgg_loss_matches_srtpu(layer):
    """srtpu's random-init VGG19 (the same numpy draw), ImageNet
    normalisation, MSE at one relu, x0.006; and the gradient in sr.
    relu2_2 within 1e-5 relative. relu5_4: 16 random-init layers shrink
    the features to ~1e-7, where srtpu's XLA convs, which round ~100x
    coarser than PyTorch's CPU ones, leave 2^-8 relative."""
    rng = np.random.default_rng(11)
    sr, hr = (rng.random((B, 32, 32, 3), np.float32) for _ in range(2))
    jv = JaxVGGLoss('vgg19', layer)
    ref, gref = jax.value_and_grad(lambda s: jv(s, jnp.asarray(hr)))(
        jnp.asarray(sr))
    st = torch.from_numpy(sr).requires_grad_()
    got = VGGLoss(layer)(st, torch.from_numpy(hr))
    got.backward()
    rel = 1e-5 if layer == 'relu2_2' else 2.0 ** -8
    np.testing.assert_allclose(got.item(), float(ref), rtol=rel)
    _close(st.grad, gref, 1e-4 if layer == 'relu2_2' else 2.0 ** -6, 'dsr')


@pytest.mark.parametrize('real', [True, False])
@pytest.mark.parametrize('mode', ['lsgan', 'vanilla', 'wgangp'])
def test_gan_loss_matches_srtpu(mode, real):
    pred = np.random.default_rng(12).standard_normal((B, 1, 1, 1)) \
        .astype(np.float32) * 3
    np.testing.assert_allclose(
        gan_loss(torch.from_numpy(pred), real, mode).item(),
        float(jax_gan_loss(jnp.asarray(pred), real, mode)), rtol=1e-6)


def test_tv_loss_matches_srtpu_and_unknown_gan_mode_raises():
    x = np.random.default_rng(13).random((B, 12, 10, 3), np.float32)
    np.testing.assert_allclose(tv_loss(torch.from_numpy(x)).item(),
                               float(jax_tv_loss(jnp.asarray(x))), rtol=1e-6)
    with pytest.raises(NotImplementedError, match='hinge'):
        gan_loss(torch.zeros(1), True, 'hinge')


# ------------------------------------------------- (f) adversarial steps

LR, ADAM_EPS = 1e-2, 1.0
# srtpu's reflect trunk cancels these gradients exactly (a per-channel
# constant reaches a BN, or the close's BN, with reflect padding adding
# no boundary term): both sides hold f32 rounding noise
NOISE = ('trunk.b1', 'trunk.b2', 'trunk.bn2_bias', 'trunk.close_b')


def test_gan_steps_match_srtpu():
    """Three steps of srtpu's make_gan_train_step (wgangp, its VGG19
    relu5_4 content term, adv 1e-3, tv 2e-8), the generator built with
    keywords on the 'cs' tree (srtpu's XLA fallback on the CPU), f32,
    against the port's step from the same params and batches.

    Both sides run Adam with a StepLR schedule at lr 1e-2 and eps 1 (for
    these gradients, below 1e-2, an update proportional to its gradient)
    instead of srtpu's eps 1e-8: Adam's per-element normalisation turns
    a gradient's f32 rounding into a parameter difference of the size of
    a whole update where the gradient is near 0, and srtpu's XLA CPU
    convs round ~100x coarser than PyTorch's (its SR image is 6e-6 from
    an f64 run, the port's 4e-8) through a trunk whose batch norms
    amplify it. Then: every log of every step within 1e-5 relative
    (vgg_loss 2^-8, as (e)); each parameter within 2^-4 of the largest
    update srtpu made to its tensor plus 4 f32 steps of its magnitude,
    the NOISE ones within lr x 1e-6 (no update); the running statistics
    of G and D within 1e-4 of their magnitude (updated once per step by
    G, twice by D)."""
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(3):
        hr = rng.random((B, 4 * H, 4 * W, 3), np.float32)
        batches.append((hr.reshape(B, H, 4, W, 4, 3).mean((2, 4))
                        .astype(np.float32), hr))
    gen = JaxG(scale_factor=4, channels=3, ngf=C, n_blocks=L,
               use_pallas='cs', dtype=None)
    disc = JaxD(ndf=NDF)
    m, v = _jax_gan(4, 'cs')

    def tx():
        return optax.adam(optax.exponential_decay(LR, 100_000, 0.1,
                                                  staircase=True),
                          eps=ADAM_EPS)
    p, bs = v['params'], v['batch_stats']
    g_tx, d_tx = tx(), tx()
    jstate = JaxGANTrainState(
        step=jnp.zeros([], jnp.int32),
        g_params=jax.tree_util.tree_map(jnp.asarray, p['generator']),
        d_params=jax.tree_util.tree_map(jnp.asarray, p['discriminator']),
        g_batch_stats=jax.tree_util.tree_map(jnp.asarray, bs['generator']),
        d_batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                             bs['discriminator']),
        g_opt_state=g_tx.init(p['generator']),
        d_opt_state=d_tx.init(p['discriminator']),
        g_apply=gen.apply, d_apply=disc.apply, g_tx=g_tx, d_tx=d_tx)
    jstep = jax_make_gan_train_step(vgg_loss=JaxVGGLoss('vgg19', 'relu5_4'))

    from srtpu_torch.optim import build_optimizer
    from srtpu_torch.train import GANTrainState, make_gan_train_step
    model = _port(4, v)
    model.train()

    def opt(params):
        o = build_optimizer('ADAM', {'lr': LR, 'eps': ADAM_EPS}, params)
        return o, torch.optim.lr_scheduler.StepLR(o, 100_000, 0.1)
    (go, gs), (do, ds) = (opt(model.generator.parameters()),
                          opt(model.discriminator.parameters()))
    pstate = GANTrainState(model.generator, model.discriminator, go, do, gs,
                           ds)
    pstep = make_gan_train_step(vgg_loss=VGGLoss())
    init = params_from_jax(v)
    for lr, hr in batches:
        jstate, jlogs = jstep(jstate, jnp.asarray(lr), jnp.asarray(hr))
        plogs = pstep(pstate, torch.from_numpy(lr), torch.from_numpy(hr))
        assert plogs.keys() == jlogs.keys()
        for k, ref in jlogs.items():
            assert plogs[k].dim() == 0
            np.testing.assert_allclose(
                plogs[k].item(), float(ref),
                rtol=2.0 ** -8 if k == 'vgg_loss' else 1e-5, err_msg=k)
    assert pstate.step == 3 and go.param_groups[0]['lr'] == LR
    want = params_from_jax({
        'params': {'generator': _copy(jstate.g_params),
                   'discriminator': _copy(jstate.d_params)},
        'batch_stats': {'generator': _copy(jstate.g_batch_stats),
                        'discriminator': _copy(jstate.d_batch_stats)}})
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k, ref in want.items():
        err = (got[k] - ref).abs().max().item()
        if '.mean' in k or '.var' in k:
            assert err <= 1e-4 * ref.abs().max().item(), k
        elif k.endswith(NOISE):
            assert (got[k] - init[k]).abs().max().item() <= LR * 1e-6, k
            assert (ref - init[k]).abs().max().item() <= LR * 1e-6, k
        else:
            upd = (ref - init[k]).abs().max().item()
            assert upd > 0, k
            lim = 2.0 ** -4 * upd + 4 * 2.0 ** -23 * ref.abs().max().item()
            assert err <= lim, (k, err, lim)


def test_steplr_adam_schedule_matches_optax():
    """steplr_adam's lr: x0.1 every step_size updates, as optax's
    exponential_decay(staircase=True) that srtpu's steplr_adam takes."""
    from srtpu_torch.train import steplr_adam
    p = torch.nn.Parameter(torch.zeros(1))
    opt, sched = steplr_adam([p], lr=1e-3, step_size=2)
    sch = optax.exponential_decay(1e-3, 2, 0.1, staircase=True)
    for count in range(6):
        assert opt.param_groups[0]['lr'] == pytest.approx(float(sch(count)))
        p.grad = torch.ones(1)
        opt.step()
        sched.step()


# -------------------------------------------- (g) F8, the CLI, the registry

def _dataset(tmp_path, n=4, hr_size=32, scale=4):
    data = tmp_path / 'datasets'
    hr_dir, lr_dir = data / 'Train' / 'HR', data / 'Train' / 'LR' / f'X{scale}'
    hr_dir.mkdir(parents=True)
    lr_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    s = hr_size // scale
    for i in range(n):
        hr = rng.random((hr_size, hr_size, 3)).astype(np.float32)
        np.save(hr_dir / f'{i}.npy', hr)
        np.save(lr_dir / f'{i}.npy', hr.reshape(s, scale, s, scale, 3)
                .mean((1, 3)).astype(np.float32))
    return data


def test_fit_trains_the_bf16_generator_it_holds(tmp_path):
    """F8: srtpu's Trainer._fit_gan rebuilds its generator positionally,
    putting the dtype into use_pallas, so it trains an f32 XLA generator
    whatever the model says. The port's Trainer.fit trains the
    generator the SRGAN holds: built with use_pallas='cs' and bf16, it
    produces bf16 images in every step, its params move, its trunk runs
    once per step (so its running statistics move once per step), and the
    caller's mode is restored."""
    from srtpu_torch.data import SRData
    from srtpu_torch.models import SRGAN
    from srtpu_torch.train import GANTrainState, Trainer, TrainerConfig
    data = _dataset(tmp_path)
    model = create_model('SRGAN', scale_factor=4, use_pallas='cs',
                         dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(0), **KW)
    assert isinstance(model, SRGAN) and model.use_pallas == 'cs'
    model.eval()
    before = {k: t.clone() for k, t in model.state_dict().items()}
    seen = []
    model.generator.register_forward_hook(
        lambda mod, args, out: seen.append(out.dtype))
    trunk_calls = []
    model.generator.trunk.register_forward_hook(
        lambda mod, args, out: trunk_calls.append(mod.training))
    trainer = Trainer(TrainerConfig(default_root_dir=str(tmp_path / 'run'),
                                    max_epochs=2))
    state = trainer.fit(model, SRData(
        datasets_dir=str(data), train_datasets=['Train'], batch_size=2,
        patch_size=32, scale_factor=4), optimizer_params=['lr=1e-3'])
    assert isinstance(state, GANTrainState) and state.step == 4
    assert trainer.global_step == 4
    assert seen == [torch.bfloat16] * 4 and trunk_calls == [True] * 4
    after = model.state_dict()
    for k in ('generator.head.weight', 'generator.trunk.w1',
              'discriminator.convs.0.weight', 'generator.trunk.mean1',
              'discriminator.bns.0.mean'):
        assert not torch.equal(after[k], before[k]), k
    assert not model.training
    assert state.g_opt.param_groups[0]['lr'] == 1e-3


def test_cli_fit_then_predict_srgan(tmp_path):
    """fit --model SRGAN --use_pallas cs --device cpu: the progress line
    with both losses, the final weights (generator and discriminator),
    which predict --weights reads into 4x PNGs."""
    from srtpu_torch import cli
    data = _dataset(tmp_path)
    run = tmp_path / 'run'
    flags = ['--model', 'SRGAN', '--scale_factor', '4', '--ngf', str(C),
             '--ndf', str(NDF), '--n_blocks', str(L), '--use_pallas', 'cs',
             '--device', 'cpu']
    assert cli.main([
        'fit', *flags, '--datasets_dir', str(data), '--train_datasets',
        'Train', '--batch_size', '2', '--patch_size', '32', '--max_epochs',
        '2', '--default_root_dir', str(run)]) == 0
    log = (run / 'run.log').read_text()
    assert 'epoch 2/2  g_loss' in log and 'd_loss' in log
    sd = torch.load(run / 'final_weights.pt', weights_only=True)
    assert any(k.startswith('discriminator.') for k in sd)
    assert cli.main([
        'predict', *flags, '--weights', str(run / 'final_weights.pt'),
        '--datasets_dir', str(data), '--predict_datasets', 'Train',
        '--default_root_dir', str(tmp_path / 'out')]) == 0
    png = (tmp_path / 'out' / 'Train' / '0.png').read_bytes()
    assert png[:8] == b'\x89PNG\r\n\x1a\n'
    assert png[12:24] == b'IHDR' + (32).to_bytes(4, 'big') * 2


def test_registry_cli_flags_and_converter_refusal():
    """SRGAN is registered (SRCNN is the family left); --ngf, --ndf and
    --n_blocks reach it and are not passed when not given (srtpu's 64,
    64, 16); a tree without batch_stats is refused."""
    from srtpu_torch import cli
    from srtpu_torch.models import NOT_PORTED, SRGAN, model_class
    assert model_class('srgan') is SRGAN and NOT_PORTED == ('SRCNN',)
    parse = cli.build_parser().parse_args
    args = parse(['fit', '--model', 'SRGAN', '--train_datasets', 'T',
                  '--ngf', '16', '--ndf', '8', '--n_blocks', '2',
                  '--device', 'cpu'])
    m = cli.build_model(args, torch.device('cpu'))
    assert m.generator.trunk.w1.shape == (2, 3, 3, 16, 16)
    assert m.discriminator.convs[0].weight.shape == (3, 3, 3, 8)
    args = parse(['fit', '--model', 'SRGAN', '--train_datasets', 'T',
                  '--device', 'cpu'])
    m = cli.build_model(args, torch.device('cpu'))
    assert m.generator.trunk.w1.shape == (16, 3, 3, 64, 64)
    assert m.discriminator.convs[-3].weight.shape[-1] == 512
    _, v = _jax_gan(4, False)
    with pytest.raises(ValueError, match='batch_stats'):
        params_from_jax({'params': v['params']})
