"""srtpu's XLA routes of SRResNet, RDN and DDBPN in the port, against
srtpu on the CPU: ``use_pallas`` False and True (srtpu runs both as its
XLA math), RDN's per-block path on 'cs' where srtpu's ``cs_ok`` refuses
(config A, G0 = 24), and DDBPN x8's 'cs' route, srtpu's XLA coarse
branch. Every case draws srtpu's tree with ``init``, fills it from a
seeded numpy generator (SRResNet's batch-norm scales, shifts and running
statistics too), and loads it through ``convert.params_from_jax`` for
the port's model of the same route.

Small sizes: LR 8x8, batch 2; SRResNet 16 features and 2 blocks; RDN a
config 'T' of D = 2 blocks of C = 3 layers at G = G0 = 16 (and G0 = 24,
'T24'), registered in both packages' RDN_CONFIGS for the test, and
config A at its own D 20, C 6, G 32, G0 64; DDBPN n0 32, nr 16, depth 3.

(a) The forward, x4, each model on each route: f32 within 1e-5 of the
    output's largest magnitude, bf16 within one bf16 step (2^-7): both
    sides round at the same points (each conv once, then its bias in the
    compute dtype; each batch norm once; PReLU; the skips), and only the
    f32 sums' order differs. SRResNet in eval mode (running statistics)
    and in train mode (batch statistics), its moved running statistics
    within 1e-5 (f32) or 2^-6 (bf16) of their largest magnitude.
(b) Every parameter's gradient of the output's mean against a fixed
    normal cotangent, against ``jax.grad``: 1e-5 (f32) or 2^-6 (bf16) of
    each tensor's largest magnitude.
(c) 8 steps of L1 + Adam (eps 1e-4, f32, each family's lr) on the False
    route against srtpu's ``make_train_step``: the loss within 1e-5
    relative, the parameters (and running statistics) within 1e-4 of
    their largest (SRResNet's 1e-3: see PARAM_TOL).
(d) RDN config A and G0 = 24 on 'cs' and False; DDBPN x8 on 'cs' with
    K2's wrapper raising, so the stock branch is shown to run.
(e) Each False tree through a flat .npz and back; an srtpu False-route
    training state (``state_from_jax``) resumed in the port; RangerVA's
    centralisation against srtpu's ``_centralize``; the card's f32 rule.
(f) ``fit --use_pallas false --device cpu``, then ``predict
    --checkpoint`` rebuilds the route that trained.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srtpu.models.rdn as jax_rdn
from srtpu.models import create_model as jax_create_model
from srtpu_torch import convert
from srtpu_torch.convert import params_from_jax
from srtpu_torch.models import create_model
from srtpu_torch.models import rdn as port_rdn

torch.set_num_threads(1)

B, H, W = 2, 8, 8
STEP = 2.0 ** -7
DTYPES = {'f32': (None, None), 'bf16': (jnp.bfloat16, torch.bfloat16)}
MODELS = {'SRResNet': dict(n_feats=16, n_resblocks=2),
          'RDN': dict(rdn_config='T', growth0=16),
          'DDBPN': dict(n0=32, nr=16, depth=3)}


@pytest.fixture(autouse=True)
def tiny_rdn(monkeypatch):
    """Configs 'T' (2 blocks of 3 layers, G = 16) and 'T24' (G = 24, which
    srtpu's cs_ok refuses) in both packages."""
    for cfgs in (jax_rdn.RDN_CONFIGS, port_rdn.RDN_CONFIGS):
        monkeypatch.setitem(cfgs, 'T', (2, 3, 16))
        monkeypatch.setitem(cfgs, 'T24', (2, 3, 24))


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _filled(variables, seed):
    """srtpu's tree with every leaf drawn anew from numpy: conv weights
    and biases at their init scale, batch-norm scales and variances in
    [0.5, 1.5], shifts and means in [-0.2, 0.2], slopes in [0.1, 0.4]."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = '/'.join(str(getattr(k, 'key', k)) for k in path)
        a = np.asarray(a, np.float32)
        last = name.rsplit('/', 1)[-1]
        if 'BatchNorm' in name and last == 'scale' or last == 'var':
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if 'BatchNorm' in name or last == 'mean':
            return rng.uniform(-0.2, 0.2, a.shape).astype(np.float32)
        if 'alpha' in last:
            return rng.uniform(0.1, 0.4, a.shape).astype(np.float32)
        bound = max(float(np.abs(a).max()), 1e-3)
        return rng.uniform(-bound, bound, a.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, dict(variables))


def _jax(name, scale, use_pallas, jdt=None, **kw):
    return jax_create_model(name, scale_factor=scale, use_pallas=use_pallas,
                            dtype=jdt, **{**MODELS[name], **kw})


def _port(name, scale, use_pallas, tree, tdt=None, **kw):
    model = create_model(name, scale_factor=scale, use_pallas=use_pallas,
                         dtype=tdt, generator=torch.Generator().manual_seed(0),
                         **{**MODELS[name], **kw})
    model.load_state_dict(params_from_jax(_np(tree), use_pallas))
    return model


def _case(name, scale, use_pallas, jdt, tdt, seed, **kw):
    """(srtpu's module, its filled tree, the port's model of it, x)."""
    x = np.random.default_rng(seed).random((B, H, W, 3), np.float32)
    m = _jax(name, scale, use_pallas, jdt, **kw)
    v = _filled(m.init(jax.random.PRNGKey(seed), jnp.asarray(x)), seed)
    return m, v, _port(name, scale, use_pallas, v, tdt, **kw), x


def _close(got, ref, rel, what=''):
    got = got.detach().float().numpy() if torch.is_tensor(got) else \
        np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * np.abs(ref).max(), err_msg=what)


def _tol(dtype):
    return 1e-5 if dtype == 'f32' else STEP


def _forward_matches(name, use_pallas, dtype, scale=4, seed=0, **kw):
    jdt, tdt = DTYPES[dtype]
    m, v, model, x = _case(name, scale, use_pallas, jdt, tdt, seed, **kw)
    ref = m.apply(v, jnp.asarray(x))
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(x))
    assert got.dtype == (tdt or torch.float32)
    assert got.shape == (B, H * scale, W * scale, 3)
    _close(got, np.asarray(jnp.asarray(ref, jnp.float32)), _tol(dtype))
    return model


# ------------------------------------------------------------- (a) forward

@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('use_pallas', [False, True])
@pytest.mark.parametrize('name', sorted(MODELS))
def test_forward_matches_srtpu(name, use_pallas, dtype):
    """Eval mode (SRResNet's running statistics, filled); no kernel of the
    port is on these routes, so none of their plain versions runs."""
    _forward_matches(name, use_pallas, dtype, seed=len(name))


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('use_pallas', [False, True])
def test_srresnet_train_mode_matches_srtpu(use_pallas, dtype):
    """Train mode: batch statistics, and the running ones moved as
    srtpu's mutated batch_stats."""
    jdt, tdt = DTYPES[dtype]
    m, v, model, x = _case('SRResNet', 4, use_pallas, jdt, tdt, seed=3)
    ref, mut = m.apply(v, jnp.asarray(x), train=True,
                       mutable=['batch_stats'])
    got = model.train()(torch.from_numpy(x))
    _close(got, np.asarray(jnp.asarray(ref, jnp.float32)), _tol(dtype))
    want = params_from_jax(_np({'params': v['params'],
                                'batch_stats': mut['batch_stats']}))
    sd = model.state_dict()
    keys = [k for k in want if '.mean' in k or '.var' in k]
    assert len(keys) == 6
    for k in keys:
        _close(sd[k], want[k], 1e-5 if dtype == 'f32' else 2.0 ** -6, k)


# ----------------------------------------------------------- (b) gradients

def _grads(name, use_pallas, dtype, seed, scale=4, train=False, **kw):
    """(the port's grads by name, srtpu's mapped to the port's names) of
    the mean of the output times a fixed normal cotangent, in train mode
    where ``train``. A linear loss: its cotangent does not depend on the
    output, so the two backward passes start from the same one (an L1's
    sign flips where a bf16 output sits a step from the target)."""
    jdt, tdt = DTYPES[dtype]
    m, v, model, x = _case(name, scale, use_pallas, jdt, tdt, seed, **kw)
    cot = np.random.default_rng(seed + 1).standard_normal(
        (B, H * scale, W * scale, 3)).astype(np.float32)
    rest = {k: a for k, a in v.items() if k != 'params'}

    def loss(p):
        out = m.apply({'params': p, **rest}, jnp.asarray(x), train=train,
                      mutable=['batch_stats'] if train else False)
        out = out[0] if train else out
        return jnp.mean(out.astype(jnp.float32) * jnp.asarray(cot))
    g = _np(jax.grad(loss)(v['params']))
    ref = params_from_jax({'params': g, **_np(rest)}, use_pallas)
    model.train(train)
    out = model(torch.from_numpy(x))
    (out.float() * torch.from_numpy(cot)).mean().backward()
    return {n: p.grad for n, p in model.named_parameters()}, ref


@pytest.fixture
def f32_sums(monkeypatch):
    """jax.grad's transposed broadcasts (a bias's or a slope's gradient,
    the sum of a bf16 cotangent over every pixel) summed in f32 and
    rounded once to bf16, as the port sums them and as XLA does on a
    TPU: XLA's CPU backend accumulates a bf16 reduce in bf16, which puts
    such a sum of a few thousand terms several percent off
    (``test_xla_cpu_sums_bf16_in_bf16``). Nothing else moves."""
    import jax._src.lax.lax as jlax
    real = jlax.reduce_sum

    def reduce_sum(x, axes, *args, **kw):
        if getattr(x, 'dtype', None) == jnp.bfloat16:
            return real(x.astype(jnp.float32), axes, *args,
                        **kw).astype(jnp.bfloat16)
        return real(x, axes, *args, **kw)
    monkeypatch.setattr(jlax, 'reduce_sum', reduce_sum)


def test_xla_cpu_sums_bf16_in_bf16():
    """Why :func:`f32_sums`: the gradient of a bf16 bias add on XLA's CPU
    backend is more than 2^-6 of itself off the exact sum of the bf16
    cotangent, which the port's (f32 sum, one rounding) is within one
    bf16 step of."""
    c = np.random.default_rng(0).standard_normal((2, 32, 32, 3)) / 6144
    cb = jnp.asarray(c, jnp.float32).astype(jnp.bfloat16)
    exact = np.asarray(cb.astype(jnp.float32), np.float64).sum((0, 1, 2))

    def f(b):
        y = jnp.zeros(c.shape, jnp.bfloat16) + b.astype(jnp.bfloat16)
        return jnp.sum(y.astype(jnp.float32) * cb.astype(jnp.float32))
    got = np.asarray(jax.grad(f)(jnp.zeros(3, jnp.float32)))
    b = torch.zeros(3, requires_grad=True)
    y = torch.zeros(c.shape, dtype=torch.bfloat16) + b.to(torch.bfloat16)
    (y.float() * torch.from_numpy(np.asarray(cb.astype(jnp.float32)))) \
        .sum().backward()
    assert np.abs(got - exact).max() > 2.0 ** -6 * np.abs(exact).max()
    np.testing.assert_allclose(b.grad.numpy(), exact, rtol=2.0 ** -8)


# SRResNet's conv biases right before a batch norm: their exact gradient
# is 0 (the norm subtracts the batch mean), so each side's is rounding
# noise; held against the kernel of the same conv
PRE_BN = {'trunk.b1': 'trunk.w1', 'trunk.b2': 'trunk.w2',
          'trunk.close_b': 'trunk.close_w'}


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('use_pallas', [False, True])
@pytest.mark.parametrize('name', sorted(MODELS))
def test_grads_match_jax_grad(f32_sums, name, use_pallas, dtype):
    """Each gradient within 1e-5 (f32) or 2^-6 (bf16) of its largest
    magnitude; in train mode a pre-BN bias's (PRE_BN), on both sides,
    within that of its conv kernel's largest. SRResNet in train mode in f32 and in eval
    mode in bf16: in train mode each batch norm's backward subtracts two
    batch means of its bf16 cotangent, so a value a bf16 step apart moves
    the sums behind the earlier layers' slopes and shifts by up to twice
    themselves (the head's slope) on either side; eval mode keeps every
    rounding point of the route's convs, PReLUs and skips."""
    train = name == 'SRResNet' and dtype == 'f32'
    got, ref = _grads(name, use_pallas, dtype, seed=10 + len(name),
                      train=train)
    tol = 1e-5 if dtype == 'f32' else 2.0 ** -6
    assert got.keys() <= ref.keys()
    for n, g in got.items():
        assert g is not None and g.dtype == torch.float32, n
        if train and n in PRE_BN:
            scale = tol * ref[PRE_BN[n]].abs().max()
            assert g.abs().max() <= scale and ref[n].abs().max() <= scale, n
            continue
        _close(g, ref[n], tol, n)


# ---------------------------------------------------------- (c) train step

# the recipe of each family's own train-step test (test_torch_srresnet.py,
# test_torch_rdn.py, test_torch_ddbpn.py): batches from numpy seed 2,
# srtpu's init from key 5, lr 1e-3 for SRResNet and 1e-4 for RDN and
# DDBPN, eps 1e-4 as tests/test_torch_train.py explains. L1's gradient
# jumps where an output crosses its target, so an output that sits on
# its target within f32 rounding parts two runs at that step: at other
# seeds (numpy 4, key 6) SRResNet's 'cs' route and its XLA route alike
# part from srtpu at the seventh step by 2e-4 of bn1_bias's largest.
# SRResNet's parameters are held within 1e-3 of their largest, the other
# families' within 1e-4: its batch-norm shifts start at 0 and their
# gradients are differences of batch means, so a gradient near Adam's
# eps moves its element by a share of lr that f32 rounding decides, and
# the shifts' gap to srtpu grows from 7e-6 to 2e-4 - 1e-3 of their
# largest over 8 steps at other init keys (1, 3) while the loss agrees
# within 1e-5 at every step and the gradients from the same parameters
# within 1e-5 (test_grads_match_jax_grad).
PARAM_TOL = {'SRResNet': 1e-3, 'RDN': 1e-4, 'DDBPN': 1e-4}
OPT = {'SRResNet': ['lr=1e-3', 'eps=1e-4'], 'RDN': ['lr=1e-4', 'eps=1e-4'],
       'DDBPN': ['lr=1e-4', 'eps=1e-4']}


@pytest.mark.parametrize('name', sorted(MODELS))
def test_train_step_matches_srtpu_8_steps(name):
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
        hr = rng.random((B, 32, 32, 3), np.float32)
        batches.append((hr.reshape(B, 8, 4, 8, 4, 3).mean((2, 4))
                        .astype(np.float32), hr))
    jstate = create_train_state(_jax(name, 4, False),
                                jax_build_optimizer('ADAM', OPT[name]),
                                jax.random.PRNGKey(5),
                                jnp.asarray(batches[0][0]))

    def tree(st):
        return {'params': st.params, **({'batch_stats': st.batch_stats}
                                        if st.batch_stats else {})}
    model = _port(name, 4, False, tree(jstate)).train()
    pstate = TrainState(model, build_optimizer('ADAM', OPT[name],
                                               model.parameters()))
    jstep = jax_make_train_step(jax_parse_losses('l1'), donate=False)
    pstep = make_train_step(parse_losses('l1'))
    for lr, hr in batches:
        jstate, jlogs = jstep(jstate, jnp.asarray(lr), jnp.asarray(hr))
        plogs = pstep(pstate, torch.from_numpy(lr), torch.from_numpy(hr))
        np.testing.assert_allclose(float(plogs['loss']), float(jlogs['loss']),
                                   rtol=1e-5)
    want = params_from_jax(_np(tree(jstate)), False)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k, ref in want.items():
        _close(got[k], ref, PARAM_TOL[name], k)


# ------------------------------------------ (d) RDN's configs, DDBPN x8

@pytest.fixture
def k2_raises(monkeypatch):
    """K2's wrappers and the RDN trunk op raise if called."""
    from srtpu_torch.models import ddbpn as port_ddbpn
    from srtpu_torch.models import rdn as rdn_mod

    def boom(*a, **k):
        raise AssertionError('a kernel wrapper ran on a stock route')
    for mod in (port_ddbpn, rdn_mod):
        monkeypatch.setattr(mod, 'conv3x3', boom)
    monkeypatch.setattr(rdn_mod, 'rdn_trunk', boom)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('use_pallas', ['cs', False])
@pytest.mark.parametrize('cfg', [dict(rdn_config='A', growth0=64),
                                 dict(rdn_config='T24', growth0=24)])
def test_rdn_configs_cs_ok_refuses_match_srtpu(k2_raises, cfg, use_pallas,
                                               dtype):
    """Config A (G = 32, G0 = 64: the tail at 32 x 4 channels) and G0 = 24
    take srtpu's per-block path on 'cs' as on False, and the port's;
    neither calls K2's or K6's wrapper (``k2_raises``)."""
    model = _forward_matches('RDN', use_pallas, dtype, seed=5, **cfg)
    assert model.per_block
    if cfg['rdn_config'] == 'A':
        assert model.upscale.convs[0].weight.shape == (3, 3, 64, 128)
        assert model.lff_weight.shape == (20, 64 + 6 * 32, 64)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_ddbpn_x8_cs_runs_the_stock_branch(k2_raises, f32_sums, dtype):
    """x8 on 'cs': srtpu's XLA coarse branch on its 'cs' tree, the port's
    conv_xla on the same coarse weights (c_in 64 nr at the down convs),
    forward and gradients, with K2's wrapper raising."""
    _forward_matches('DDBPN', 'cs', dtype, scale=8, seed=7)
    got, ref = _grads('DDBPN', 'cs', dtype, seed=8, scale=8)
    for n, g in got.items():
        _close(g, ref[n], 1e-5 if dtype == 'f32' else 2.0 ** -6, n)


def test_stock_routes_run_no_kernel_wrapper(k2_raises):
    """RDN's per-block path and DDBPN's False route call no wrapper of
    K2 or K6, forward or backward."""
    for name, up, kw in (('RDN', 'cs', dict(rdn_config='A')),
                         ('RDN', False, {}), ('DDBPN', False, {}),
                         ('DDBPN', True, {})):
        model = create_model(name, scale_factor=4, use_pallas=up,
                             generator=torch.Generator(),
                             **{**MODELS[name], **kw})
        model(torch.rand(1, 8, 8, 3)).mean().backward()


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('scale', [2, 4, 8])
def test_conv_transpose_phase_form_matches_srtpu(scale, dtype):
    """The up projections' ConvTranspose2d, run as one forward conv over
    the LR grid and a pixel shuffle (``common._conv_transpose``), against
    srtpu's input-dilated conv at each of DDBPN's (k, s, p), on a filled
    tree: the output within 1e-5 (f32) or 2^-7 (bf16) of its largest; in
    f32 the gradients of x, the kernel and the bias against a fixed
    normal cotangent within 1e-5 of each one's largest."""
    from srtpu.models.common import ConvTranspose2d
    from srtpu.models.ddbpn import _PROJ_PARAMS
    from srtpu_torch.models.common import _conv_transpose
    k, s, p = _PROJ_PARAMS[scale]
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(scale)
    x = rng.standard_normal((B, 6, 5, 8), np.float32)
    m = ConvTranspose2d(12, k, s, p, dtype=jdt)
    v = _filled(m.init(jax.random.PRNGKey(0), jnp.asarray(x)), scale)
    kern, bias = v['params']['kernel'], v['params']['bias']
    ref = m.apply(v, jnp.asarray(x))
    xt, wt, bt = (torch.from_numpy(np.array(a)).requires_grad_()
                  for a in (x, kern, bias))
    got = _conv_transpose(xt, wt, bt, tdt or torch.float32, s, p)
    assert got.dtype == (tdt or torch.float32)
    _close(got, np.asarray(jnp.asarray(ref, jnp.float32)), _tol(dtype))
    if dtype != 'f32':
        return
    cot = rng.standard_normal(got.shape).astype(np.float32)
    gx, gv = jax.grad(lambda x_, v_: jnp.sum(m.apply(v_, x_) * cot),
                      (0, 1))(jnp.asarray(x), v)
    (got * torch.from_numpy(cot)).sum().backward()
    _close(xt.grad, gx, 1e-5, 'x')
    _close(wt.grad, gv['params']['kernel'], 1e-5, 'kernel')
    _close(bt.grad, gv['params']['bias'], 1e-5, 'bias')


# ---------------------------------------- (e) converter, state, optimizer

def _flat(tree):
    def key(k):
        return str(getattr(k, 'key', getattr(k, 'name', getattr(k, 'idx',
                                                                   k))))
    return {'/'.join(key(k) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize('name,kw', [
    ('SRResNet', {}), ('RDN', {}), ('RDN', dict(rdn_config='A')),
    ('DDBPN', {}), ('DDBPN', dict(scale=8))])
def test_false_tree_npz_roundtrip(tmp_path, name, kw):
    """A False tree as a JAX host writes it (a flat .npz) gives the same
    state dict as the tree, which fills every parameter and buffer of the
    port's False route one to one: srtpu's leaves hold the same count."""
    kw = dict(kw)
    scale = kw.pop('scale', 4)
    m = _jax(name, scale, False, **kw)
    v = _filled(m.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 3))), 0)
    np.savez(tmp_path / 'p.npz', **_flat(v))
    sd = params_from_jax(convert.load_npz(tmp_path / 'p.npz'), False)
    ref = params_from_jax(_np(v), False)
    assert sd.keys() == ref.keys()
    for k in sd:
        assert torch.equal(sd[k], ref[k]), k
    model = create_model(name, scale_factor=scale, use_pallas=False,
                         generator=torch.Generator(), **{**MODELS[name], **kw})
    model.load_state_dict(sd)
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(v['params']))
    assert n_jax == sum(p.numel() for p in model.parameters())
    convert.check_relayout(_np(v['params']), _np(v.get('batch_stats', {})),
                           False)


def test_ddbpn_cs_tree_does_not_load_into_the_fine_route():
    m = _jax('DDBPN', 4, 'cs')
    v = _np(m.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 3))))
    with pytest.raises(ValueError, match='fine kernels'):
        params_from_jax(v, False)
    assert convert.tree_route(v) == 'cs'
    assert convert.tree_route(_np(_jax('DDBPN', 4, False).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 3))))) is False


@pytest.mark.parametrize('name', ['SRResNet', 'DDBPN'])
def test_false_route_state_resumes_in_port(name):
    """srtpu's False-route state after 2 Adam steps (params, batch_stats,
    the optimizer's moments), flattened and converted, resumes in a port
    model of that route drawn from other weights: the third step's loss
    and the parameters after it match srtpu's."""
    from srtpu.checkpoint import _state_to_tree
    from srtpu.losses import parse_losses as jax_parse_losses
    from srtpu.optim import build_optimizer as jax_build_optimizer
    from srtpu.train import create_train_state
    from srtpu.train import make_train_step as jax_make_train_step
    from srtpu_torch.losses import parse_losses
    from srtpu_torch.optim import build_optimizer
    from srtpu_torch.train import TrainState, make_train_step
    from srtpu_torch.train.state import tree_to_state

    rng = np.random.default_rng(12)
    batches = []
    for _ in range(3):
        hr = rng.random((B, 32, 32, 3), np.float32)
        batches.append((jnp.asarray(hr.reshape(B, 8, 4, 8, 4, 3)
                                    .mean((2, 4))), jnp.asarray(hr)))
    jstate = create_train_state(_jax(name, 4, False),
                                jax_build_optimizer('ADAM', OPT[name]),
                                jax.random.PRNGKey(2), batches[0][0])
    jstep = jax_make_train_step(jax_parse_losses('l1'), donate=False)
    for lr, hr in batches[:2]:
        jstate, _ = jstep(jstate, lr, hr)
    tree = convert._like(_flat_nested(_state_to_tree(jstate)), np.asarray)
    out = convert.state_from_jax(tree)
    assert out['step'] == 2
    model = create_model(name, scale_factor=4, use_pallas=False,
                         generator=torch.Generator().manual_seed(9),
                         **MODELS[name]).train()
    state = TrainState(model, build_optimizer('ADAM', OPT[name],
                                              model.parameters()))
    tree_to_state(state, out)
    jstate, jlogs = jstep(jstate, *batches[2])
    plogs = make_train_step(parse_losses('l1'))(
        state, *(torch.from_numpy(np.asarray(t)) for t in batches[2]))
    np.testing.assert_allclose(float(plogs['loss']), float(jlogs['loss']),
                               rtol=1e-5)
    want = params_from_jax(_np({'params': jstate.params,
                                **({'batch_stats': jstate.batch_stats}
                                   if jstate.batch_stats else {})}), False)
    for k, ref in want.items():
        _close(model.state_dict()[k], ref, 1e-5, k)


def _flat_nested(tree):
    out: dict = {}
    for key, v in _flat(tree).items():
        *parents, leaf = key.split('/')
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


@pytest.mark.parametrize('name,kw,route', [
    ('SRResNet', {}, False), ('RDN', {}, False),
    ('RDN', dict(rdn_config='A'), 'cs'), ('RDN', dict(rdn_config='A'), True),
    ('DDBPN', {}, False), ('DDBPN', dict(scale=8), 'cs')])
def test_rangerva_centralizes_as_srtpu(name, kw, route):
    """srtpu's ``_centralize`` on its tree of the route, mapped through
    convert, equals the port's centralisation (``centralize_plan``) of
    the mapped gradients: 4-D kernels over (0, 1, 2) whatever their
    layout (DDBPN's HWOI transposed convs per input channel), RDN's
    per-block 1x1 fusions and GFF1 per output."""
    from srtpu.optim import _centralize
    from srtpu_torch.convert import centralize_plan
    from srtpu_torch.optim import centralize
    kw = dict(kw)
    scale = kw.pop('scale', 4)
    m = _jax(name, scale, route, **kw)
    v = _np(dict(m.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))))
    params, stats = v['params'], v.get('batch_stats', {})
    rng = np.random.default_rng(1)
    g = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    gc = _np(_centralize().update(g, None)[0])
    raw = params_from_jax({'params': g, 'batch_stats': stats}, route)
    want = params_from_jax({'params': gc, 'batch_stats': stats}, route)
    model = create_model(name, scale_factor=scale, use_pallas=route,
                         generator=torch.Generator(), **{**MODELS[name], **kw})
    plan = centralize_plan(model)
    assert set(plan) == {n for n, _ in model.named_parameters()}
    moved = 0
    for n, p in plan.items():
        got = centralize(raw[n], p)
        np.testing.assert_allclose(got.numpy(), want[n].numpy(), rtol=0,
                                   atol=1e-6, err_msg=n)
        moved += not torch.equal(raw[n], want[n])
    assert moved


@pytest.mark.parametrize('model,extra,scale,ok', [
    ('SRResNet', ['--use_pallas', 'false'], 4, True),
    ('SRResNet', ['--use_pallas', 'true'], 4, True),
    ('SRResNet', [], 4, False),
    ('RDN', ['--use_pallas', 'false'], 4, True),
    ('RDN', ['--rdn_config', 'A'], 4, True),
    ('RDN', [], 4, False),
    ('DDBPN', ['--use_pallas', 'false'], 4, True),
    ('DDBPN', [], 8, True),
    ('DDBPN', [], 4, False),
    ('SRGAN', ['--use_pallas', 'true'], 4, True),
    ('SRGAN', ['--use_pallas', 'cs'], 4, False)])
def test_card_takes_f32_where_the_class_runs_no_kernel(model, extra, scale,
                                                       ok):
    """``check_card`` asks the model class (``reaches_kernel``) whether the
    route at the scale runs a kernel; f32 is refused only there, and
    DDBPN runs x8 on the card."""
    from srtpu_torch import cli
    from srtpu_torch.models import DDBPN
    assert DDBPN.CARD_SCALES == (2, 4, 8)
    args = cli.build_parser().parse_args(
        ['fit', '--train_datasets', 'Train', '--model', model,
         '--precision', '32', *extra])
    given = {k: getattr(args, k) for k in cli.MODEL_FLAGS if hasattr(args, k)}
    cli.check_card(model, scale, 'bf16', given)
    if ok:
        cli.check_card(model, scale, '32', given)
    else:
        with pytest.raises(ValueError, match='bf16'):
            cli.check_card(model, scale, '32', given)


# ------------------------------------------------------- (f) fit, predict

def test_fit_false_route_then_predict_checkpoint(tmp_path):
    """``fit --use_pallas false --device cpu`` trains DDBPN's fine route;
    its hparams.json carries the route, and ``predict --checkpoint``
    rebuilds that route: its PNGs are ``predict --weights`` with the
    route's flags, byte for byte."""
    from srtpu_torch import cli
    rng = np.random.default_rng(3)
    data = tmp_path / 'datasets'
    hr_dir, lr_dir = data / 'Train' / 'HR', data / 'Train' / 'LR' / 'X2'
    for d in (hr_dir, lr_dir):
        d.mkdir(parents=True)
    for i in range(4):
        hr = rng.random((32, 32, 3)).astype(np.float32)
        np.save(hr_dir / f'{i}.npy', hr)
        np.save(lr_dir / f'{i}.npy', hr.reshape(16, 2, 16, 2, 3).mean((1, 3)))
    run = tmp_path / 'run'
    flags = ['--n0', '32', '--nr', '16', '--depth', '3', '--use_pallas',
             'false']
    assert cli.main([
        'fit', '--model', 'DDBPN', '--scale_factor', '2', *flags,
        '--datasets_dir', str(data), '--train_datasets', 'Train',
        '--batch_size', '2', '--patch_size', '16', '--max_epochs', '2',
        '--precision', '32', '--device', 'cpu', '--default_root_dir',
        str(run)]) == 0
    hp = json.loads((run / 'checkpoints' / 'hparams.json').read_text())
    assert hp['init_args']['use_pallas'] is False
    pred = ['predict', '--datasets_dir', str(data), '--predict_datasets',
            'Train', '--device', 'cpu']
    assert cli.main([*pred, '--checkpoint', str(run / 'checkpoints'),
                     '--default_root_dir', str(tmp_path / 'ckpt')]) == 0
    weights = ['--model', 'DDBPN', '--scale_factor', '2', '--precision',
               '32', '--weights', str(run / 'final_weights.pt')]
    assert cli.main([*pred, *weights, *flags, '--default_root_dir',
                     str(tmp_path / 'weights')]) == 0
    for i in range(4):
        png = (tmp_path / 'ckpt' / 'Train' / f'{i}.png').read_bytes()
        assert png[12:24] == b'IHDR' + (32).to_bytes(4, 'big') * 2
        assert png == (tmp_path / 'weights' / 'Train' /
                       f'{i}.png').read_bytes()
    # the weights are the fine route's: the 'cs' model does not take them
    model = create_model('DDBPN', scale_factor=2, n0=32, nr=16, depth=3,
                         generator=torch.Generator())
    with pytest.raises(RuntimeError, match='size mismatch'):
        model.load_state_dict(torch.load(run / 'final_weights.pt',
                                         weights_only=True))
