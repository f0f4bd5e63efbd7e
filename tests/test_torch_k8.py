"""The port's K8 (srtpu's ``use_pallas=True`` forms: EDSR's fused
resblock K8a, RCAN's channel-attention gate K8b, WDSR-B's fused block
K8c) and the EDSR, RCAN and WDSR routes around them, against srtpu on
the CPU.

Small sizes: batch 2, LR 8x8, C 16, reduction 4, 2 blocks or 2 groups of
2 RCABs. srtpu's Pallas kernels run in interpret mode, as its own tests
run them off the TPU (``interpret=None`` picks it on a host without a
TPU), and srtpu's VMEM gates pass at these sizes, so its models take
their kernels.

(a) each plain K8 function against srtpu's Pallas function on the same
    numpy-seeded inputs: ``resblock_fused`` and ``resblock_fused_h1`` (out
    and h1), ``ca_layer_fused``, ``wdsr_block_fused_fwd``: f32 within 1e-4
    of each output's largest magnitude (the same products summed in
    another order); bf16 within 2^-6 of it (both round once at the same
    points, so a value next to a rounding boundary lands a step apart).
(b) each autograd Function against ``jax.grad`` of ``resblock_fused_v2``,
    ``ca_layer_fused_trainable`` and ``wdsr_block_fused`` (f32 parameters
    cast where srtpu's models cast them) under a weighted sin loss: the
    value and every gradient, f32 at 1e-4, bf16 at 2^-6 of each tensor's
    largest magnitude; in bf16 the EDSR and WDSR weight grads hold bf16
    values, as srtpu's (they come back in the cast weights' dtype), and
    CA's do not have to (f32 weights).
(c) EDSR, RCAN and WDSR-B with srtpu's ``use_pallas=True`` (EDSR and RCAN
    with ``False`` too) against the port's same route, through
    srtpu_torch.convert, at x2 and x4, in f32 (1e-4) and bf16 (2^-6 on
    outputs below 2).
(d) 8 Adam steps (L1, lr 1e-4, eps 1e-4, f32) on each True route against
    srtpu's ``make_train_step``: each loss within 1e-5 relative.
(e) ``.npz`` round trips of the EDSR and RCAN True trees; one state dict
    giving the same image on all three routes: f32 within 1e-4, bf16
    within 2^-6 (each route rounds at its own points).
(f) ``predict --use_pallas true --device cpu`` for EDSR against srtpu's
    ``Trainer.predict``: PNGs within one uint8 level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srtpu.models import create_model as jax_create_model
from srtpu.ops import ca_layer as jca
from srtpu.ops import resblock as jrb
from srtpu.ops import wdsr_block as jwb
from srtpu_torch.convert import load_npz, params_from_jax
from srtpu_torch.models import create_model
from srtpu_torch.ops import ca_layer as k8b
from srtpu_torch.ops import resblock as k8a
from srtpu_torch.ops import wdsr_block as k8c

torch.set_num_threads(1)

B, H, W, C, R = 2, 8, 8, 16, 4
E, LV = 6 * C, int(0.8 * C)
RS = 0.8                    # res_scale of the function tests
DTYPES = {'f32': (jnp.float32, torch.float32),
          'bf16': (jnp.bfloat16, torch.bfloat16)}


def _np(t):
    return np.array(t.detach().float() if torch.is_tensor(t) else t,
                    np.float32)


def _close(got, ref, rel, what=''):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max(),
                               err_msg=what)


def _tol(dtype):
    return 1e-4 if dtype == 'f32' else 2.0 ** -6


def _u(rng, bound, *shape):
    return rng.uniform(-bound, bound, shape).astype(np.float32)


def _params(kind, rng):
    """One K8 function's f32 parameters at srtpu's init bounds."""
    if kind == 'resblock':
        cb = (9 * C) ** -0.5
        return (_u(rng, cb, 3, 3, C, C), _u(rng, cb, C),
                _u(rng, cb, 3, 3, C, C), _u(rng, cb, C))
    if kind == 'ca':
        return (_u(rng, C ** -0.5, C, C // R), _u(rng, C ** -0.5, C // R),
                _u(rng, (C // R) ** -0.5, C // R, C),
                _u(rng, (C // R) ** -0.5, C))
    return (_u(rng, C ** -0.5, C, E), _u(rng, C ** -0.5, E),
            _u(rng, E ** -0.5, E, LV), _u(rng, E ** -0.5, LV),
            _u(rng, (9 * LV) ** -0.5, 3, 3, LV, C),
            _u(rng, (9 * LV) ** -0.5, C))


# which parameters srtpu casts to the compute dtype (the weights of the
# resblock and the WDSR block; CA's stay f32)
CAST = {'resblock': (True, False, True, False),
        'ca': (False,) * 4,
        'wdsr': (True, False, True, False, True, False)}


def _cast(kind, prm, jdt, tdt):
    """srtpu's and the port's operands: the cast parameters in the
    compute dtype, the rest f32."""
    jx = [jnp.asarray(a, jdt if c else jnp.float32)
          for a, c in zip(prm, CAST[kind])]
    tx = [torch.from_numpy(a).to(tdt if c else torch.float32)
          for a, c in zip(prm, CAST[kind])]
    return jx, tx


# ---------------------------------------- (a) the plain K8 functions

@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('kind', ['resblock', 'resblock_h1', 'ca', 'wdsr'])
def test_k8_plain_matches_pallas(kind, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(len(kind))
    x = rng.uniform(-1, 1, (B, H, W, C)).astype(np.float32)
    base = kind.split('_')[0]
    jw, tw = _cast(base, _params(base, rng), jdt, tdt)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    if kind == 'resblock':
        refs = [jrb.resblock_fused(jx, *jw, res_scale=RS)]
        gots = [k8a.resblock_fused_plain(tx, *tw, RS)]
    elif kind == 'resblock_h1':
        refs = list(jrb.resblock_fused_h1(jx, *jw, res_scale=RS))
        gots = list(k8a.resblock_fused_plain(tx, *tw, RS, save_h1=True))
    elif kind == 'ca':
        refs = [jca.ca_layer_fused(jx, *jw)]
        gots = [k8b.ca_layer_plain(tx, *tw)]
    else:
        refs = [jwb.wdsr_block_fused_fwd(jx, *jw, res_scale=RS)]
        gots = [k8c.wdsr_block_fused_plain(tx, *tw, RS)]
    for i, (got, ref) in enumerate(zip(gots, refs)):
        assert got.dtype == tdt and got.shape == (B, H, W, C)
        _close(got, ref, _tol(dtype), f'{kind} output {i}')


# ------------------------------------------- (b) the autograd Functions

def _jax_fn(kind, jdt):
    """srtpu's differentiable op from f32 parameters, cast as its models
    cast them."""
    def f(x, *p):
        p = [a.astype(jdt) if c else a for a, c in zip(p, CAST[kind])]
        if kind == 'resblock':
            return jrb.resblock_fused_v2(x, *p, RS)
        if kind == 'ca':
            return jca.ca_layer_fused_trainable(x, *p)
        return jwb.wdsr_block_fused(x, *p, RS)
    return f


PORT_OPS = {'resblock': lambda x, *p: k8a.resblock_fused(x, *p, RS),
            'ca': lambda x, *p: k8b.ca_gate(x, *p),
            'wdsr': lambda x, *p: k8c.wdsr_block_fused(x, *p, RS)}


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('kind', ['resblock', 'ca', 'wdsr'])
def test_k8_function_matches_jax_grad(kind, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(10 + len(kind))
    x = rng.standard_normal((B, H, W, C)).astype(np.float32) * 0.5
    prm = _params(kind, rng)
    row_w = np.arange(1, C + 1, dtype=np.float32) / C
    fj = _jax_fn(kind, jdt)

    def loss(xx, *p):
        return jnp.sum(jnp.sin(fj(xx, *p).astype(jnp.float32)) * row_w)

    v_ref, g_ref = jax.value_and_grad(loss, argnums=tuple(
        range(len(prm) + 1)))(jnp.asarray(x, jdt), *map(jnp.asarray, prm))

    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    pt = [torch.from_numpy(a).requires_grad_() for a in prm]
    out = PORT_OPS[kind](xt, *pt)
    assert out.dtype == tdt and out.shape == (B, H, W, C)
    v = (torch.sin(out.float()) * torch.from_numpy(row_w)).sum()
    v.backward()
    tol = _tol(dtype)
    np.testing.assert_allclose(v.item(), float(v_ref), rtol=tol)
    assert xt.grad.dtype == tdt
    _close(xt.grad, g_ref[0], tol, 'dx')
    for i, (t, r) in enumerate(zip(pt, g_ref[1:])):
        assert t.grad.dtype == torch.float32 and t.grad.shape == t.shape
        _close(t.grad, r, tol, f'param {i}')
    if dtype == 'bf16':
        for t, cast in zip(pt, CAST[kind]):
            rounded = torch.equal(t.grad, t.grad.bfloat16().float())
            assert rounded if cast else not rounded
    with torch.no_grad():     # no gradient wanted: the forward alone
        torch.testing.assert_close(PORT_OPS[kind](xt, *pt), out, rtol=0,
                                   atol=0)


# ------------------------------------------------------------ (c) models

KW = {'EDSR': dict(n_feats=C, n_resblocks=2),
      'RCAN': dict(n_feats=C, n_resgroups=2, n_resblocks=2, reduction=R),
      'WDSR': dict(n_feats=C, n_resblocks=2, block_type='B')}


def _tree_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _jax_model(name, scale, use_pallas, dtype=None):
    return jax_create_model(name, scale_factor=scale, use_pallas=use_pallas,
                            dtype=dtype, **KW[name])


def _port(name, scale, params, use_pallas, dtype=None):
    model = create_model(name, scale_factor=scale, use_pallas=use_pallas,
                         dtype=dtype,
                         generator=torch.Generator().manual_seed(0),
                         **KW[name])
    model.load_state_dict(params_from_jax(_tree_np(params)))
    return model


def _port_out(model, x):
    with torch.inference_mode():
        return model(torch.from_numpy(x)).float().numpy()


ROUTES = [('EDSR', True), ('EDSR', False), ('RCAN', True), ('RCAN', False),
          ('WDSR', True)]


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('scale', [2, 4])
@pytest.mark.parametrize('name,use_pallas', ROUTES)
def test_model_route_matches_srtpu(name, use_pallas, scale, dtype):
    jdt, tdt = {'f32': (None, None),
                'bf16': (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = np.random.default_rng(scale).random((B, H, W, 3), np.float32)
    m = _jax_model(name, scale, use_pallas, jdt)
    params = m.init(jax.random.PRNGKey(scale), jnp.asarray(x))
    ref = np.asarray(m.apply(params, jnp.asarray(x)).astype(jnp.float32))
    got = _port_out(_port(name, scale, params, use_pallas, tdt), x)
    assert got.shape == ref.shape == (B, H * scale, W * scale, 3)
    assert np.abs(ref).max() < 2
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(dtype))


# -------------------------------------------------------- (d) train step

OPT = ['lr=1e-4', 'eps=1e-4']


@pytest.mark.parametrize('name', ['EDSR', 'RCAN', 'WDSR'])
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
    jstate = create_train_state(_jax_model(name, 4, True),
                                jax_build_optimizer('ADAM', OPT),
                                jax.random.PRNGKey(5),
                                jnp.asarray(batches[0][0]))
    model = _port(name, 4, {'params': jstate.params}, True)
    pstate = TrainState(model, build_optimizer('ADAM', OPT,
                                               model.parameters()))
    jstep = jax_make_train_step(jax_parse_losses('l1'), donate=False)
    pstep = make_train_step(parse_losses('l1'))
    for lr, hr in batches:
        jstate, jlogs = jstep(jstate, jnp.asarray(lr), jnp.asarray(hr))
        plogs = pstep(pstate, torch.from_numpy(lr), torch.from_numpy(hr))
        np.testing.assert_allclose(float(plogs['loss']), float(jlogs['loss']),
                                   rtol=1e-5)


# --------------------------------------------------------- (e) converter

@pytest.mark.parametrize('name', ['EDSR', 'RCAN'])
def test_true_tree_npz_roundtrip_runs_every_route(tmp_path, name):
    """A flat .npz of the True tree as a JAX host writes it converts,
    through convert.main, to the tree's own state dict, which fills every
    parameter of the port's model and gives one image on all three
    routes."""
    from srtpu_torch.convert import main
    m = _jax_model(name, 2, True)
    params = _tree_np(m.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3))))
    flat = {'/'.join(k.key for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(tmp_path / 'p.npz', **flat)
    sd = params_from_jax(load_npz(tmp_path / 'p.npz'))
    ref = params_from_jax(params)
    assert sd.keys() == ref.keys()
    for k in sd:
        torch.testing.assert_close(sd[k], ref[k], rtol=0, atol=0)
    assert main([str(tmp_path / 'p.npz'), str(tmp_path / 'p.pt')]) == 0
    x = np.random.default_rng(1).random((B, H, W, 3), np.float32)
    for dtype, tol in ((None, 1e-4), (torch.bfloat16, 2.0 ** -6)):
        outs = []
        for route in ('cs', True, False):
            model = _port(name, 2, params, route, dtype)
            model.load_state_dict(torch.load(tmp_path / 'p.pt',
                                             weights_only=True))
            assert sum(a.size for a in jax.tree_util.tree_leaves(params)) \
                == sum(p.numel() for p in model.parameters())
            outs.append(_port_out(model, x))
        for out in outs[1:]:
            np.testing.assert_allclose(out, outs[0], rtol=0, atol=tol)


# --------------------------------------------------------------- (f) CLI

def test_predict_cli_true_route_matches_srtpu_trainer(tmp_path):
    from PIL import Image

    from srtpu.data import SRData as JaxSRData
    from srtpu.optim import build_optimizer as jax_build_optimizer
    from srtpu.train import Trainer as JaxTrainer
    from srtpu.train import TrainerConfig as JaxTrainerConfig
    from srtpu.train import create_train_state
    from srtpu_torch import cli

    demo = tmp_path / 'datasets' / 'Demo'
    demo.mkdir(parents=True)
    lo = np.random.default_rng(7).random((7, 11, 3))
    img = np.kron(lo, np.ones((4, 4, 1)))[:24, :40]   # bucket-pads to 32x64
    Image.fromarray((img * 255).astype(np.uint8)).save(demo / 'a.png')
    state = create_train_state(_jax_model('EDSR', 4, True),
                               jax_build_optimizer('ADAM', []),
                               jax.random.PRNGKey(3), jnp.zeros((1, 8, 8, 3)))
    JaxTrainer(JaxTrainerConfig(default_root_dir=str(tmp_path / 'jax'))) \
        .predict(state, JaxSRData(datasets_dir=str(tmp_path / 'datasets'),
                                  predict_datasets=['Demo'], scale_factor=4,
                                  eval_datasets=[], train_datasets=[]))
    torch.save(params_from_jax(_tree_np({'params': state.params})),
               tmp_path / 'w.pt')
    assert cli.main([
        'predict', '--model', 'EDSR', '--weights', str(tmp_path / 'w.pt'),
        '--n_feats', str(C), '--n_resblocks', '2', '--use_pallas', 'true',
        '--datasets_dir', str(tmp_path / 'datasets'), '--predict_datasets',
        'Demo', '--precision', '32', '--device', 'cpu',
        '--default_root_dir', str(tmp_path / 'port')]) == 0
    for name in ('a', 'a_center'):
        port = np.asarray(Image.open(tmp_path / 'port' / 'Demo' /
                                     f'{name}.png'), np.int16)
        ref = np.asarray(Image.open(tmp_path / 'jax' / 'Demo' /
                                    f'{name}.png'), np.int16)
        assert port.shape == ref.shape
        assert np.abs(port - ref).max() <= 1
    assert port.shape == (96, 96, 3)


# ------------------------------------- (g) F12: past srtpu's VMEM gate

def test_f12_edsr_true_past_resblock_fits_within_route_tolerance():
    """F12, EDSR's True route past srtpu's ``resblock_fits``: srtpu takes
    ``resblock_reference`` there (XLA; h1 kept in f32 for the weight
    grads, which come back rounded to bf16), the port K8a at every size
    (its weight grads from the saved bf16 h1). At 64 features, one block,
    batch 1, LR 104x104 (past the gate's 10 MiB), bf16, under test (b)'s
    weighted sin loss: the value and every gradient within test (b)'s
    bf16 tolerance, 2^-6 of each tensor's largest magnitude. ``pytest -s``
    prints each gap."""
    c, hw = 64, 104
    assert not jrb.resblock_fits((1, hw, hw, c), jnp.bfloat16)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((1, hw, hw, c)).astype(np.float32) * 0.5
    cb = (9 * c) ** -0.5
    prm = (_u(rng, cb, 3, 3, c, c), _u(rng, cb, c), _u(rng, cb, 3, 3, c, c),
           _u(rng, cb, c))
    row_w = np.arange(1, c + 1, dtype=np.float32) / c

    def loss(xx, w1, b1, w2, b2):
        y = jrb.resblock_reference(xx, w1.astype(jnp.bfloat16), b1,
                                   w2.astype(jnp.bfloat16), b2, RS)
        return jnp.sum(jnp.sin(y.astype(jnp.float32)) * row_w)

    v_ref, g_ref = jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, prm))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    pt = [torch.from_numpy(a).requires_grad_() for a in prm]
    out = k8a.resblock_fused(xt, *pt, RS)
    v = (torch.sin(out.float()) * torch.from_numpy(row_w)).sum()
    v.backward()
    tol = _tol('bf16')
    gaps = [abs(v.item() - float(v_ref)) / abs(float(v_ref))]
    for got, ref in zip((xt.grad, *(t.grad for t in pt)), g_ref):
        got, ref = _np(got), _np(ref)
        gaps.append(float(np.abs(got - ref).max() / np.abs(ref).max()))
    print('F12 EDSR True past resblock_fits, max |d| / max |ref| of value, '
          'dx, dw1, db1, dw2, db2:', ' '.join(f'{g:.3g}' for g in gaps))
    assert max(gaps) <= tol, gaps
