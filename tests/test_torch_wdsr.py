"""The port's WDSR (K7, WNConv2d and the model around them) against srtpu
on the CPU.

Small sizes: K7 at B = 2, 8x8 (two images per CS lane-row: S = 128) and
C = 16 or 64 (e = 96 or 384, one or three of srtpu's dh1 chunks); the
model at n_feats 16 (64 where srtpu's kernel route runs) and 2 blocks.
srtpu's K7 runs as its own tests run it off the TPU: Pallas in interpret
mode (``_fwd_call`` / ``_bwd_call`` take it on a host without a TPU), and
SRTPU_CS_OFF_TPU=1 for the model, whose cs_conv.PATH_LOG then shows
'cs' for CSWDSRTrunk.

(a) the plain K7 forward and backward against ``_fwd_call`` and
    ``_bwd_call`` on the same inputs, every output: f32 within 1e-4 of
    each output's largest magnitude (the same products summed in another
    order); bf16 within two bf16 steps (2^-6) of it: both round at the
    same points, so only a value next to a rounding boundary lands a step
    apart, and the next product that reads it may move by one more; the
    f32 sums of those bf16 values (every weight and bias grad) too.
(b) ``wdsr_block`` (WDSRBlockFn, L padded to Lp inside) against jax.grad
    of ``wdsr_block_cs`` under a sin loss: the value and every gradient,
    f32 at 1e-4, bf16 at 2^-6, of each tensor's largest magnitude.
(c) ``WNConv2d`` against srtpu's at k = 1, 3, 5: values and the v, g and
    bias grads in f32, 1e-5 of the largest magnitude.
(d) the WDSR model against srtpu's at x2, x3, x4 and x8, blocks A and B,
    through srtpu_torch.convert: srtpu's ``use_pallas=False`` and 'cs'
    trees (on the CPU srtpu's 'cs' takes its XLA fallback) against the
    port's two routes, f32 within 1e-4; and at n_feats 64 with
    SRTPU_CS_OFF_TPU=1, srtpu's 'cs' kernel route (interpret mode,
    checked through PATH_LOG) against the port's 'cs' route in f32 (1e-4)
    and bf16 (2^-6 on outputs below 2).
(e) the .npz converter on all three trees (B False, B 'cs', A): the same
    state dict as the tree, every parameter filled, and one state dict
    giving the same image on both of the port's routes (1e-5).
(f) 8 Adam steps (L1, lr 1e-4, eps 1e-4, f32) against srtpu's
    make_train_step on both routes (n_feats 64 and srtpu's kernel route
    for 'cs'): each loss within 1e-5 relative, the final params within
    1e-4 of each tensor's largest magnitude.
(g) ``predict --model WDSR --device cpu`` against srtpu's Trainer.predict:
    PNGs within one uint8 level; ``fit`` then ``predict`` through the CLI
    with ``--use_pallas cs``.
(h) the CLI's model flags: a flag not given is not passed, so WDSR builds
    srtpu's 128 features and the other families build as before;
    ``--use_pallas true`` raises naming ROADMAP.md; ``cs`` at a width K7
    does not take raises off the CPU and runs the plain version on it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srtpu.models import create_model as jax_create_model
from srtpu.models.common import WNConv2d as JaxWNConv2d
from srtpu.ops import cs_conv, wdsr_cs
from srtpu_torch.convert import load_npz, params_from_jax
from srtpu_torch.models import create_model
from srtpu_torch.models.common import WNConv2d
from srtpu_torch.ops import wdsr as k7

torch.set_num_threads(1)

B, H, W, K = 2, 8, 8, 2        # two 8x8 images per CS lane-row: S = 128
RS = 0.8                       # res_scale of the K7 function tests
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


def _to_nhwc(a):
    return _np(cs_conv.cs_to_nhwc(jnp.asarray(a, jnp.float32), K, H, W))


def _block_params(rng, c):
    """One block's f32 weights at srtpu's init bounds, in the port's
    layout: w1 (C, e), b1, w2 (e, L), b2, w3 (3, 3, L, C), b3."""
    e = 6 * c
    lv, _ = k7.wdsr_lp(c)

    def u(bound, *shape):
        return rng.uniform(-bound, bound, shape).astype(np.float32)
    return (u(c ** -0.5, c, e), u(c ** -0.5, e), u(e ** -0.5, e, lv),
            u(e ** -0.5, lv), u((9 * lv) ** -0.5, 3, 3, lv, c),
            u((9 * lv) ** -0.5, c))


def _pad(w2, b2, w3, lp):
    lv = w2.shape[1]
    return (np.pad(w2, ((0, 0), (0, lp - lv))), np.pad(b2, (0, lp - lv)),
            np.pad(w3, ((0, 0), (0, 0), (0, lp - lv), (0, 0))))


# ------------------------------------------------- (a) the plain K7 pair

@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('c', [16, 64])
def test_k7_plain_matches_pallas(c, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(c)
    x = rng.uniform(-1, 1, (B, H, W, c)).astype(np.float32)
    g = rng.uniform(-1, 1, (B, H, W, c)).astype(np.float32)
    w1, b1, w2, b2, w3, b3 = _block_params(rng, c)
    e, (_, lp) = 6 * c, k7.wdsr_lp(c)
    w2p, b2p, w3p = _pad(w2, b2, w3, lp)
    scale = jnp.asarray([[RS]], jnp.float32)
    x_cs = cs_conv.nhwc_to_cs(jnp.asarray(x, jdt), K)
    jw = (jnp.asarray(w1.T, jdt), jnp.asarray(b1)[:, None],
          jnp.asarray(w2p.T, jdt), jnp.asarray(b2p)[:, None])
    w3d = jnp.asarray(w3p, jdt)
    out_r = wdsr_cs._fwd_call(x_cs, *jw, cs_conv.w_cs(w3d),
                              jnp.asarray(b3)[:, None], scale, W, K)
    n_chunks = max(e // 128, 1)
    while e % n_chunks:
        n_chunks -= 1
    ref = wdsr_cs._bwd_call(x_cs, cs_conv.nhwc_to_cs(jnp.asarray(g, jdt), K),
                            *jw, cs_conv.w_cs_T(w3d), scale, W, K, n_chunks)

    tw = [torch.from_numpy(a) for a in (x, w1, b1, w2p, b2p, w3p, b3, g)]
    xt, w1t, w2t, w3t, gt = (tw[i].to(tdt) for i in (0, 1, 3, 5, 7))
    out = k7.wdsr_fwd_plain(xt, w1t, tw[2], w2t, tw[4], w3t, tw[6], RS)
    assert out.dtype == tdt
    tol = _tol(dtype)
    _close(out, _to_nhwc(out_r), tol, 'out')
    got = k7.wdsr_bwd_plain(xt, gt, w1t, tw[2], w2t, tw[4], w3t, RS)
    assert got[0].dtype == tdt
    assert all(t.dtype == torch.float32 for t in got[1:])
    dw3 = _np(ref[5]).reshape(3, c, 3, lp).transpose(0, 2, 3, 1)
    for name, t, r in (('dx', got[0], _to_nhwc(ref[0])),
                       ('dw1', got[1], _np(ref[1]).T),
                       ('db1', got[2], _np(ref[2])[:, 0]),
                       ('dw2', got[3], _np(ref[3]).T),
                       ('db2', got[4], _np(ref[4])[:, 0]),
                       ('dw3', got[5], dw3),
                       ('db3', got[6], _np(ref[6])[:, 0])):
        _close(t, r, tol, name)


# ------------------------------------------------------ (b) the block op

@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('c', [16, 64])
def test_wdsr_block_matches_jax_grad(c, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(c + 1)
    x = rng.standard_normal((B, H, W, c)).astype(np.float32) * 0.5
    prm = _block_params(rng, c)
    lv, lp = k7.wdsr_lp(c)
    row_w = np.arange(1, c + 1, dtype=np.float32) / c

    def f_jax(x_cs, w1, b1, w2, b2, w3, b3):
        w2p = jnp.pad(w2, ((0, lp - lv), (0, 0)))
        w3p = jnp.pad(w3, ((0, 0), (0, 0), (0, lp - lv), (0, 0)))
        out = wdsr_cs.wdsr_block_cs(x_cs, w1.astype(jdt), b1,
                                    w2p.astype(jdt), jnp.pad(b2, (0, lp - lv)),
                                    w3p.astype(jdt), b3, RS, W, K)
        return jnp.sum(jnp.sin(out.astype(jnp.float32))
                       * row_w[None, :, None])

    w1, b1, w2, b2, w3, b3 = prm
    args = (cs_conv.nhwc_to_cs(jnp.asarray(x, jdt), K), jnp.asarray(w1.T),
            jnp.asarray(b1), jnp.asarray(w2.T), jnp.asarray(b2),
            jnp.asarray(w3), jnp.asarray(b3))
    v_ref, g_ref = jax.value_and_grad(f_jax, argnums=tuple(range(7)))(*args)

    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    pt = [torch.from_numpy(a).requires_grad_() for a in prm]
    out = k7.wdsr_block(xt, *pt, res_scale=RS)
    assert out.dtype == tdt and out.shape == (B, H, W, c)
    v = (torch.sin(out.float()) * torch.from_numpy(row_w)).sum()
    v.backward()
    tol = _tol(dtype)
    np.testing.assert_allclose(v.item(), float(v_ref), rtol=tol)
    _close(xt.grad, _to_nhwc(g_ref[0]), tol, 'dx')
    for name, t, r in zip(('w1', 'b1', 'w2', 'b2', 'w3', 'b3'), pt,
                          (_np(g_ref[1]).T, g_ref[2], _np(g_ref[3]).T,
                           g_ref[4], g_ref[5], g_ref[6])):
        assert t.grad.dtype == torch.float32 and t.grad.shape == t.shape
        _close(t.grad, r, tol, name)
    with torch.no_grad():     # no gradient wanted: the forward alone
        torch.testing.assert_close(k7.wdsr_block(xt, *pt, res_scale=RS), out,
                                   rtol=0, atol=0)


# ------------------------------------------------------------ (c) WNConv2d

@pytest.mark.parametrize('k', [1, 3, 5])
def test_wnconv2d_matches_srtpu(k):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 7, 9, 8)).astype(np.float32)
    m = JaxWNConv2d(12, k)
    params = m.init(jax.random.PRNGKey(k), jnp.asarray(x))

    def f(p, xx):
        return jnp.sum(jnp.sin(m.apply(p, xx)))

    y_ref = m.apply(params, jnp.asarray(x))
    g_ref = jax.grad(f)(params, jnp.asarray(x))['params']
    conv = WNConv2d(8, 12, k, generator=torch.Generator().manual_seed(0))
    conv.load_state_dict({n: torch.from_numpy(np.array(a)) for n, a in
                          params['params'].items()})
    y = conv(torch.from_numpy(x), torch.float32)
    _close(y, y_ref, 1e-5, 'y')
    torch.sin(y).sum().backward()
    for n in ('v', 'g', 'bias'):
        _close(getattr(conv, n).grad, g_ref[n], 1e-5, n)


def test_wnconv2d_init_is_the_plain_conv():
    """g starts at ||v||: the weight is v itself."""
    conv = WNConv2d(8, 12, 3, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(conv.weight(), conv.v, rtol=1e-6, atol=0)


# --------------------------------------------------------------- (d) model

KW = dict(n_feats=16, n_resblocks=2)


def _tree_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _jax_model(scale, block='B', use_pallas=False, dtype=None, **kw):
    return jax_create_model('WDSR', scale_factor=scale, block_type=block,
                            use_pallas=use_pallas, dtype=dtype,
                            **{**KW, **kw})


def _port(scale, params, block='B', use_pallas=False, dtype=None, **kw):
    model = create_model('WDSR', scale_factor=scale, block_type=block,
                         use_pallas=use_pallas, dtype=dtype,
                         generator=torch.Generator().manual_seed(0),
                         **{**KW, **kw})
    model.load_state_dict(params_from_jax(_tree_np(params)))
    return model


def _port_out(model, x, plain=False):
    with torch.inference_mode():
        return model(torch.from_numpy(x), plain=plain).float().numpy()


@pytest.mark.parametrize('block,jax_route,port_route',
                         [('B', False, False), ('B', False, 'cs'),
                          ('B', 'cs', 'cs'), ('B', 'cs', False),
                          ('A', False, False)])
@pytest.mark.parametrize('scale', [2, 3, 4, 8])
def test_wdsr_matches_srtpu(scale, block, jax_route, port_route):
    x = np.random.default_rng(scale).random((2, 6, 7, 3), np.float32)
    m = _jax_model(scale, block, jax_route)
    params = m.init(jax.random.PRNGKey(scale), jnp.asarray(x))
    ref = np.asarray(m.apply(params, jnp.asarray(x)))
    got = _port_out(_port(scale, params, block, port_route), x)
    assert got.shape == ref.shape == (2, 6 * scale, 7 * scale, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_wdsr_cs_matches_srtpu_kernel_route(monkeypatch, dtype):
    """n_feats 64 (the smallest width srtpu's gate admits), 2 blocks, x4
    at (2, 8, 8): srtpu's trunk takes K7 (interpret mode)."""
    monkeypatch.setenv('SRTPU_CS_OFF_TPU', '1')
    jdt, tdt = {'f32': (None, None),
                'bf16': (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = np.random.default_rng(0).random((2, 8, 8, 3), np.float32)
    m = _jax_model(4, 'B', 'cs', jdt, n_feats=64)
    params = m.init(jax.random.PRNGKey(1), jnp.asarray(x))
    cs_conv.PATH_LOG.clear()
    ref = np.asarray(m.apply(params, jnp.asarray(x)).astype(jnp.float32))
    assert cs_conv.PATH_LOG == {('CSWDSRTrunk', (2, 8, 8, 64)): 'cs'}
    got = _port_out(_port(4, params, 'B', 'cs', tdt, n_feats=64), x)
    assert np.abs(ref).max() < 2
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol(dtype))


# ----------------------------------------------------------- (e) converter

TREES = [('B', False), ('B', 'cs'), ('A', False)]


@pytest.mark.parametrize('block,use_pallas', TREES)
def test_convert_npz_roundtrip(tmp_path, block, use_pallas):
    """A flat .npz as a JAX host writes it converts, through
    convert.main, to the tree's own state dict, which fills every
    parameter of the port's WDSR and gives one image on both routes."""
    from srtpu_torch.convert import main
    m = _jax_model(4, block, use_pallas)
    params = _tree_np(m.init(jax.random.PRNGKey(0), jnp.zeros((1, 6, 6, 3))))
    flat = {'/'.join(k.key for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(tmp_path / 'p.npz', **flat)
    sd = params_from_jax(load_npz(tmp_path / 'p.npz'))
    ref = params_from_jax(params)
    assert sd.keys() == ref.keys()
    for k in sd:
        torch.testing.assert_close(sd[k], ref[k], rtol=0, atol=0)
    assert main([str(tmp_path / 'p.npz'), str(tmp_path / 'p.pt')]) == 0
    x = np.random.default_rng(1).random((1, 6, 6, 3), np.float32)
    outs = []
    for route in (False, 'cs'):
        model = _port(4, params, block, route)
        model.load_state_dict(torch.load(tmp_path / 'p.pt',
                                         weights_only=True))
        assert sum(a.size for a in jax.tree_util.tree_leaves(params)) == \
            sum(p.numel() for p in model.parameters())
        outs.append(_port_out(model, x))
    np.testing.assert_allclose(outs[1], outs[0], rtol=0, atol=1e-5)


# ---------------------------------------------------------- (f) train step

OPT = ['lr=1e-4', 'eps=1e-4']


@pytest.mark.parametrize('use_pallas', [False, 'cs'])
def test_train_step_matches_srtpu_8_steps(monkeypatch, use_pallas):
    from srtpu.losses import parse_losses as jax_parse_losses
    from srtpu.optim import build_optimizer as jax_build_optimizer
    from srtpu.train import create_train_state
    from srtpu.train import make_train_step as jax_make_train_step
    from srtpu_torch.losses import parse_losses
    from srtpu_torch.optim import build_optimizer
    from srtpu_torch.train import TrainState, make_train_step

    kw = dict(n_feats=64) if use_pallas else {}
    if use_pallas:
        monkeypatch.setenv('SRTPU_CS_OFF_TPU', '1')
    rng = np.random.default_rng(2)
    batches = []
    for _ in range(8):
        hr = rng.random((2, 32, 32, 3), np.float32)
        batches.append((hr.reshape(2, 8, 4, 8, 4, 3).mean((2, 4))
                        .astype(np.float32), hr))
    jstate = create_train_state(_jax_model(4, 'B', use_pallas, **kw),
                                jax_build_optimizer('ADAM', OPT),
                                jax.random.PRNGKey(5),
                                jnp.asarray(batches[0][0]))
    model = _port(4, {'params': jstate.params}, 'B', use_pallas, **kw)
    pstate = TrainState(model, build_optimizer('ADAM', OPT,
                                               model.parameters()))
    jstep = jax_make_train_step(jax_parse_losses('l1'), donate=False)
    pstep = make_train_step(parse_losses('l1'))
    cs_conv.PATH_LOG.clear()
    for lr, hr in batches:
        jstate, jlogs = jstep(jstate, jnp.asarray(lr), jnp.asarray(hr))
        plogs = pstep(pstate, torch.from_numpy(lr), torch.from_numpy(hr))
        np.testing.assert_allclose(float(plogs['loss']), float(jlogs['loss']),
                                   rtol=1e-5)
    if use_pallas:
        assert set(cs_conv.PATH_LOG.values()) == {'cs'}
    want = params_from_jax(_tree_np(jstate.params))
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k, ref in want.items():
        _close(got[k], ref, 1e-4, k)


# ----------------------------------------------------------------- (g) CLI

CLI_KW = ['--n_feats', '16', '--n_resblocks', '2']


def test_predict_cli_matches_srtpu_trainer(tmp_path):
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
    state = create_train_state(_jax_model(4), jax_build_optimizer('ADAM', []),
                               jax.random.PRNGKey(3), jnp.zeros((1, 8, 8, 3)))
    JaxTrainer(JaxTrainerConfig(default_root_dir=str(tmp_path / 'jax'))) \
        .predict(state, JaxSRData(datasets_dir=str(tmp_path / 'datasets'),
                                  predict_datasets=['Demo'], scale_factor=4,
                                  eval_datasets=[], train_datasets=[]))
    torch.save(params_from_jax(_tree_np({'params': state.params})),
               tmp_path / 'w.pt')
    assert cli.main([
        'predict', '--model', 'WDSR', '--weights', str(tmp_path / 'w.pt'),
        *CLI_KW, '--use_pallas', 'cs', '--datasets_dir',
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


def test_fit_cli_then_predict(tmp_path):
    """fit --model WDSR --use_pallas cs --device cpu at x2: a loss per
    epoch, the final weights, which predict --weights reads into 2x
    PNGs."""
    from srtpu_torch import cli
    rng = np.random.default_rng(3)
    hr_dir = tmp_path / 'datasets' / 'Train' / 'HR'
    lr_dir = tmp_path / 'datasets' / 'Train' / 'LR' / 'X2'
    hr_dir.mkdir(parents=True)
    lr_dir.mkdir(parents=True)
    for i in range(4):
        hr = rng.random((32, 32, 3)).astype(np.float32)
        np.save(hr_dir / f'{i}.npy', hr)
        np.save(lr_dir / f'{i}.npy',
                hr.reshape(16, 2, 16, 2, 3).mean((1, 3)))
    run = tmp_path / 'run'
    flags = ['--model', 'WDSR', '--scale_factor', '2', *CLI_KW,
             '--use_pallas', 'cs', '--device', 'cpu']
    assert cli.main([
        'fit', *flags, '--datasets_dir', str(tmp_path / 'datasets'),
        '--train_datasets', 'Train', '--batch_size', '2', '--patch_size',
        '16', '--max_epochs', '2', '--default_root_dir', str(run)]) == 0
    assert 'epoch 2/2  loss' in (run / 'run.log').read_text()
    assert cli.main([
        'predict', *flags, '--weights', str(run / 'final_weights.pt'),
        '--datasets_dir', str(tmp_path / 'datasets'), '--predict_datasets',
        'Train', '--default_root_dir', str(tmp_path / 'out')]) == 0
    png = (tmp_path / 'out' / 'Train' / '0.png').read_bytes()
    assert png[:8] == b'\x89PNG\r\n\x1a\n'
    assert png[12:24] == b'IHDR' + (32).to_bytes(4, 'big') * 2


# ----------------------------------------------------- (h) the CLI's flags

def _built(argv, device='cpu'):
    from srtpu_torch import cli
    args = cli.build_parser().parse_args(
        ['fit', '--train_datasets', 'Train', '--device', device, *argv])
    return cli.build_model(args, torch.device(device))


def test_cli_wdsr_takes_its_own_defaults():
    """No --n_feats: srtpu's WDSR width, 128 (and its 16 B blocks); a
    given flag still wins."""
    model = _built(['--model', 'WDSR'])
    assert model.head.v.shape[-1] == 128 and len(model.blocks) == 16
    assert model.blocks[0].expand.v.shape == (1, 1, 128, 768)
    assert not model.blocks[0].kernel
    model = _built(['--model', 'WDSR', '--n_feats', '32', '--use_pallas',
                    'cs', '--block_type', 'B', '--res_scale', '0.5'])
    assert model.head.v.shape[-1] == 32 and model.blocks[0].kernel
    assert model.blocks[0].res_scale == 0.5


@pytest.mark.parametrize('name,old', [
    ('EDSR', dict(n_feats=64, n_resblocks=16)),
    ('RCAN', dict(n_feats=64, n_resblocks=16, n_resgroups=10,
                  reduction=16)),
    ('SRResNet', dict(n_feats=64, n_resblocks=16)),
    ('RDN', dict(rdn_config='B', growth0=64)),
    ('DDBPN', dict(n0=128, nr=32, depth=6))])
def test_cli_other_families_build_as_before(name, old):
    """The flags' old defaults are these families' own: the same
    parameters from the same seed."""
    got = _built(['--model', name, '--seed', '3']).state_dict()
    want = create_model(name, dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(3),
                        **old).state_dict()
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k


def test_cli_use_pallas_true_raises():
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        _built(['--model', 'WDSR', '--use_pallas', 'true'])


def test_cs_at_a_width_k7_does_not_take():
    """n_feats 24 (not a multiple of 16) with --use_pallas cs: off the
    CPU the wrapper raises (no fallback); on the CPU the plain version
    runs."""
    model = _built(['--model', 'WDSR', '--n_feats', '24', '--n_resblocks',
                    '1', '--use_pallas', 'cs', '--scale_factor', '2'])
    with torch.inference_mode():
        out = model(torch.rand(1, 6, 6, 3))
    assert out.shape == (1, 12, 12, 3) and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match='no kernel for C=24'):
        with torch.inference_mode():
            model.to('meta')(torch.rand(1, 6, 6, 3, device='meta'))
    x = torch.zeros(1, 4, 4, 24, device='meta')
    w1, b1 = torch.zeros(24, 144, device='meta'), torch.zeros(144)
    w2, b2 = torch.zeros(144, 32, device='meta'), torch.zeros(32)
    w3, b3 = torch.zeros(3, 3, 32, 24, device='meta'), torch.zeros(24)
    with pytest.raises(ValueError, match='no kernel for C=24'):
        k7.wdsr_fwd(x, w1, b1, w2, b2, w3, b3, 1.0)
    with pytest.raises(ValueError, match='no kernel for C=24'):
        k7.wdsr_bwd(x, x, w1, b1, w2, b2, w3, 1.0)
    x16 = torch.zeros(1, 4, 4, 16, device='meta')
    with pytest.raises(ValueError, match='no kernel for device meta'):
        k7.wdsr_fwd(x16, torch.zeros(16, 96, device='meta'), b1,
                    torch.zeros(96, 16, device='meta'), b2,
                    torch.zeros(3, 3, 16, 16, device='meta'), b3, 1.0)
