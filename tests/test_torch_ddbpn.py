"""The port's DDBPN (its builders, K2 at the new shapes and the model)
against srtpu on the CPU.

Small sizes: n0 = 32, nr = 16, depth 3 or 4, LR 8x8, batch 2-4. srtpu's
DDBPN(use_pallas='cs') takes its NHWC branch on the CPU (its cs_plan is
TPU-gated), the same coarse convs as its kernel path
(tests/test_ddbpn_cs.py holds the two equal); K2 itself runs as
srtpu's tests run it off the TPU: SRTPU_CS_OFF_TPU=1, Pallas in
interpret mode.

(a) ``ops.ddbpn``'s scatter maps, ``w_up_pm``, ``w_down_pd`` and the three
    live-tap masks against ``srtpu.ops.ddbpn_cs``'s at r = 2, 4, 8: exact.
(b) the plain K2 (forward, dx, dW, db) at the shapes K2's general path
    takes on the DDBPN and x3 paths, against conv3x3_cs_fwd / _bwd in
    interpret mode: f32, 1e-4 of each output's largest magnitude (the
    same f32 products summed in another order).
(c) the model from both of srtpu's trees through srtpu_torch.convert,
    against DDBPN(use_pallas='cs') and DDBPN(use_pallas=False) at x2, x4
    and x8, f32 within 1e-5.
(d) every parameter's gradient against jax.grad of srtpu's 'cs' model
    under an L1 loss, within 1e-4 of each tensor's largest magnitude, and
    every dead-tap slot's gradient exactly 0.
(e) 8 Adam steps (lr 1e-4, eps 1e-4, L1, f32) against srtpu's
    make_train_step: each loss within 1e-5 relative, the final params
    within 1e-4 of each tensor's largest magnitude.
(f) ``fit`` and ``predict --model DDBPN --device cpu`` through the CLI:
    the fit log and weights, and predict's PNGs within one uint8 level of
    srtpu's Trainer.predict on the same weights.
(g) the .npz converter for both trees; K2 and the weight-grad kernel take
    the x3 tails' 576 <-> 32 (F4); the wrappers launch or raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srtpu.models import create_model as jax_create_model
from srtpu.ops import cs_conv
from srtpu.ops import ddbpn_cs as jax_ddbpn
from srtpu_torch.convert import load_npz, params_from_jax
from srtpu_torch.models import create_model
from srtpu_torch.ops import conv3x3_bwd_plain, conv3x3_plain
from srtpu_torch.ops import ddbpn as port_ddbpn
from srtpu_torch.ops.layout import w_hwio_from_cs

torch.set_num_threads(1)

B, H, W, K = 2, 8, 8, 2        # two 8x8 images per CS lane-row: S = 128
KW = dict(n0=32, nr=16, depth=3)


def _np(t):
    return np.array(t, dtype=np.float32)


def _close(got, ref, rel, what=''):
    got = got.detach().float().numpy() if torch.is_tensor(got) else _np(got)
    ref = _np(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * np.abs(ref).max(), err_msg=what)


# --------------------------------------------------------- (a) builders

@pytest.mark.parametrize('r', [2, 4, 8])
def test_builders_match_srtpu(r):
    k, _, p = jax_ddbpn._PROJ_PARAMS[r]
    assert port_ddbpn._PROJ_PARAMS[r] == jax_ddbpn._PROJ_PARAMS[r]
    assert port_ddbpn.up_pm_scatter(r, k, p) == jax_ddbpn.up_pm_scatter(r, k,
                                                                        p)
    assert port_ddbpn.down_pm_scatter(r, k, p) == \
        jax_ddbpn.down_pm_scatter(r, k, p)
    rng = np.random.default_rng(r)
    w_up = rng.standard_normal((k, k, 5, 3)).astype(np.float32)   # HWOI
    w_dn = rng.standard_normal((k, k, 3, 5)).astype(np.float32)   # HWIO
    np.testing.assert_array_equal(
        port_ddbpn.w_up_pm(torch.from_numpy(w_up), r).numpy(),
        _np(jax_ddbpn.w_up_pm(jnp.asarray(w_up), r)))
    np.testing.assert_array_equal(
        port_ddbpn.w_down_pd(torch.from_numpy(w_dn), r).numpy(),
        _np(jax_ddbpn.w_down_pd(jnp.asarray(w_dn), r)))
    x = rng.standard_normal((2, 3 * r, 2 * r, 4)).astype(np.float32)
    pm = port_ddbpn.nhwc_to_pm(torch.from_numpy(x), r)
    np.testing.assert_array_equal(pm.numpy(),
                                  _np(jax_ddbpn.nhwc_to_pm(jnp.asarray(x), r)))
    np.testing.assert_array_equal(port_ddbpn.pm_to_nhwc_fine(pm, r).numpy(),
                                  x)


@pytest.mark.parametrize('r', [2, 4, 8])
def test_masks_match_srtpu(r):
    """The port's HWIO masks are srtpu's CS-arranged ones, unstacked; at r
    = 4 four of nine coarse taps per phase pair are live (4/9)."""
    c, ch = 16, 3
    r2 = r * r
    up = jax_ddbpn.up_mask_cs(r, c, c)
    dn = jax_ddbpn.down_mask_cs(r, c, c)
    fin = jax_ddbpn.final_mask_cs(r, c, ch)
    co = fin.shape[0] // 3
    for got, ref, cin, cout in (
            (port_ddbpn.up_mask(r, c, c), up, c, r2 * c),
            (port_ddbpn.down_mask(r, c, c), dn, r2 * c, c),
            (port_ddbpn.final_mask(r, c, ch), fin, r2 * c, co)):
        want = w_hwio_from_cs(torch.tensor(ref)[None], cin, cout)[0]
        assert got.shape == (3, 3, cin, cout)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    if r == 4:
        m = port_ddbpn.up_mask(r, c, c)
        assert int(m.sum()) * 9 == 4 * m.numel()


# ------------------------------------------------ (b) K2 at the new shapes

# (c_in, c_out, k): DDBPN x4 (nr 32) up, down, output conv; x2 up, down,
# output conv; the x3 tails' phase-dense convs at 3x3 (EDSR) and 5x5
# (SRResNet). Their dx shapes are the reverse, run by each backward.
NEW_SHAPES = [(32, 512, 3), (512, 32, 3), (512, 48, 3), (32, 128, 3),
              (128, 32, 3), (128, 16, 3), (576, 32, 3), (576, 32, 5)]


@pytest.mark.parametrize('c_in,c_out,k', NEW_SHAPES)
def test_conv_plain_matches_pallas_new_shapes(monkeypatch, c_in, c_out, k):
    monkeypatch.setenv('SRTPU_CS_OFF_TPU', '1')
    rng = np.random.default_rng(c_in + c_out + k)
    x = rng.standard_normal((B, H, W, c_in)).astype(np.float32)
    w = (rng.standard_normal((k, k, c_in, c_out))
         / np.sqrt(k * k * c_in)).astype(np.float32)
    b = (rng.standard_normal(c_out) * 0.1).astype(np.float32)
    g = rng.standard_normal((B, H, W, c_out)).astype(np.float32)

    def fn(xc, wc, bc):
        return cs_conv.conv3x3_cs(xc, wc, bc, W, K)
    out, vjp = jax.vjp(fn, cs_conv.nhwc_to_cs(jnp.asarray(x), K),
                       jnp.asarray(w), jnp.asarray(b))
    dx, dw, db = vjp(cs_conv.nhwc_to_cs(jnp.asarray(g), K))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    _close(conv3x3_plain(xt, wt, torch.from_numpy(b)),
           cs_conv.cs_to_nhwc(out, K, H, W), 1e-4, 'y')
    gdx, gdw, gdb = conv3x3_bwd_plain(xt, wt, torch.from_numpy(g))
    assert gdw.shape == (k, k, c_in, c_out)
    _close(gdx, cs_conv.cs_to_nhwc(dx, K, H, W), 1e-4, 'dx')
    _close(gdw, dw, 1e-4, 'dW')
    _close(gdb, db, 1e-4, 'db')


# ------------------------------------------------------------- (c) model

def _tree_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _jax_model(scale, use_pallas='cs', **kw):
    return jax_create_model('DDBPN', scale_factor=scale,
                            use_pallas=use_pallas, **{**KW, **kw})


def _port(scale, params, **kw):
    model = create_model('DDBPN', scale_factor=scale,
                         generator=torch.Generator().manual_seed(0),
                         **{**KW, **kw})
    model.load_state_dict(params_from_jax(_tree_np(params)))
    return model


@pytest.mark.parametrize('use_pallas', ['cs', False])
@pytest.mark.parametrize('scale', [2, 4, 8])
def test_ddbpn_matches_srtpu(scale, use_pallas):
    x = np.random.default_rng(scale).random((2, 6, 7, 3), np.float32)
    m = _jax_model(scale, use_pallas)
    params = m.init(jax.random.PRNGKey(scale), jnp.asarray(x))
    ref = np.asarray(m.apply(params, jnp.asarray(x)))
    model = _port(scale, params)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 6 * scale, 7 * scale, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_ddbpn_depth4_bottlenecks_match_srtpu():
    """depth 4: up units with 2 and 3 input blocks, down units with 2 and
    3 HR blocks (the bottleneck's group view), at x4."""
    x = np.random.default_rng(11).random((2, 8, 8, 3), np.float32)
    m = _jax_model(4, depth=4)
    params = m.init(jax.random.PRNGKey(4), jnp.asarray(x))
    ref = np.asarray(m.apply(params, jnp.asarray(x)))
    with torch.inference_mode():
        got = _port(4, params, depth=4)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def _l1_grads(scale, seed):
    """(port model, its grads by name, srtpu's grads as a port state dict)
    of an L1 loss at one batch, from one 'cs' tree."""
    rng = np.random.default_rng(seed)
    x = rng.random((4, 8, 8, 3), np.float32)
    gt = rng.random((4, 8 * scale, 8 * scale, 3), np.float32)
    m = _jax_model(scale)
    params = m.init(jax.random.PRNGKey(seed), jnp.asarray(x))['params']

    def loss(p):
        return jnp.mean(jnp.abs(m.apply({'params': p}, jnp.asarray(x))
                                - jnp.asarray(gt)))
    ref = params_from_jax(_tree_np(jax.grad(loss)(params)))
    model = _port(scale, {'params': params})
    out = model(torch.from_numpy(x))
    (out - torch.from_numpy(gt)).abs().mean().backward()
    return model, {n: p.grad for n, p in model.named_parameters()}, ref


@pytest.mark.parametrize('scale', [2, 4])
def test_grads_match_jax_grad(scale):
    _, got, ref = _l1_grads(scale, seed=scale + 20)
    assert got.keys() == ref.keys()
    for n, g in got.items():
        assert g is not None and g.dtype == torch.float32, n
        _close(g, ref[n], 1e-4, n)


@pytest.mark.parametrize('scale', [2, 4])
def test_dead_tap_grads_exactly_zero(scale):
    """A dead slot's gradient is exactly 0 (the mask multiplies the stored
    weight before the cast); the live slots' are not all 0."""
    model, got, _ = _l1_grads(scale, seed=scale + 30)
    masks = {True: model.m_up, False: model.m_down}
    for i, unit in enumerate(model.units):
        for name, is_up in (('a0', unit.up), ('b0', not unit.up),
                            ('a1', unit.up)):
            g, m = got[f'units.{i}.{name}_weight'], masks[is_up]
            assert torch.all(g[m == 0] == 0), (i, name)
            assert torch.any(g[m != 0] != 0), (i, name)
    g = got['out_weight']
    assert torch.all(g[:, model.m_out == 0] == 0)
    assert torch.any(g[:, model.m_out != 0] != 0)


# -------------------------------------------------------- (e) train step

OPT = ['lr=1e-4', 'eps=1e-4']


def test_train_step_matches_srtpu_8_steps():
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
    model = _port(4, {'params': jstate.params})
    pstate = TrainState(model, build_optimizer('ADAM', OPT,
                                               model.parameters()))
    jstep = jax_make_train_step(jax_parse_losses('l1'), donate=False)
    pstep = make_train_step(parse_losses('l1'))
    for lr, hr in batches:
        jstate, jlogs = jstep(jstate, jnp.asarray(lr), jnp.asarray(hr))
        plogs = pstep(pstate, torch.from_numpy(lr), torch.from_numpy(hr))
        np.testing.assert_allclose(float(plogs['loss']), float(jlogs['loss']),
                                   rtol=1e-5)
    want = params_from_jax(_tree_np(jstate.params))
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k, ref in want.items():
        _close(got[k], ref, 1e-4, k)


# ----------------------------------------------------------------- (f) CLI

CLI_KW = ['--n0', '32', '--nr', '16', '--depth', '3']


def _write_pngs(root, rng):
    from PIL import Image
    demo = root / 'datasets' / 'Demo'
    demo.mkdir(parents=True)
    lo = rng.random((7, 11, 3))
    img = np.kron(lo, np.ones((4, 4, 1)))[:24, :40]   # bucket-pads to 32x64
    Image.fromarray((img * 255).astype(np.uint8)).save(demo / 'a.png')
    return root / 'datasets'


def test_predict_cli_matches_srtpu_trainer(tmp_path):
    from PIL import Image

    from srtpu.data import SRData as JaxSRData
    from srtpu.optim import build_optimizer as jax_build_optimizer
    from srtpu.train import Trainer as JaxTrainer
    from srtpu.train import TrainerConfig as JaxTrainerConfig
    from srtpu.train import create_train_state
    from srtpu_torch import cli

    datasets = _write_pngs(tmp_path, np.random.default_rng(7))
    state = create_train_state(_jax_model(4), jax_build_optimizer('ADAM', []),
                               jax.random.PRNGKey(3), jnp.zeros((1, 8, 8, 3)))
    JaxTrainer(JaxTrainerConfig(default_root_dir=str(tmp_path / 'jax'))) \
        .predict(state, JaxSRData(datasets_dir=str(datasets),
                                  predict_datasets=['Demo'], scale_factor=4,
                                  eval_datasets=[], train_datasets=[]))
    torch.save(params_from_jax(_tree_np({'params': state.params})),
               tmp_path / 'w.pt')
    assert cli.main([
        'predict', '--model', 'DDBPN', '--weights', str(tmp_path / 'w.pt'),
        *CLI_KW, '--datasets_dir', str(datasets), '--predict_datasets',
        'Demo', '--precision', '32', '--device', 'cpu', '--default_root_dir',
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
    """fit --model DDBPN --device cpu at x2: a loss per epoch, the final
    weights, which predict --weights reads into 2x PNGs."""
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
    assert cli.main([
        'fit', '--model', 'DDBPN', '--scale_factor', '2', *CLI_KW,
        '--datasets_dir', str(tmp_path / 'datasets'), '--train_datasets',
        'Train', '--batch_size', '2', '--patch_size', '16', '--max_epochs',
        '2', '--device', 'cpu', '--default_root_dir', str(run)]) == 0
    log = (run / 'run.log').read_text()
    assert 'epoch 2/2  loss' in log
    assert cli.main([
        'predict', '--model', 'DDBPN', '--scale_factor', '2', *CLI_KW,
        '--weights', str(run / 'final_weights.pt'), '--datasets_dir',
        str(tmp_path / 'datasets'), '--predict_datasets', 'Train',
        '--device', 'cpu', '--default_root_dir', str(tmp_path / 'out')]) == 0
    png = (tmp_path / 'out' / 'Train' / '0.png').read_bytes()
    assert png[:8] == b'\x89PNG\r\n\x1a\n'
    assert png[12:24] == b'IHDR' + (32).to_bytes(4, 'big') * 2


# ---------------------------------------------------------- (g) converter

@pytest.mark.parametrize('use_pallas', ['cs', False])
def test_convert_npz_roundtrip(tmp_path, use_pallas):
    """A flat .npz as a JAX host writes it converts, through convert.main,
    to the same state dict as the tree itself, which fills every
    parameter of the port's DDBPN (srtpu's trees hold the same count)."""
    from srtpu_torch.convert import main
    m = _jax_model(4, use_pallas)
    params = _tree_np(m.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 3))))
    flat = {'/'.join(k.key for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(tmp_path / 'p.npz', **flat)
    sd = params_from_jax(load_npz(tmp_path / 'p.npz'))
    ref = params_from_jax(params)
    assert sd.keys() == ref.keys()
    for k in sd:
        torch.testing.assert_close(sd[k], ref[k], rtol=0, atol=0)
    assert main([str(tmp_path / 'p.npz'), str(tmp_path / 'p.pt')]) == 0
    model = _port(4, params)
    model.load_state_dict(torch.load(tmp_path / 'p.pt', weights_only=True))
    if use_pallas == 'cs':
        n_jax = sum(a.size for a in jax.tree_util.tree_leaves(params))
        assert n_jax == sum(p.numel() for p in model.parameters())


def test_x3_tails_and_ddbpn_shapes_are_taken():
    """F4: K2 and the weight-grad kernel take the x3 tails' 576 -> 32 at
    3x3 and 5x5 and their 32 -> 576 dx, and DDBPN's shapes; EDSR and
    SRResNet run x3 on the card, DDBPN x2 and x4 on K2 and x8 on srtpu's
    XLA branch (stock convs)."""
    from srtpu_torch.models import DDBPN, EDSR, SRResNet
    from srtpu_torch.ops import conv as k2
    from srtpu_torch.ops import wgrad
    for cin, cout in ((576, 32), (32, 576), (32, 512), (512, 32), (512, 48),
                      (48, 512), (32, 128), (128, 32), (128, 16)):
        for k in (3, 5):
            assert k2._engine_takes(cin, cout, k)
            assert wgrad._kernel_takes(cin, cout, 1, k)
    for cin, cout, k in ((24, 32, 3), (32, 40, 3), (32, 32, 7)):
        assert not k2._engine_takes(cin, cout, k)
        assert not wgrad._kernel_takes(cin, cout, 1, k)
    assert 3 in EDSR.CARD_SCALES and 3 in SRResNet.CARD_SCALES
    assert DDBPN.CARD_SCALES == (2, 4, 8)


def test_wrappers_launch_or_raise():
    """On a device other than the CPU the wrappers launch a kernel or
    raise; a DDBPN shape is no exception."""
    from srtpu_torch.ops import conv3x3_bwd, conv3x3_fwd, conv_wgrad
    x = torch.zeros(1, 4, 4, 512, device='meta')
    w = torch.zeros(3, 3, 512, 48, device='meta')
    b = torch.zeros(48, device='meta')
    g = torch.zeros(1, 4, 4, 48, device='meta')
    for call in (lambda: conv3x3_fwd(x, w, b), lambda: conv3x3_bwd(x, w, g),
                 lambda: conv_wgrad(x, g)):
        with pytest.raises(ValueError, match='no kernel'):
            call()
