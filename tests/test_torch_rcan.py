"""The port's RCAN (K5 and the model around it) against srtpu on the CPU.

Small size throughout: batch 2, LR 8x8, n_feats 16, reduction 4 (C/r =
4), 2 groups of 2 RCABs. srtpu's kernels run as its own tests run them
off the TPU: SRTPU_CS_OFF_TPU=1, Pallas in interpret mode, and
cs_conv.PATH_LOG shows 'cs' for CSRCANTrunk.

(a) resgroup_plain and its backward against resgroup_ca_cs: the output,
    dx and all ten parameter grads. f32 at 1e-4 of each tensor's largest
    magnitude (the sums run in another order). bf16: one bf16 step
    (2^-7) of the largest magnitude for the output and dx, which round
    at the same points on both sides, so only a value next to a rounding
    boundary lands a step apart; the f32 weight grads within 2^-6 of
    their largest magnitude, since they sum products of those bf16
    activations, a few of which may sit a step apart.
(b) the RCAN model against srtpu's RCAN on both parameter trees through
    srtpu_torch.convert: the 'cs' tree on the interpret-mode kernel path
    at x4 in f32 (1e-4) and bf16 (2^-6 on outputs below 2, as the EDSR
    test), and both trees on srtpu's XLA path in f32 at x2, x3 and x4.
(c) the train step (L1, Adam at lr 1e-3 and eps 1e-4, f32) over 8 steps
    against srtpu's make_train_step from the same init and batches: the
    loss at every step within 1e-5 relative and the final params within
    1e-4 of each tensor's largest magnitude (eps 1e-4 for the reason in
    tests/test_torch_train.py).
(d) ``python -m srtpu_torch predict --model RCAN --device cpu`` against
    srtpu's Trainer.predict on an image that needs bucket padding (the
    channel attention pools over the padded image on both sides): PNGs
    within one uint8 level.
(e) the .npz converter round trip for both RCAN trees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srtpu.models import create_model as jax_create_model
from srtpu.ops import cs_conv
from srtpu_torch.convert import load_npz, params_from_jax
from srtpu_torch.models import create_model
from srtpu_torch.ops import resgroup
from srtpu_torch.ops.layout import w_hwio_from_cs

torch.set_num_threads(1)

C, CR, L = 16, 4, 2
KW = dict(n_feats=C, n_resblocks=L, n_resgroups=2, reduction=C // CR)


def _tree_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _group_params(seed):
    """srtpu's CSResidualGroup parameters (CS-arranged conv weights) at
    its init bounds, from a numpy seed."""
    rng = np.random.default_rng(seed)

    def u(bound, *shape):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    cb = (9 * C) ** -0.5
    return dict(w1=u(cb, L, 3 * C, 3 * C), b1=u(cb, L, C),
                w2=u(cb, L, 3 * C, 3 * C), b2=u(cb, L, C),
                wd=u(C ** -0.5, L, C, CR), bd=u(C ** -0.5, L, CR),
                wu=u(CR ** -0.5, L, CR, C), bu=u(CR ** -0.5, L, C),
                wc=u(cb, 3 * C, 3 * C), bc=u(cb, C))


def _to_port(name, a):
    """A CS-arranged group parameter (or its grad) as the port's HWIO."""
    t = torch.from_numpy(np.array(a, np.float32))
    if name in ('w1', 'w2'):
        return w_hwio_from_cs(t, C, C).contiguous()
    if name == 'wc':
        return w_hwio_from_cs(t[None], C, C)[0].contiguous()
    return t


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_resgroup_matches_pallas_interpret(monkeypatch, dtype):
    monkeypatch.setenv('SRTPU_CS_OFF_TPU', '1')
    jdt, tdt = {'f32': (jnp.float32, torch.float32),
                'bf16': (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (2, 8, 8, C)).astype(np.float32)
    g = rng.uniform(-1, 1, (2, 8, 8, C)).astype(np.float32)
    prm = _group_params(4)
    names = list(prm)

    k = 2
    x_cs = cs_conv.nhwc_to_cs(jnp.asarray(x, jdt), k)

    def fn(x_cs, *ps):
        return cs_conv.resgroup_ca_cs(x_cs, *ps, 8, 8, k)

    out_cs, vjp = jax.vjp(fn, x_cs, *(jnp.asarray(prm[n]) for n in names))
    ref_out = np.asarray(cs_conv.cs_to_nhwc(out_cs, k, 8, 8), np.float32)
    ref_grads = vjp(cs_conv.nhwc_to_cs(jnp.asarray(g, jdt), k))
    ref_dx = np.asarray(cs_conv.cs_to_nhwc(ref_grads[0], k, 8, 8),
                        np.float32)

    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    pt = [_to_port(n, prm[n]).requires_grad_() for n in names]
    out = resgroup(xt, *pt)
    assert out.dtype == tdt
    out.backward(torch.from_numpy(g).to(tdt))

    act_tol, grad_tol = (1e-4, 1e-4) if dtype == 'f32' else (2. ** -7,
                                                             2. ** -6)

    def close(got, ref, rel, what):
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                                   atol=rel * np.abs(ref).max(), err_msg=what)

    close(out.detach().float().numpy(), ref_out, act_tol, 'out')
    close(xt.grad.float().numpy(), ref_dx, act_tol, 'dx')
    for n, p, ref in zip(names, pt, ref_grads[1:]):
        assert p.grad.dtype == torch.float32
        close(p.grad.numpy(), _to_port(n, ref).numpy(), grad_tol, n)


# ------------------------------------------------------------- (b) model

def _jax_model(scale, use_pallas='cs', dtype=None):
    return jax_create_model('RCAN', scale_factor=scale, use_pallas=use_pallas,
                            dtype=dtype, **KW)


def _port(scale, params, dtype=None):
    model = create_model('RCAN', scale_factor=scale, dtype=dtype,
                         generator=torch.Generator().manual_seed(0), **KW)
    model.load_state_dict(params_from_jax(_tree_np(params)))
    return model


def _port_out(model, x):
    with torch.inference_mode():
        return model(torch.from_numpy(x)).float().numpy()


@pytest.mark.parametrize('use_pallas', ['cs', False])
@pytest.mark.parametrize('scale', [2, 3, 4])
def test_rcan_matches_jax_xla_path(scale, use_pallas):
    x = np.random.default_rng(scale).random((2, 6, 7, 3), np.float32)
    m = _jax_model(scale, use_pallas)
    params = m.init(jax.random.PRNGKey(scale), jnp.asarray(x))
    ref = np.asarray(m.apply(params, jnp.asarray(x)))
    got = _port_out(_port(scale, params), x)
    assert got.shape == ref.shape == (2, 6 * scale, 7 * scale, 3)
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_rcan_matches_jax_pallas_interpret(monkeypatch, dtype):
    """x4 at (2, 8, 8): srtpu's trunk takes the K5 and K2 kernels (checked
    through cs_conv.PATH_LOG), run in interpret mode."""
    monkeypatch.setenv('SRTPU_CS_OFF_TPU', '1')
    jdt, tdt = {'f32': (None, None),
                'bf16': (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = np.random.default_rng(0).random((2, 8, 8, 3), np.float32)
    m = _jax_model(4, dtype=jdt)
    params = m.init(jax.random.PRNGKey(1), jnp.asarray(x))
    cs_conv.PATH_LOG.clear()
    ref = np.asarray(m.apply(params, jnp.asarray(x)).astype(jnp.float32))
    assert cs_conv.PATH_LOG == {('CSRCANTrunk', (2, 8, 8, C)): 'cs'}
    got = _port_out(_port(4, params, tdt), x)
    atol = 1e-4 if dtype == 'f32' else 2.0 ** -6
    assert np.abs(ref).max() < 2
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


# -------------------------------------------------------- (c) train step

OPT = ['lr=1e-3', 'eps=1e-4']


def test_train_step_matches_srtpu():
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
        np.testing.assert_allclose(got[k].numpy(), ref.numpy(), rtol=0,
                                   atol=1e-4 * ref.abs().max().item(),
                                   err_msg=k)


# ----------------------------------------------------------- (d) predict

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
    rng = np.random.default_rng(7)
    lo = rng.random((7, 11, 3))
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
        'predict', '--model', 'RCAN', '--weights', str(tmp_path / 'w.pt'),
        '--n_feats', str(C), '--n_resblocks', str(L), '--n_resgroups', '2',
        '--reduction', str(C // CR), '--datasets_dir',
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


# --------------------------------------------------------- (e) converter

@pytest.mark.parametrize('use_pallas', ['cs', False])
def test_convert_npz_roundtrip(tmp_path, use_pallas):
    """A flat .npz as a JAX host writes it converts to the same state dict
    as the tree itself, which loads into the port's RCAN, and the CLI
    writes a loadable .pt."""
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
    _port(4, params).load_state_dict(
        torch.load(tmp_path / 'p.pt', weights_only=True))


# ---------------------------------------------- (f) F11: past 96 features

def _boom(*a, **kw):
    raise AssertionError('a kernel op of the port ran past 96 features')


@pytest.mark.parametrize('scale', [2, 4])
def test_rcan_past_96_features_is_srtpus_xla_path(monkeypatch, scale):
    """F11: at 128 features srtpu's CSRCANTrunk runs its groups' XLA math
    (``xla_apply``: r2 rounded, the gate in bf16, the skips rounded, the
    close convs as conv3x3_reference) though its kernels are on
    (SRTPU_CS_OFF_TPU=1); the port's 'cs' route computes the same in
    stock ops, no K5 or K2 op: bf16, one group of 2 RCABs, LR 16x16.

    The trunk's output (the upscale stage's input): at most 1/8 of its
    values apart at all, their mean difference at most 2^-13. The f32
    sums run in another order on the two sides, so a value next to a
    bf16 rounding boundary lands a step apart; a one-step flip of a bf16
    gate value scales a whole channel of an image (1/128 of the values),
    and the trunk close conv reads 1,152 values for each output, so such
    steps spread (about 6% apart, mean 2^-14.5 here). K5's math (r2 kept
    in f32, one rounding per RCAB) leaves about 27% apart, mean 2^-12.1.
    The SR image: every value within 2^-6 of the largest magnitude (as
    EDSR past 96 features)."""
    import flax.linen as fnn
    import srtpu_torch.models.rcan as port_rcan
    monkeypatch.setenv('SRTPU_CS_OFF_TPU', '1')
    for name in ('resgroup', 'conv3x3'):
        monkeypatch.setattr(port_rcan, name, _boom)
    x = np.random.default_rng(scale).random((2, 16, 16, 3), np.float32)
    kw = dict(scale_factor=scale, n_feats=128, n_resblocks=2, n_resgroups=1,
              reduction=16)
    m = jax_create_model('RCAN', dtype=jnp.bfloat16, **kw)
    params = m.init(jax.random.PRNGKey(scale), jnp.asarray(x))
    seen = {}

    def trunk_out(next_fun, args, kwargs, context):
        if type(context.module).__name__ == 'UpscaleBlock':
            seen['ref'] = np.asarray(args[0].astype(jnp.float32))
        return next_fun(*args, **kwargs)

    cs_conv.PATH_LOG.clear()
    with fnn.intercept_methods(trunk_out):
        ref = np.asarray(m.apply(params, jnp.asarray(x)).astype(jnp.float32))
    assert set(cs_conv.PATH_LOG.values()) == {'xla'}
    port = create_model('RCAN', dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0), **kw)
    port.load_state_dict(params_from_jax(_tree_np(params)))
    port.upscale.register_forward_pre_hook(
        lambda mod, args: seen.update(got=args[0].float().numpy()))
    got = _port_out(port, x)
    assert seen['got'].shape == seen['ref'].shape == (2, 16, 16, 128)
    diff = np.abs(seen['got'] - seen['ref'])
    assert (diff > 0).mean() <= 1 / 8, (diff > 0).mean()
    assert diff.mean() <= 2.0 ** -13, diff.mean()
    assert got.shape == ref.shape == (2, 16 * scale, 16 * scale, 3)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2.0 ** -6 * np.abs(ref).max())


def test_f12_rcan_cs_past_s_max_within_route_tolerance(monkeypatch):
    """F12, RCAN's 'cs' route past srtpu's ``S_MAX`` (8,320 lanes a kernel
    group): srtpu's CSRCANTrunk takes ``xla_apply`` there (r2 rounded, the
    gate in bf16, the skips rounded), and RCAN is left out of tiled
    predict; the port runs K5's math (r2 in f32, one rounding per RCAB) at
    every size. At 64 features, one group of 2 RCABs, reduction 16, batch
    1, LR 96x96 (9,216 lanes), bf16, x2: the SR image within the bf16
    tolerance of (b), 2^-6 (outputs below 2). ``pytest -s`` prints the
    gap."""
    monkeypatch.setenv('SRTPU_CS_OFF_TPU', '1')
    x = np.random.default_rng(96).random((1, 96, 96, 3), np.float32)
    kw = dict(scale_factor=2, n_feats=64, n_resblocks=2, n_resgroups=1,
              reduction=16)
    m = jax_create_model('RCAN', dtype=jnp.bfloat16, **kw)
    params = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    cs_conv.PATH_LOG.clear()
    ref = np.asarray(m.apply(params, jnp.asarray(x)).astype(jnp.float32))
    assert set(cs_conv.PATH_LOG.values()) == {'xla'}
    port = create_model('RCAN', dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0), **kw)
    port.load_state_dict(params_from_jax(_tree_np(params)))
    got = _port_out(port, x)
    assert got.shape == ref.shape == (1, 192, 192, 3)
    assert np.abs(ref).max() < 2
    gap = float(np.abs(got - ref).max())
    print(f'F12 RCAN cs past S_MAX: max |d| {gap:.4g} (2^{np.log2(gap):.2f}),'
          f' share apart {(got != ref).mean():.4g}')
    assert gap <= 2.0 ** -6, gap
