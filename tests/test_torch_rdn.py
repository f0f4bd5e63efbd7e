"""The port's RDN (K6 and the model around it) against srtpu on the CPU.

Small sizes throughout. The K6 functions at B = 4, 8x8 in two
arrangements: G0 = 16, C = 3, D = 2 (chunks of 16 channels, srtpu's
tests/test_ops_cs.py:1195-1212) and G0 = 64, C = 2, D = 1 (the card's
64-channel chunks). The model at a config 'T' of D = 2 blocks of C = 3
layers at G = G0 = 16, registered in both packages' RDN_CONFIGS for the
test. srtpu's kernels run as its own tests run them off the TPU:
SRTPU_CS_OFF_TPU=1, Pallas in interpret mode, cs_conv.PATH_LOG showing
'cs' for CSRDNTrunk.

(a) the plain K6 functions against rdn_all_fwd, rdb_bwd_chain_all and
    rdb_bwd_dw_all on the same inputs: f32 within 1e-4 of each output's
    largest magnitude (the sums run in another order). bf16: the bf16
    outputs (cat, the buffers, dx, dout) within two bf16 steps (2^-6) of
    their largest magnitude: both sides round at the same points, so only
    a value next to a rounding boundary lands a step apart, and a later
    layer that reads it may move by one more; the f32 sums (dwf, dbf, db,
    dW) within 2^-6 as well, since they sum products of those bf16
    values, a few of which may sit a step apart.
(b) RDNTrunkFn's value and every grad against jax.grad of
    rdn_trunk_cat_cs under an asymmetric cat cotangent: f32 at 1e-4,
    bf16 at 2^-6, each of each tensor's largest magnitude.
(c) the RDN model against srtpu's RDN on both parameter trees through
    srtpu_torch.convert: both trees on srtpu's XLA path in f32 at x2, x3
    and x4 (1e-4), and the 'cs' tree on the interpret-mode kernel path
    at x4 in f32 (1e-4) and bf16 (2^-6 on outputs below 2).
(d) the train step (L1, Adam at lr 1e-4 and eps 1e-4, f32) over 8 steps
    against srtpu's make_train_step: the loss at every step within 1e-5
    relative, the final params within 1e-4 of each tensor's largest
    magnitude (eps 1e-4 for the reason in tests/test_torch_train.py; lr
    1e-4 is the training recipe's: at 1e-3 this small dense net's loss
    turns up after six steps, where a ReLU that flips on one side parts
    the two trajectories).
(e) ``python -m srtpu_torch predict --model RDN --device cpu`` against
    srtpu's Trainer.predict: PNGs within one uint8 level.
(f) the .npz converter for both RDN trees, through convert.main.
(g) the wrappers raise for what their kernels do not take. The configs
    srtpu's kernels do not take (config A, G != G0; widths that are not
    16-multiples) run srtpu's per-block path, held against srtpu in
    test_torch_xla_routes.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srtpu.models.rdn as jax_rdn
from srtpu.models import create_model as jax_create_model
from srtpu.ops import cs_conv
from srtpu_torch.convert import load_npz, params_from_jax
from srtpu_torch.models import create_model
from srtpu_torch.models import rdn as port_rdn
from srtpu_torch.ops import rdn as k6
from srtpu_torch.ops.layout import w_hwio_from_cs, w_t

torch.set_num_threads(1)

B, H, W = 4, 8, 8
K = 2                       # images per CS lane-row: S = 128
DTYPES = {'f32': (jnp.float32, torch.float32),
          'bf16': (jnp.bfloat16, torch.bfloat16)}
# (G0, C, D) of the K6 function tests
ARRANGEMENTS = {'g16': (16, 3, 2), 'g64': (64, 2, 1)}


def _close(got, ref, rel, what):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max(),
                               err_msg=what)


def _tol(dtype):
    return 1e-4 if dtype == 'f32' else 2.0 ** -6


def _np(t):
    return np.array(t, np.float32)


def _to_nhwc(a):
    """A CS array (G, C, S) of this file's plan -> NHWC numpy."""
    return _np(cs_conv.cs_to_nhwc(jnp.asarray(a, jnp.float32), K, H, W))


def _trunk_params(rng, g0, c, d):
    """srtpu's stored trunk parameters (CS-arranged dense weights, (D,
    G0, c_tot) fusion) at srtpu's init bounds."""
    def u(bound, *shape):
        return rng.uniform(-bound, bound, shape).astype(np.float32)
    c_tot = g0 * (c + 1)
    ws = [u((9 * g0 * (i + 1)) ** -0.5, d, 3 * g0, 3 * g0 * (i + 1))
          for i in range(c)]
    bs = [u((9 * g0 * (i + 1)) ** -0.5, d, g0) for i in range(c)]
    return ws, bs, u(c_tot ** -0.5, d, g0, c_tot), u(c_tot ** -0.5, d, g0)


def _port_ws(ws, g0):
    """srtpu's CS dense stacks -> the port's per-layer HWIO stacks."""
    return [w_hwio_from_cs(torch.from_numpy(w), g0 * (i + 1), g0)
            .contiguous() for i, w in enumerate(ws)]


def _setup(arr, dtype, seed=5):
    """Inputs of the K6 functions on both sides in ``dtype``: srtpu's
    (x_cs, wcm, b, wf, bf, wtcm, wft) and the port's (x, wpk, b, wf, bf,
    wtpk, wft), from one numpy draw."""
    g0, c, d = ARRANGEMENTS[arr]
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, H, W, g0)).astype(np.float32)
    ws, bs, wf, bf = _trunk_params(rng, g0, c, d)
    wsd = [jnp.asarray(w, jdt) for w in ws]
    jax_in = dict(x=cs_conv.nhwc_to_cs(jnp.asarray(x, jdt), K),
                  wcm=cs_conv.w_rdn_chunk_major(wsd),
                  b=jnp.stack([jnp.asarray(t) for t in bs], 1)[..., None],
                  wf=jnp.asarray(wf, jdt),
                  bf=jnp.asarray(bf)[..., None],
                  wtcm=cs_conv.w_rdn_chunks_T(wsd),
                  wft=jnp.transpose(jnp.asarray(wf, jdt), (0, 2, 1)))
    wpk = k6.pack([w.to(tdt) for w in _port_ws(ws, g0)])
    wfp = torch.from_numpy(wf).transpose(1, 2).to(tdt).contiguous()
    port_in = dict(x=torch.from_numpy(x).to(tdt), wpk=wpk,
                   b=torch.from_numpy(np.stack(bs, 1)), wf=wfp,
                   bf=torch.from_numpy(bf), wtpk=w_t(wpk).contiguous(),
                   wft=wfp.transpose(1, 2).contiguous())
    return (g0, c, d), jax_in, port_in


def _jax_fwd(j):
    return cs_conv.rdn_all_fwd(j['x'], j['wcm'], j['b'], j['wf'], j['bf'],
                               W, K)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('arr', list(ARRANGEMENTS))
def test_rdn_fwd_plain_matches_pallas(arr, dtype):
    (g0, c, d), j, p = _setup(arr, dtype)
    cat_ref, buf_ref = _jax_fwd(j)
    cat, bufs = k6.rdn_fwd_plain(p['x'], p['wpk'], p['b'], p['wf'], p['bf'],
                                 save=True)
    assert cat.dtype == bufs.dtype == DTYPES[dtype][1]
    _close(cat.float().numpy(), _to_nhwc(cat_ref), _tol(dtype), 'cat')
    for l in range(d):
        _close(bufs[l].float().numpy(), _to_nhwc(buf_ref[l]), _tol(dtype),
               f'buf {l}')
    # without saving, one buffer serves every block: the same cat
    torch.testing.assert_close(
        k6.rdn_fwd_plain(p['x'], p['wpk'], p['b'], p['wf'], p['bf']), cat,
        rtol=0, atol=0)


def _cotangents(rng, g0, d, tdt, jdt):
    g = rng.uniform(-1, 1, (B, H, W, g0)).astype(np.float32)
    ct = rng.uniform(-1, 1, (B, H, W, d * g0)).astype(np.float32)
    ct *= np.arange(1, d * g0 + 1, dtype=np.float32) / (d * g0)
    return ((cs_conv.nhwc_to_cs(jnp.asarray(g, jdt), K),
             cs_conv.nhwc_to_cs(jnp.asarray(ct, jdt), K)),
            (torch.from_numpy(g).to(tdt), torch.from_numpy(ct).to(tdt)))


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('arr', list(ARRANGEMENTS))
def test_rdb_bwd_chain_plain_matches_pallas(arr, dtype):
    """Every block's chain from the same saved buffers (srtpu's), the
    running g and an asymmetric cat cotangent (test_ops_cs.py:1212)."""
    (g0, c, d), j, p = _setup(arr, dtype)
    jdt, tdt = DTYPES[dtype]
    _, buf_all = _jax_fwd(j)
    bufs = torch.stack([torch.from_numpy(_to_nhwc(buf_all[l])).to(tdt)
                        for l in range(d)])
    (g_j, ct_j), (g_t, ct_t) = _cotangents(np.random.default_rng(9), g0, d,
                                           tdt, jdt)
    tol = _tol(dtype)
    for l in reversed(range(d)):
        dx_r, dout_r, dwf_r, dbf_r, db_r = cs_conv.rdb_bwd_chain_all(
            buf_all, l, g_j, ct_j, j['wtcm'], j['wft'], W, K, c)
        dx, dout, dwf, dbf, db = k6.rdb_bwd_chain_plain(
            bufs, l, g_t, ct_t, p['wtpk'], p['wft'])
        assert dx.dtype == dout.dtype == tdt
        assert dwf.dtype == dbf.dtype == db.dtype == torch.float32
        _close(dx.float().numpy(), _to_nhwc(dx_r), tol, f'dx {l}')
        _close(dout.float().numpy(), _to_nhwc(dout_r), tol, f'dout {l}')
        _close(dwf.numpy(), _np(dwf_r).T, tol, f'dwf {l}')
        _close(dbf.numpy(), _np(dbf_r)[:, 0], tol, f'dbf {l}')
        _close(db.numpy(), _np(db_r)[..., 0], tol, f'db {l}')
        g_j, g_t = dx_r, torch.from_numpy(_to_nhwc(dx_r)).to(tdt)


def _pairs_to_port(dwt, g0):
    """srtpu's pair grads (n_pairs, 3, G, 3 G0) [dy, c_out, (dx, c_in)]
    -> the port's (n_pairs, 3, 3, G0, G) HWIO pairs."""
    n = dwt.shape[0]
    return _np(dwt).reshape(n, 3, g0, 3, g0).transpose(0, 1, 3, 4, 2)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('arr', list(ARRANGEMENTS))
def test_rdb_bwd_dw_plain_matches_pallas(arr, dtype):
    (g0, c, d), j, _ = _setup(arr, dtype)
    jdt, tdt = DTYPES[dtype]
    _, buf_all = _jax_fwd(j)
    bufs = torch.stack([torch.from_numpy(_to_nhwc(buf_all[l])).to(tdt)
                        for l in range(d)])
    rng = np.random.default_rng(11)
    dout = rng.uniform(-1, 1, (B, H, W, c * g0)).astype(np.float32)
    dout_j = cs_conv.nhwc_to_cs(jnp.asarray(dout, jdt), K)
    dout_t = torch.from_numpy(dout).to(tdt)
    pairs = [(i, jj) for i in range(c) for jj in range(i + 1)]
    for l in range(d):
        ref = cs_conv.rdb_bwd_dw_all(buf_all, l, dout_j, pairs, W, K, g0)
        got = k6.rdb_bwd_dw_plain(bufs, l, dout_t)
        assert got.dtype == torch.float32
        _close(got.numpy(), _pairs_to_port(ref, g0), _tol(dtype), f'dW {l}')


def test_pack_roundtrip_and_chunk_major_order():
    """pack / unpack are inverse, and pack's pair order is srtpu's
    w_rdn_chunk_major's (layer-major, then input chunk)."""
    (g0, c, d), j, p = _setup('g16', 'f32')
    ws = k6.unpack(p['wpk'], c)
    assert [tuple(w.shape) for w in ws] == [
        (d, 3, 3, g0 * (i + 1), g0) for i in range(c)]
    torch.testing.assert_close(k6.pack(ws), p['wpk'], rtol=0, atol=0)
    # srtpu's chunk-major columns (pair, dx, c_local) per row (dy, c_out)
    wcm = _np(j['wcm']).reshape(d, 3, g0, k6.n_pairs(c), 3, g0)
    torch.testing.assert_close(
        torch.from_numpy(wcm.transpose(0, 3, 1, 4, 5, 2).copy()), p['wpk'],
        rtol=0, atol=0)


# ------------------------------------------------------- (b) the trunk op

@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('arr', list(ARRANGEMENTS))
def test_rdn_trunk_fn_matches_jax_grad(arr, dtype):
    g0, c, d = ARRANGEMENTS[arr]
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(33)
    x = rng.standard_normal((B, H, W, g0)).astype(np.float32)
    ws, bs, wf, bf = _trunk_params(rng, g0, c, d)
    row_w = np.arange(1, d * g0 + 1, dtype=np.float32)

    def f_jax(x_cs, ws_, bs_, wf_, bf_):
        cat = cs_conv.rdn_trunk_cat_cs(x_cs, ws_, bs_, wf_, bf_, W, K)
        return jnp.sum(jnp.sin(cat.astype(jnp.float32))
                       * row_w[None, :, None])

    args = (cs_conv.nhwc_to_cs(jnp.asarray(x, jdt), K),
            tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)),
            jnp.asarray(wf), jnp.asarray(bf))
    v_ref, g_ref = jax.value_and_grad(f_jax, argnums=(0, 1, 2, 3, 4))(*args)

    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    wst = [w.requires_grad_() for w in _port_ws(ws, g0)]
    bst = [torch.from_numpy(b).requires_grad_() for b in bs]
    wft = torch.from_numpy(wf).transpose(1, 2).contiguous().requires_grad_()
    bft = torch.from_numpy(bf).requires_grad_()
    cat = k6.rdn_trunk(xt, wst, bst, wft, bft)
    assert cat.dtype == tdt and cat.shape == (B, H, W, d * g0)
    v = (torch.sin(cat.float()) * torch.from_numpy(row_w)).sum()
    v.backward()
    tol = _tol(dtype)
    np.testing.assert_allclose(v.item(), float(v_ref), rtol=tol)
    _close(xt.grad.float().numpy(), _to_nhwc(g_ref[0]), tol, 'dx')
    for i in range(c):
        assert wst[i].grad.dtype == bst[i].grad.dtype == torch.float32
        _close(wst[i].grad.numpy(), w_hwio_from_cs(
            torch.from_numpy(_np(g_ref[1][i])), g0 * (i + 1), g0).numpy(),
            tol, f'dense{i} weight')
        _close(bst[i].grad.numpy(), _np(g_ref[2][i]), tol, f'dense{i} bias')
    _close(wft.grad.numpy(), _np(g_ref[3]).transpose(0, 2, 1), tol, 'lff w')
    _close(bft.grad.numpy(), _np(g_ref[4]), tol, 'lff b')
    # no gradient wanted: the forward alone, one shared buffer
    with torch.no_grad():
        torch.testing.assert_close(k6.rdn_trunk(xt, wst, bst, wft, bft), cat,
                                   rtol=0, atol=0)


# ------------------------------------------------------------- (c) model

CFG = dict(rdn_config='T', growth0=16)


@pytest.fixture
def tiny(monkeypatch):
    """Config 'T' (2 blocks of 3 layers, G = 16) in both packages."""
    monkeypatch.setitem(jax_rdn.RDN_CONFIGS, 'T', (2, 3, 16))
    monkeypatch.setitem(port_rdn.RDN_CONFIGS, 'T', (2, 3, 16))


def _tree_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _jax_model(scale, use_pallas='cs', dtype=None):
    return jax_create_model('RDN', scale_factor=scale, use_pallas=use_pallas,
                            dtype=dtype, **CFG)


def _port(scale, params, dtype=None):
    model = create_model('RDN', scale_factor=scale, dtype=dtype,
                         generator=torch.Generator().manual_seed(0), **CFG)
    model.load_state_dict(params_from_jax(_tree_np(params)))
    return model


def _port_out(model, x):
    with torch.inference_mode():
        return model(torch.from_numpy(x)).float().numpy()


@pytest.mark.parametrize('use_pallas', ['cs', False])
@pytest.mark.parametrize('scale', [2, 3, 4])
def test_rdn_matches_jax_xla_path(tiny, scale, use_pallas):
    """srtpu on the CPU takes its XLA trunk ('cs' tree: the same stored
    parameters through XLA convs; False: the per-block modules)."""
    x = np.random.default_rng(scale).random((2, 6, 7, 3), np.float32)
    m = _jax_model(scale, use_pallas)
    params = m.init(jax.random.PRNGKey(scale), jnp.asarray(x))
    ref = np.asarray(m.apply(params, jnp.asarray(x)))
    got = _port_out(_port(scale, params), x)
    assert got.shape == ref.shape == (2, 6 * scale, 7 * scale, 3)
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_rdn_matches_jax_pallas_interpret(tiny, monkeypatch, dtype):
    """x4 at (2, 8, 8): srtpu's trunk takes K6 and K2 (checked through
    cs_conv.PATH_LOG), run in interpret mode."""
    monkeypatch.setenv('SRTPU_CS_OFF_TPU', '1')
    jdt, tdt = {'f32': (None, None),
                'bf16': (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = np.random.default_rng(0).random((2, 8, 8, 3), np.float32)
    m = _jax_model(4, dtype=jdt)
    params = m.init(jax.random.PRNGKey(1), jnp.asarray(x))
    cs_conv.PATH_LOG.clear()
    ref = np.asarray(m.apply(params, jnp.asarray(x)).astype(jnp.float32))
    assert cs_conv.PATH_LOG == {('CSRDNTrunk', (2, 8, 8, 16)): 'cs'}
    got = _port_out(_port(4, params, tdt), x)
    atol = 1e-4 if dtype == 'f32' else 2.0 ** -6
    assert np.abs(ref).max() < 2
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


# -------------------------------------------------------- (d) train step

OPT = ['lr=1e-4', 'eps=1e-4']


def test_train_step_matches_srtpu(tiny):
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


# ----------------------------------------------------------- (e) predict

def test_predict_cli_matches_srtpu_trainer(tiny, tmp_path):
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
        'predict', '--model', 'RDN', '--weights', str(tmp_path / 'w.pt'),
        '--rdn_config', 'T', '--growth0', '16', '--datasets_dir',
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


# --------------------------------------------------------- (f) converter

@pytest.mark.parametrize('use_pallas', ['cs', False])
def test_convert_npz_roundtrip(tiny, tmp_path, use_pallas):
    """A flat .npz as a JAX host writes it converts, through
    convert.main, to the same state dict as the tree itself, which loads
    into the port's RDN with every parameter filled."""
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
    assert model.load_state_dict(
        torch.load(tmp_path / 'p.pt', weights_only=True)) is not None
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(params))
    assert n_jax == sum(p.numel() for p in model.parameters())


# ---------------------------------------------------------- (g) refusals

def test_rdn_scales_and_wrappers_refuse():
    """x8 is no RDN scale; the K6 wrappers raise for a tensor the kernels
    cannot take (no fallback: a CUDA tensor launches or raises)."""
    with pytest.raises(ValueError, match='scale'):
        create_model('RDN', scale_factor=8, generator=torch.Generator())
    assert port_rdn.RDN.CARD_SCALES == (2, 3, 4)
    (g0, c, d), _, p = _setup('g64', 'f32')
    meta = {k: v.to('meta') for k, v in p.items()}
    with pytest.raises(ValueError, match='no kernel'):
        k6.rdn_fwd(meta['x'], meta['wpk'], meta['b'], meta['wf'], meta['bf'])
    bufs = torch.empty((d, B, H, W, g0 * (c + 1)), device='meta')
    g = torch.empty((B, H, W, g0), device='meta')
    with pytest.raises(ValueError, match='no kernel'):
        k6.rdb_bwd_chain(bufs, 0, g, g, meta['wtpk'], meta['wft'])
    with pytest.raises(ValueError, match='no kernel'):
        k6.rdb_bwd_dw(bufs, 0, torch.empty((B, H, W, c * g0), device='meta'))
