"""srtpu's other trunk forms in the port, against srtpu on the CPU: RDN's
per-block 'calls' trunk and its round-2 per-layer trunk, EDSR's trunk
past srtpu's mega budget, one CS resblock on HWIO weights, the fused
NHWC resblock with its fused backward (K8a + K9d), and EDSR past 96
features (F10: srtpu's XLA trunk and tail).

srtpu's kernels run as its own tests run them off the TPU:
SRTPU_CS_OFF_TPU=1 and Pallas in interpret mode. Sizes are srtpu's test
sizes (tests/test_ops_cs.py:364-406, :130-160, :835): C or G0 16, batch
4 (the models 2), 8x8, D 2 blocks of C 3 layers. Tolerances, each of a
tensor's largest magnitude unless said: f32 1e-4 (the same products
summed in another order), gradients at least 2e-3 absolute (srtpu's
own, test_ops_cs.py:659-670); bf16 2^-6 (both sides round at the same
points, so a value next to a rounding boundary lands a step apart, and
what reads it moves by a step more).

(a) RDN's 'calls' trunk: tests/test_torch_rdn_calls.py (in interpret
    mode it takes a file of its own to keep each under a minute).
(b) ``rdn_trunk_layers`` against ``rdn_trunk_cs``: the D block outputs
    and every gradient, f32 and bf16 (in bf16 through srtpu's roundings:
    the fusion a bf16 product, its bias and the adds in bf16, the
    backward's dbuf a bf16 product with the layers' dx added in bf16).
(c) EDSR's ``Trunk`` against srtpu's ``CSTrunk`` past its budget
    (``_MEGA_ACC_BUDGET`` patched to 0, as test_ops_cs.py:835 does, so
    srtpu takes ``trunk_cs``): values, dx and every parameter's
    gradient; the port's one route (K1's wrappers, once each way)
    computes that form too; the width gate srtpu's.
(d) ``resblock_cs`` (K1 at L = 1) against srtpu's: values and grads,
    the weight grads in the weights' dtype (f32 or bf16), the bias grads
    f32.
(e) ``resblock_fused_v3``'s plain path against ``jax.grad`` of srtpu's
    ``resblock_fused_v3`` (f32 weights cast as srtpu's models cast them),
    at res_scale 0.8 and 0.1; in bf16 the weight grads hold bf16 values.
(f) F10: EDSR at 128 features (past srtpu's 96) runs no kernel op of the
    port, and matches srtpu's bf16 forward where both round at the same
    points: at most 1% of the SR values a step apart and a mean |Δ| below
    2^-14. Before the repair the port ran K1's math (h1 rounded to bf16
    every block) and K2 / K3's plain versions there: 6.4% (x4) and 9.2%
    (x2) of the values apart, mean |Δ| 1.3e-4 and 2.0e-4.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srtpu.models.common as jax_common
from srtpu.models import create_model as jax_create_model
from srtpu.ops import cs_conv
from srtpu.ops import resblock as jrb
from srtpu_torch.convert import params_from_jax
from srtpu_torch.models import common as port_common
from srtpu_torch.models import create_model
from srtpu_torch.ops import rdn as k6
from srtpu_torch.ops import resblock as k8a
from srtpu_torch.ops.layout import w_hwio_from_cs

# the module (the package's ``trunk`` is the op)
k1 = importlib.import_module('srtpu_torch.ops.trunk')

torch.set_num_threads(1)

DTYPES = {'f32': (jnp.float32, torch.float32),
          'bf16': (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def cs_kernels_interpret(monkeypatch):
    """srtpu's CS kernels in interpret mode on the CPU (its own tests'
    fixture, test_ops_cs.py:19)."""
    monkeypatch.setenv('SRTPU_CS_OFF_TPU', '1')


def _np(t):
    return np.array(t.detach().float() if torch.is_tensor(t) else t,
                    np.float32)


def _close(got, ref, dtype, what, grad=False):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    atol = (2.0 ** -6 if dtype == 'bf16' else 1e-4) * np.abs(ref).max()
    if grad and dtype == 'f32':
        atol = max(atol, 2e-3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=what)


def _tree_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _port_model(name, params, **kw):
    model = create_model(name, generator=torch.Generator().manual_seed(0),
                         **kw)
    model.load_state_dict(params_from_jax(_tree_np(params)))
    return model


# ------------------------------------------- (b) the round-2 trunk

def _rdn_trunk_data(dtype):
    """srtpu's test_rdn_trunk_cs_matches_xla inputs (B 4, 8x8, G0 16, C 3,
    D 2): srtpu's CS operands and the port's."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(31)
    b, h, w, g0, c, d = 4, 8, 8, 16, 3, 2
    x = rng.standard_normal((b, h, w, g0)).astype(np.float32)

    def mk(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    whs = [mk(d, 3, 3, g0 * (i + 1), g0) for i in range(c)]
    bs = [mk(d, g0) for _ in range(c)]
    wf = mk(d, g0, g0 * (c + 1))
    bf = mk(d, g0)
    k, _ = cs_conv.cs_plan(x.shape)
    jax_in = (cs_conv.nhwc_to_cs(jnp.asarray(x, jdt), k),
              tuple(cs_conv.w_cs_batch(jnp.asarray(a)) for a in whs),
              tuple(map(jnp.asarray, bs)), jnp.asarray(wf), jnp.asarray(bf))
    port_in = (torch.from_numpy(x).to(tdt),
               [torch.from_numpy(a) for a in whs],
               [torch.from_numpy(a) for a in bs],
               torch.from_numpy(wf).transpose(1, 2).contiguous(),
               torch.from_numpy(bf))
    return (h, w, k, d), jax_in, port_in


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_rdn_trunk_layers_matches_rdn_trunk_cs(dtype):
    (h, w, k, d), jin, pin = _rdn_trunk_data(dtype)

    def f_jax(*a):
        outs = cs_conv.rdn_trunk_cs(*a, w, k)
        return sum(jnp.sum(jnp.sin(o.astype(jnp.float32) * (j + 1)))
                   for j, o in enumerate(outs)), outs

    (v_ref, outs_ref), g_ref = jax.jit(jax.value_and_grad(
        f_jax, argnums=(0, 1, 2, 3, 4), has_aux=True))(*jin)
    x, ws, bs, wf, bf = pin
    for t in (x, *ws, *bs, wf, bf):
        t.requires_grad_()
    outs = k6.rdn_trunk_layers(x, ws, bs, wf, bf)
    assert len(outs) == d
    v = sum((torch.sin(o.float() * (j + 1))).sum()
            for j, o in enumerate(outs))
    v.backward()
    np.testing.assert_allclose(v.item(), float(v_ref),
                               rtol=1e-4 if dtype == 'f32' else 2.0 ** -6)
    for j, (o, r) in enumerate(zip(outs, outs_ref)):
        assert o.dtype == x.dtype
        _close(o, cs_conv.cs_to_nhwc(r.astype(jnp.float32), k, h, w), dtype,
               f'block {j}')
    _close(x.grad, cs_conv.cs_to_nhwc(g_ref[0].astype(jnp.float32), k, h, w),
           dtype, 'dx', grad=True)
    for i, (t, r) in enumerate(zip(ws, g_ref[1])):
        assert t.grad.dtype == torch.float32
        _close(t.grad, w_hwio_from_cs(torch.from_numpy(_np(r)),
                                      16 * (i + 1), 16), dtype,
               f'dense{i} weight', grad=True)
    for i, (t, r) in enumerate(zip(bs, g_ref[2])):
        _close(t.grad, r, dtype, f'dense{i} bias', grad=True)
    _close(wf.grad, _np(g_ref[3]).transpose(0, 2, 1), dtype, 'lff weight',
           grad=True)
    _close(bf.grad, g_ref[4], dtype, 'lff bias', grad=True)
    with torch.no_grad():       # the forward alone: the same outputs
        for a, b in zip(k6.rdn_trunk_layers(x, ws, bs, wf, bf), outs):
            torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)


# ------------------------------------- (c) EDSR's trunk past the budget

def _spy(fn, calls, key):
    def wrapped(*a, **kw):
        calls[key] = calls.get(key, 0) + 1
        return fn(*a, **kw)
    return wrapped


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_trunk_past_budget_matches_srtpu_trunk_cs(monkeypatch, dtype):
    """srtpu's CSTrunk (test_ops_cs.py:835's: 16 features, 2 blocks, x
    (2, 8, 8, 16)) and the port's Trunk on its converted parameters."""
    monkeypatch.setattr(jax_common, '_MEGA_ACC_BUDGET', 0)
    calls = {}
    for name in ('trunk_fwd', 'trunk_bwd'):
        monkeypatch.setattr(k1, name, _spy(getattr(k1, name), calls, name))
    used = []
    real = cs_conv.trunk_cs
    monkeypatch.setattr(cs_conv, 'trunk_cs',
                        lambda *a, **kw: used.append(1) or real(*a, **kw))
    jdt, tdt = DTYPES[dtype]
    n, nb, rs = 16, 2, 0.3
    x = np.random.default_rng(1).random((2, 8, 8, n), np.float32)
    m = jax_common.CSTrunk(n_feats=n, n_resblocks=nb, res_scale=rs,
                           dtype=jdt)
    params = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    row_w = np.arange(1, n + 1, dtype=np.float32) / n

    def loss(xx, p):
        y = m.apply(p, xx).astype(jnp.float32)
        return jnp.sum(jnp.sin(y) * row_w), y

    (v_ref, y_ref), (gx_ref, gp_ref) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jnp.asarray(x), params)
    assert used, "srtpu's CSTrunk did not take trunk_cs"
    port = port_common.Trunk(n, nb, rs, generator=torch.Generator())
    assert not port.xla
    tp = _tree_np(params)['params']
    with torch.no_grad():
        for name in ('w1', 'w2'):
            getattr(port, name).copy_(
                w_hwio_from_cs(torch.from_numpy(tp[name]), n, n))
        for name in ('b1', 'b2'):
            getattr(port, name).copy_(torch.from_numpy(tp[name]))
        port.close_weight.copy_(torch.from_numpy(tp['close_kernel']))
        port.close_bias.copy_(torch.from_numpy(tp['close_bias']))
    xt = torch.from_numpy(x).requires_grad_()
    y = port(xt, tdt)
    assert y.dtype == tdt
    v = (torch.sin(y.float()) * torch.from_numpy(row_w)).sum()
    v.backward()
    np.testing.assert_allclose(v.item(), float(v_ref),
                               rtol=1e-4 if dtype == 'f32' else 2.0 ** -6)
    _close(y, y_ref, dtype, 'out')
    _close(xt.grad, gx_ref, dtype, 'dx', grad=True)
    gp = _tree_np(gp_ref)['params']
    refs = {'w1': w_hwio_from_cs(torch.from_numpy(gp['w1']), n, n),
            'w2': w_hwio_from_cs(torch.from_numpy(gp['w2']), n, n),
            'b1': gp['b1'], 'b2': gp['b2'],
            'close_weight': gp['close_kernel'],
            'close_bias': gp['close_bias']}
    for name, prm in port.named_parameters():
        assert prm.grad.dtype == torch.float32
        _close(prm.grad, refs[name], dtype, f'grad {name}', grad=True)
    # the port's one route: K1's wrappers, each direction once
    assert calls == {'trunk_fwd': 1, 'trunk_bwd': 1}


def test_trunk_route_is_srtpus():
    """srtpu's width gate: its CS kernels up to 96 features, XLA past
    them, the port's kernels and stock ops likewise. EDSR at 64 features
    leaves srtpu's mega form at 86 blocks (2 L (3C)^2 f32 accumulators
    past 24 MiB), where the port keeps K1: test (c) holds the two."""
    assert port_common.CS_MAX_FEATS == 96
    assert [port_common.Trunk(n, 1, generator=torch.Generator()).xla
            for n in (64, 96, 97, 256)] == [False, False, True, True]
    acc = [2 * nb * (3 * 64) ** 2 * 4 for nb in (85, 86)]
    assert acc[0] <= jax_common._MEGA_ACC_BUDGET < acc[1]


# ----------------------------------------------- (d) resblock_cs (K9a)

@pytest.mark.parametrize('wdt', ['f32', 'bf16'])
@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_resblock_cs_matches_srtpu(monkeypatch, dtype, wdt):
    """srtpu's test data (test_ops_cs.py:28-37); the weights in ``wdt``;
    the op runs K1's wrappers, once each way."""
    calls = {}
    for name in ('trunk_fwd', 'trunk_bwd'):
        monkeypatch.setattr(k1, name, _spy(getattr(k1, name), calls, name))
    jdt, tdt = DTYPES[dtype]
    wj, wt = DTYPES[wdt]
    rng = np.random.default_rng(7)
    b, h, w, c = 4, 8, 8, 16
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    prm = [(rng.standard_normal(s) * 0.1).astype(np.float32)
           for s in ((3, 3, c, c), (c,), (3, 3, c, c), (c,))]
    k, _ = cs_conv.cs_plan(x.shape)
    rs = 0.7
    row_w = np.arange(1, c + 1, dtype=np.float32) / c

    def f_jax(xc, w1, b1, w2, b2):
        y = cs_conv.resblock_cs(xc, w1, b1, w2, b2, rs, w, k)
        y = cs_conv.cs_to_nhwc(y.astype(jnp.float32), k, h, w)
        return jnp.sum(jnp.sin(y) * row_w), y

    jw = [jnp.asarray(a, wj if i % 2 == 0 else jnp.float32)
          for i, a in enumerate(prm)]
    (v_ref, y_ref), g_ref = jax.jit(jax.value_and_grad(
        f_jax, argnums=(0, 1, 2, 3, 4), has_aux=True))(
            cs_conv.nhwc_to_cs(jnp.asarray(x, jdt), k), *jw)
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    pt = [torch.from_numpy(a).to(wt if i % 2 == 0 else torch.float32)
          .requires_grad_() for i, a in enumerate(prm)]
    y = k1.resblock_cs(xt, *pt, rs)
    assert y.dtype == tdt
    v = (torch.sin(y.float()) * torch.from_numpy(row_w)).sum()
    v.backward()
    _close(y, y_ref, dtype, 'out')
    _close(xt.grad, cs_conv.cs_to_nhwc(g_ref[0].astype(jnp.float32), k, h,
                                       w), dtype, 'dx', grad=True)
    for i, (t, r) in enumerate(zip(pt, g_ref[1:])):
        assert t.grad.dtype == t.dtype and r.dtype == jnp.dtype(
            t.dtype == torch.bfloat16 and jnp.bfloat16 or jnp.float32)
        _close(t.grad, r, dtype if wdt == 'f32' else 'bf16', f'param {i}',
               grad=True)
    assert calls == {'trunk_fwd': 1, 'trunk_bwd': 1}


# ------------------------------------ (e) resblock_fused_v3 (K8a + K9d)

@pytest.mark.parametrize('res_scale', [0.8, 0.1])
@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_resblock_fused_v3_matches_jax_grad(dtype, res_scale):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(6)
    b, h, w, c = 2, 8, 8, 16
    x = (rng.standard_normal((b, h, w, c)) * 0.5).astype(np.float32)
    cb = (9 * c) ** -0.5
    prm = [rng.uniform(-cb, cb, s).astype(np.float32)
           for s in ((3, 3, c, c), (c,), (3, 3, c, c), (c,))]
    row_w = np.arange(1, c + 1, dtype=np.float32) / c

    def loss(xx, w1, b1, w2, b2):
        y = jrb.resblock_fused_v3(xx, w1.astype(jdt), b1, w2.astype(jdt),
                                  b2, res_scale)
        return jnp.sum(jnp.sin(y.astype(jnp.float32)) * row_w)

    v_ref, g_ref = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3,
                                                            4)))(
        jnp.asarray(x, jdt), *map(jnp.asarray, prm))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    pt = [torch.from_numpy(a).requires_grad_() for a in prm]
    y = k8a.resblock_fused_v3(xt, *pt, res_scale)
    assert y.dtype == tdt
    v = (torch.sin(y.float()) * torch.from_numpy(row_w)).sum()
    v.backward()
    np.testing.assert_allclose(v.item(), float(v_ref),
                               rtol=1e-4 if dtype == 'f32' else 2.0 ** -6)
    _close(xt.grad, g_ref[0], dtype, 'dx', grad=True)
    for i, (t, r) in enumerate(zip(pt, g_ref[1:])):
        assert t.grad.dtype == torch.float32
        _close(t.grad, r, dtype, f'param {i}', grad=True)
    if dtype == 'bf16':     # weight grads bf16 values, bias grads not
        for i, t in enumerate(pt):
            rounded = torch.equal(t.grad, t.grad.bfloat16().float())
            assert rounded if i % 2 == 0 else not rounded


# ---------------------------------------------- (f) F10: past 96 features

def _boom(*a, **kw):
    raise AssertionError('a kernel op of the port ran past 96 features')


@pytest.mark.parametrize('scale', [4, 2])
def test_edsr_past_96_features_is_srtpus_xla_path(monkeypatch, scale):
    for name in ('trunk', 'conv3x3', 'upsample'):
        monkeypatch.setattr(port_common, name, _boom)
    x = np.random.default_rng(0).random((2, 8, 8, 3), np.float32)
    kw = dict(scale_factor=scale, n_feats=128, n_resblocks=2, res_scale=0.1)
    m = jax_create_model('EDSR', dtype=jnp.bfloat16, **kw)
    params = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
    cs_conv.PATH_LOG.clear()
    ref = np.asarray(m.apply(params, jnp.asarray(x)).astype(jnp.float32))
    assert set(cs_conv.PATH_LOG.values()) == {'xla'}
    port = _port_model('EDSR', params, dtype=torch.bfloat16, **kw)
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).float().numpy()
    assert got.shape == ref.shape == (2, 8 * scale, 8 * scale, 3)
    diff = np.abs(got - ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2.0 ** -6 * np.abs(ref).max())
    assert (diff > 0).mean() <= 0.01, (diff > 0).mean()
    assert diff.mean() <= 2.0 ** -14, diff.mean()
