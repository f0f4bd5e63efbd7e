"""The port's per-block 'calls' RDN trunk (``ops.rdn.rdn_trunk_calls``)
against srtpu's ``rdn_trunk_cs2`` (the trunk srtpu's RDN takes with
``cs_conv._RDN_FWD = 'calls'``) on the CPU, and against the port's grid
trunk (``ops.rdn_trunk``, which its RDN runs).

srtpu's kernels run as its own tests run them off the TPU:
SRTPU_CS_OFF_TPU=1 and Pallas in interpret mode, at srtpu's test sizes
(test_ops_cs.py:364-406: batch 4 of 8x8, G0 16, D 2 blocks of C 3
layers). The D block outputs, dx and every trunk gradient (each dense
layer's weight and bias, the fusions'): f32 within 1e-4 of the largest
magnitude (gradients at least 2e-3 absolute, srtpu's own tolerance,
test_ops_cs.py:659-670), bf16 within 2^-6 (both sides round at the same
points, the block cotangent bf16(f32(g) + f32(ct_l)) included, so a
value next to a rounding boundary lands a step apart). That limit is
wider than the one rounding only this form has, so in bf16 at least 85%
of dx's values must also equal srtpu's bit for bit: 89.7% here, 71.2%
with the block cotangent left unrounded as the grid form leaves it.
The forward equals the grid form's bit for bit (the same roundings).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srtpu.ops import cs_conv
from srtpu_torch.ops import rdn as k6
from srtpu_torch.ops.layout import w_hwio_from_cs

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


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_rdn_calls_matches_srtpu(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(32)
    b, h, w, g0, c, d = 4, 8, 8, 16, 3, 2
    x = rng.standard_normal((b, h, w, g0)).astype(np.float32)

    def mk(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    whs = [mk(d, 3, 3, g0 * (i + 1), g0) for i in range(c)]
    bs = [mk(d, g0) for _ in range(c)]
    wf = mk(d, g0, g0 * (c + 1))
    bf = mk(d, g0)
    k, _ = cs_conv.cs_plan(x.shape)

    def f_jax(*a):
        outs = cs_conv.rdn_trunk_cs2(*a, w, k)
        return sum(jnp.sum(jnp.sin(o.astype(jnp.float32) * (j + 1)))
                   for j, o in enumerate(outs)), outs

    (v_ref, outs_ref), g_ref = jax.jit(jax.value_and_grad(
        f_jax, argnums=(0, 1, 2, 3, 4), has_aux=True))(
            cs_conv.nhwc_to_cs(jnp.asarray(x, jdt), k),
            tuple(cs_conv.w_cs_batch(jnp.asarray(a)) for a in whs),
            tuple(map(jnp.asarray, bs)), jnp.asarray(wf), jnp.asarray(bf))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    ws = [torch.from_numpy(a).requires_grad_() for a in whs]
    bst = [torch.from_numpy(a).requires_grad_() for a in bs]
    wft = torch.from_numpy(wf).transpose(1, 2).contiguous().requires_grad_()
    bft = torch.from_numpy(bf).requires_grad_()
    outs = k6.rdn_trunk_calls(xt, ws, bst, wft, bft)
    assert len(outs) == d
    v = sum((torch.sin(o.float() * (j + 1))).sum()
            for j, o in enumerate(outs))
    v.backward()
    np.testing.assert_allclose(v.item(), float(v_ref),
                               rtol=1e-4 if dtype == 'f32' else 2.0 ** -6)
    for j, (o, r) in enumerate(zip(outs, outs_ref)):
        assert o.dtype == tdt
        _close(o, cs_conv.cs_to_nhwc(r.astype(jnp.float32), k, h, w), dtype,
               f'block {j}')
    dx_ref = cs_conv.cs_to_nhwc(g_ref[0].astype(jnp.float32), k, h, w)
    _close(xt.grad, dx_ref, dtype, 'dx', grad=True)
    if dtype == 'bf16':     # the rounding only this form has, witnessed
        same = (_np(xt.grad) == _np(dx_ref)).mean()
        assert same >= 0.85, same
    for i, (t, r) in enumerate(zip(ws, g_ref[1])):
        assert t.grad.dtype == torch.float32
        _close(t.grad, w_hwio_from_cs(torch.from_numpy(_np(r)),
                                      g0 * (i + 1), g0), dtype,
               f'dense{i} weight', grad=True)
    for i, (t, r) in enumerate(zip(bst, g_ref[2])):
        _close(t.grad, r, dtype, f'dense{i} bias', grad=True)
    _close(wft.grad, _np(g_ref[3]).transpose(0, 2, 1), dtype, 'lff weight',
           grad=True)
    _close(bft.grad, g_ref[4], dtype, 'lff bias', grad=True)
    # the forward alone, and the grid form on the same parameters: the
    # same bits
    with torch.no_grad():
        alone = k6.rdn_trunk_calls(xt, ws, bst, wft, bft)
        grid = k6.rdn_trunk(xt, ws, bst, wft, bft)
    for a, o in zip(alone, outs):
        torch.testing.assert_close(a, o.detach(), rtol=0, atol=0)
    torch.testing.assert_close(grid, torch.cat(alone, -1), rtol=0, atol=0)
