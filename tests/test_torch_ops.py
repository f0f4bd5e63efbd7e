"""srtpu_torch.ops against srtpu.ops.cs_conv on the CPU.

(a) each NHWC/HWIO layout helper against its cs_conv counterpart;
(b) each kernel's plain PyTorch version against the JAX Pallas kernel it
replaces, run in interpret mode (as tests/test_ops_cs.py runs them), with
inputs and outputs through nhwc_to_cs / cs_to_nhwc;
(c) each plain backward against ``jax.vjp`` of the same Pallas kernels,
gradients through cs_to_nhwc / w_hwio_from_cs / w_ps_hwio;
(d) each autograd op against torch autograd of the plain forward.

Tolerances: f32 cases 1e-4 abs, as test_ops_cs.py uses — both sides sum
the same f32 products in another order. The bf16 case allows one bf16
rounding step at the output's largest magnitude (2^-7 * max|ref|): both
sides round at the same points, so only a sum that lands next to a bf16
rounding boundary can come out one step apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srtpu.models.common import pixel_shuffle as jax_pixel_shuffle
from srtpu.ops import cs_conv
from srtpu_torch.ops import conv3x3_plain, trunk_plain, upsample_plain
from srtpu_torch.ops import layout

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def cs_kernels_interpret(monkeypatch):
    monkeypatch.setenv('SRTPU_CS_OFF_TPU', '1')


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _np(t):
    return np.array(t, dtype=np.float32)


# ---------------------------------------------------------------- (a) layout

@pytest.mark.parametrize('c_in,c_out,kk', [(16, 16, 3), (16, 3, 3),
                                           (8, 4, 5)])
def test_w_hwio_from_cs(c_in, c_out, kk):
    w = _rand(np.random.default_rng(0), 2, kk * c_out, kk * c_in)
    ref = cs_conv.w_hwio_from_cs(jnp.asarray(w), c_in, c_out, kk)
    got = layout.w_hwio_from_cs(torch.from_numpy(w), c_in, c_out, kk)
    np.testing.assert_array_equal(got.numpy(), _np(ref))


@pytest.mark.parametrize('r', [2, 3])
def test_w_ps_and_pm_hwio(r):
    c = 8
    w = _rand(np.random.default_rng(1), r * r, 3 * c, 3 * c)
    ps = layout.w_ps_hwio(torch.from_numpy(w), c, r)
    np.testing.assert_array_equal(
        ps.numpy(), _np(cs_conv.w_ps_hwio(jnp.asarray(w), c, r)))
    np.testing.assert_array_equal(
        layout.w_pm_hwio(ps, r).numpy(),
        _np(cs_conv.w_pm_hwio(jnp.asarray(w), c, r)))


@pytest.mark.parametrize('r', [2, 3])
def test_b_pm_matches_stored_phase_major_bias(r):
    """srtpu stores the upscale bias phase-major: (r*r, C) =
    torch_order.reshape(C, r*r).T (tests/test_ops_cs.py graft)."""
    b = _rand(np.random.default_rng(2), 8 * r * r)
    ref = jnp.asarray(b).reshape(8, r * r).T.reshape(-1)
    np.testing.assert_array_equal(
        layout.b_pm(torch.from_numpy(b), r).numpy(), _np(ref))


@pytest.mark.parametrize('fk,r', [(3, 2), (3, 3), (9, 2)])
def test_w_phase_dense(fk, r):
    w = _rand(np.random.default_rng(3), fk, fk, 8, 3)
    assert layout.phase_dense_ck(fk, r) == cs_conv.phase_dense_ck(fk, r)
    got = layout.w_phase_dense(torch.from_numpy(w), r)
    np.testing.assert_array_equal(
        got.numpy(), _np(cs_conv.w_phase_dense(jnp.asarray(w), r)))
    bf = _rand(np.random.default_rng(4), 3)
    co = got.shape[-1]
    ref_b = jnp.concatenate([jnp.tile(jnp.asarray(bf), r * r),
                             jnp.zeros(co - r * r * 3)])
    np.testing.assert_array_equal(
        layout.b_phase_dense(torch.from_numpy(bf), r, co).numpy(),
        _np(ref_b))


@pytest.mark.parametrize('r', [2, 3])
def test_pm_to_nhwc(r):
    b, h, w, k = 2, 8, 8, 2
    y = _rand(np.random.default_rng(5), b, h, w, 32)
    ref = cs_conv.pm_to_nhwc(cs_conv.nhwc_to_cs(jnp.asarray(y), k), r, 3,
                             k, h, w)
    got = layout.pm_to_nhwc(torch.from_numpy(y), r, 3)
    np.testing.assert_array_equal(got.numpy(), _np(ref))


def test_pixel_shuffle():
    x = _rand(np.random.default_rng(6), 2, 4, 5, 16)
    np.testing.assert_array_equal(
        layout.pixel_shuffle(torch.from_numpy(x), 2).numpy(),
        _np(jax_pixel_shuffle(jnp.asarray(x), 2)))


# -------------------------------------------- (b) plain versions vs Pallas

B, H, W, K = 2, 8, 8, 2       # two 8x8 images side by side: S = 128 lanes


def _to_cs(x, dtype=jnp.float32):
    return cs_conv.nhwc_to_cs(jnp.asarray(x, dtype), K)


@pytest.mark.parametrize('c_in,c_out', [(16, 16), (16, 64), (64, 16)])
def test_conv_plain_matches_pallas(c_in, c_out):
    """K2 at the EDSR tail's three kinds of shape, narrowed: C->C (close
    conv), C->4C (phase-major last stage), 4C->16 (phase-dense final)."""
    rng = np.random.default_rng(10)
    x = _rand(rng, B, H, W, c_in)
    w = _rand(rng, 3, 3, c_in, c_out, scale=0.1)
    b = _rand(rng, c_out, scale=0.1)
    ref = cs_conv.cs_to_nhwc(
        cs_conv.conv3x3_cs(_to_cs(x), jnp.asarray(w), jnp.asarray(b), W, K),
        K, H, W)
    got = conv3x3_plain(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-4)


def test_conv_plain_matches_pallas_bf16():
    rng = np.random.default_rng(11)
    x = _rand(rng, B, H, W, 16)
    w = _rand(rng, 3, 3, 16, 16, scale=0.1)
    b = _rand(rng, 16, scale=0.1)
    ref = _np(cs_conv.cs_to_nhwc(cs_conv.conv3x3_cs(
        _to_cs(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        jnp.asarray(b), W, K), K, H, W))
    got = conv3x3_plain(torch.from_numpy(x).bfloat16(),
                        torch.from_numpy(w).bfloat16(), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=2.0 ** -7 * np.abs(ref).max())


@pytest.mark.parametrize('r', [2, 3])
def test_upsample_plain_matches_pallas(r):
    c = 16
    rng = np.random.default_rng(12)
    x = _rand(rng, B, H, W, c)
    w = _rand(rng, 3, 3, c, r * r * c, scale=0.1)   # PixelShuffle order
    b = _rand(rng, r * r * c, scale=0.1)
    w_ps = cs_conv.w_ps_cs(jnp.asarray(w), r)
    b_ps = jnp.asarray(b).reshape(c, r * r).T
    ref = cs_conv.cs_to_nhwc(
        cs_conv.upsample_cs(_to_cs(x), w_ps, b_ps, W, K, H, r), K, r * H,
        r * W)
    got = upsample_plain(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b), r)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-4)


def test_trunk_plain_matches_pallas():
    c, n_blocks, res_scale = 16, 2, 0.7
    rng = np.random.default_rng(13)
    x = _rand(rng, B, H, W, c)
    w1 = _rand(rng, n_blocks, 3, 3, c, c, scale=0.1)
    w2 = _rand(rng, n_blocks, 3, 3, c, c, scale=0.1)
    b1 = _rand(rng, n_blocks, c, scale=0.1)
    b2 = _rand(rng, n_blocks, c, scale=0.1)
    ref = cs_conv.cs_to_nhwc(cs_conv.trunk_cs_mega(
        _to_cs(x), cs_conv.w_cs_batch(jnp.asarray(w1)), jnp.asarray(b1),
        cs_conv.w_cs_batch(jnp.asarray(w2)), jnp.asarray(b2), res_scale,
        W, K), K, H, W)
    got = trunk_plain(*(torch.from_numpy(a) for a in (x, w1, b1, w2, b2)),
                      res_scale)
    np.testing.assert_allclose(got.numpy(), _np(ref), atol=1e-4)


def test_cuda_wrappers_reject_other_devices():
    """The wrappers take the plain version only for CPU tensors; any other
    device must launch the kernel or raise — never fall back."""
    from srtpu_torch.ops import (conv3x3_bwd, conv3x3_fwd, conv_wgrad,
                                 trunk_bwd, trunk_fwd, upsample_bwd,
                                 upsample_fwd)
    x = torch.zeros(1, 4, 4, 64, device='meta')
    w = torch.zeros(3, 3, 64, 64, device='meta')
    b = torch.zeros(64, device='meta')
    w4 = torch.zeros(3, 3, 64, 256, device='meta')
    g4 = torch.zeros(1, 8, 8, 64, device='meta')
    calls = [lambda: conv3x3_fwd(x, w, b),
             lambda: upsample_fwd(x, w, b, 2),
             lambda: trunk_fwd(x, w[None], b[None], w[None], b[None], 1.0),
             lambda: conv3x3_bwd(x, w, x),
             lambda: upsample_bwd(x, w4, g4, 2),
             lambda: trunk_bwd(x[None], x[None], x, w[None], w[None], 1.0),
             lambda: conv_wgrad(x, x)]
    for call in calls:
        with pytest.raises(ValueError, match='no kernel'):
            call()


# ------------------------------------ (c) plain backwards vs Pallas vjp
#
# Tolerances: f32 1e-4 abs on dx, and 1e-4 of the largest magnitude on
# dW / db (sums over all pixels: the same f32 products in another
# order). bf16 compute: dx within one bf16 step of its largest magnitude
# (both sides round once, at the same point); dW / db sum bf16 products
# exactly in f32, so 1e-4 of the largest magnitude again. The trunk's
# chain carries a flipped step on through the blocks: four steps on dx
# and on the weight grads (which read the chain's bf16 dh1).


def _close(got, ref, steps=None, rel=1e-4, atol=None):
    if torch.is_tensor(got):
        got = got.detach().float()
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    top = np.abs(ref).max()
    tol = atol if atol is not None else \
        (steps * 2.0 ** -7 * top if steps else rel * top)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


def _jdt(dtype):
    return {'f32': (jnp.float32, torch.float32),
            'bf16': (jnp.bfloat16, torch.bfloat16)}[dtype]


def _dx_steps(dtype, steps):
    return dict(steps=steps) if dtype == 'bf16' else dict(atol=1e-4)


@pytest.mark.parametrize('c_in,c_out,dtype', [
    (16, 16, 'f32'), (16, 64, 'f32'), (64, 16, 'f32'), (16, 64, 'bf16')])
@pytest.mark.parametrize('pre', [False, True])
def test_conv_bwd_plain_matches_pallas(c_in, c_out, dtype, pre):
    """K2's backward (conv3x3_cs_bwd) through both wrappers: conv3x3_cs
    (HWIO weight: the close conv, the phase-dense final conv) and
    conv3x3_cs_pre (CS-arranged weight: the phase-major upscale conv)."""
    from srtpu_torch.ops import conv3x3_bwd_plain
    jdt, tdt = _jdt(dtype)
    rng = np.random.default_rng(20)
    x = _rand(rng, B, H, W, c_in)
    w = _rand(rng, 3, 3, c_in, c_out, scale=0.1)
    b = _rand(rng, c_out, scale=0.1)
    g = _rand(rng, B, H, W, c_out)
    if pre:
        fn = lambda xc, wc, bc: cs_conv.conv3x3_cs_pre(xc, wc, bc, W, K)
        w_in = cs_conv.w_cs(jnp.asarray(w))
    else:
        fn = lambda xc, wc, bc: cs_conv.conv3x3_cs(xc, wc, bc, W, K)
        w_in = jnp.asarray(w)
    _, vjp = jax.vjp(fn, _to_cs(x, jdt), w_in, jnp.asarray(b))
    dx, dw, db = vjp(_to_cs(g, jdt))
    if pre:
        dw = layout.w_hwio_from_cs(torch.from_numpy(_np(dw))[None], c_in,
                                   c_out)[0]
    got = conv3x3_bwd_plain(torch.from_numpy(x).to(tdt),
                            torch.from_numpy(w).to(tdt),
                            torch.from_numpy(g).to(tdt))
    assert got[0].dtype == tdt and got[1].dtype == got[2].dtype == \
        torch.float32
    _close(got[0], cs_conv.cs_to_nhwc(dx, K, H, W), **_dx_steps(dtype, 1))
    _close(got[1], dw)
    _close(got[2], db)


@pytest.mark.parametrize('r,dtype', [(2, 'f32'), (3, 'f32'), (2, 'bf16')])
def test_upsample_bwd_plain_matches_pallas(r, dtype):
    """K3's backward (_ups_deint_kernel + _ups_conv_bwd_kernel): the fine
    cotangent read phase-major, dx one rounding over all r*r phases, dW
    and db per phase in f32 — returned in PixelShuffle order."""
    from srtpu_torch.ops import upsample_bwd_plain
    jdt, tdt = _jdt(dtype)
    c = 16
    rng = np.random.default_rng(21)
    x = _rand(rng, B, H, W, c)
    w = _rand(rng, 3, 3, c, r * r * c, scale=0.1)   # PixelShuffle order
    b = _rand(rng, r * r * c, scale=0.1)
    g = _rand(rng, B, r * H, r * W, c)
    fn = lambda xc, wc, bc: cs_conv.upsample_cs(xc, wc, bc, W, K, H, r)
    _, vjp = jax.vjp(fn, _to_cs(x, jdt), cs_conv.w_ps_cs(jnp.asarray(w), r),
                     jnp.asarray(b).reshape(c, r * r).T)
    dx, dw_ps, db_ps = vjp(_to_cs(g, jdt))
    got = upsample_bwd_plain(torch.from_numpy(x).to(tdt),
                             torch.from_numpy(w).to(tdt),
                             torch.from_numpy(g).to(tdt), r)
    _close(got[0], cs_conv.cs_to_nhwc(dx, K, H, W), **_dx_steps(dtype, 1))
    _close(got[1], layout.w_ps_hwio(torch.from_numpy(_np(dw_ps)), c, r))
    _close(got[2], _np(db_ps).T.reshape(-1))


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_trunk_bwd_plain_matches_pallas(dtype):
    """K1's backward (trunk_bwd_mega) from the port's saved xs / h1s."""
    from srtpu_torch.ops import trunk_bwd_plain
    jdt, tdt = _jdt(dtype)
    c, n_blocks, res_scale = 16, 2, 0.7
    rng = np.random.default_rng(22)
    x = _rand(rng, B, H, W, c)
    w1 = _rand(rng, n_blocks, 3, 3, c, c, scale=0.1)
    w2 = _rand(rng, n_blocks, 3, 3, c, c, scale=0.1)
    b1 = _rand(rng, n_blocks, c, scale=0.1)
    b2 = _rand(rng, n_blocks, c, scale=0.1)
    g = _rand(rng, B, H, W, c)
    fn = lambda xc, a, bb, cc, d: cs_conv.trunk_cs_mega(
        xc, a, bb, cc, d, res_scale, W, K)
    _, vjp = jax.vjp(fn, _to_cs(x, jdt), cs_conv.w_cs_batch(jnp.asarray(w1)),
                     jnp.asarray(b1), cs_conv.w_cs_batch(jnp.asarray(w2)),
                     jnp.asarray(b2))
    dx, dw1, db1, dw2, db2 = vjp(_to_cs(g, jdt))
    tw1, tw2 = torch.from_numpy(w1).to(tdt), torch.from_numpy(w2).to(tdt)
    _, xs, h1s = trunk_plain(torch.from_numpy(x).to(tdt), tw1,
                             torch.from_numpy(b1), tw2, torch.from_numpy(b2),
                             res_scale, save=True)
    got = trunk_bwd_plain(xs, h1s, torch.from_numpy(g).to(tdt), tw1, tw2,
                          res_scale)
    steps = dict(steps=4) if dtype == 'bf16' else {}
    _close(got[0], cs_conv.cs_to_nhwc(dx, K, H, W), **_dx_steps(dtype, 4))
    for t, ref in ((got[1], dw1), (got[3], dw2)):
        _close(t, layout.w_hwio_from_cs(torch.from_numpy(_np(ref)), c, c),
               **steps)
    _close(got[2], db1, **steps)
    _close(got[4], db2, **steps)


# ------------- (d) the autograd ops against autograd of the plain forward


def _grads(out, inputs, ct):
    return torch.autograd.grad(out, inputs, ct)


@pytest.mark.parametrize('op', ['conv', 'conv_wide', 'upsample', 'trunk'])
def test_autograd_op_matches_autograd_of_plain(op):
    """Each op's Function (plain=True: its plain backward) against torch
    autograd through the plain forward, f32 on the CPU: 1e-4 of the
    largest magnitude (the same f32 sums in another order)."""
    from srtpu_torch.ops import conv3x3, trunk, upsample
    from srtpu_torch.ops.conv import conv_f32
    rng = np.random.default_rng(30)

    def p(*shape, scale=1.0):
        return torch.from_numpy(_rand(rng, *shape, scale=scale)) \
            .requires_grad_()

    c = 16
    if op == 'trunk':
        params = [p(B, H, W, c), p(2, 3, 3, c, c, scale=0.1),
                  p(2, c, scale=0.1), p(2, 3, 3, c, c, scale=0.1),
                  p(2, c, scale=0.1)]
        got_out = trunk(*params, 0.5, plain=True)

        def ref_fn(x, w1, b1, w2, b2):
            for i in range(2):
                h1 = conv_f32(x, w1[i], b1[i]).clamp_min(0)
                x = conv_f32(h1, w2[i], b2[i]) * 0.5 + x
            return x
    elif op == 'upsample':
        params = [p(B, H, W, c), p(3, 3, c, 4 * c, scale=0.1),
                  p(4 * c, scale=0.1)]
        got_out = upsample(*params, 2, plain=True)

        def ref_fn(x, w, b):
            return layout.pixel_shuffle(conv_f32(x, w, b), 2)
    else:
        cin, cout = (c, c) if op == 'conv' else (4 * c, c)
        params = [p(B, H, W, cin), p(3, 3, cin, cout, scale=0.1),
                  p(cout, scale=0.1)]
        got_out = conv3x3(*params, plain=True)
        ref_fn = conv_f32
    ref_out = ref_fn(*params)
    ct = torch.from_numpy(_rand(rng, *ref_out.shape))
    _close(got_out.detach(), ref_out.detach())
    for got, ref in zip(_grads(got_out, params, ct),
                        _grads(ref_out, params, ct)):
        assert got.dtype == torch.float32
        _close(got, ref)
