"""srtpu_torch.ops against srtpu.ops.cs_conv on the CPU.

(a) each NHWC/HWIO layout helper against its cs_conv counterpart;
(b) each kernel's plain PyTorch version against the JAX Pallas kernel it
replaces, run in interpret mode (as tests/test_ops_cs.py runs them), with
inputs and outputs through nhwc_to_cs / cs_to_nhwc.

Tolerances: f32 cases 1e-4 abs, as test_ops_cs.py uses — both sides sum
the same f32 products in another order. The bf16 case allows one bf16
rounding step at the output's largest magnitude (2^-7 * max|ref|): both
sides round at the same points, so only a sum that lands next to a bf16
rounding boundary can come out one step apart.
"""

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
    return np.asarray(t, dtype=np.float32)


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
    from srtpu_torch.ops import conv3x3_fwd, trunk_fwd, upsample_fwd
    x = torch.zeros(1, 4, 4, 64, device='meta')
    w = torch.zeros(3, 3, 64, 64, device='meta')
    b = torch.zeros(64, device='meta')
    with pytest.raises(ValueError, match='no kernel'):
        conv3x3_fwd(x, w, b)
    with pytest.raises(ValueError, match='no kernel'):
        upsample_fwd(x, w, b, 2)
    with pytest.raises(ValueError, match='no kernel'):
        trunk_fwd(x, w[None], b[None], w[None], b[None], 1.0)
