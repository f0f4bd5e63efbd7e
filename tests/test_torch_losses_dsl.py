"""srtpu's remaining losses in the port (srtpu_torch.losses: adaptive,
dists, edge_loss, flip, haarpsi, lpips, pencil_sketch, pieapp), the
image ops under them (srtpu_torch.utils.imgops) and VGG16's features
with a mask and with L2 pooling, against srtpu's on the CPU, both in
f32 on the same numpy inputs from a seed.

The inputs hold exact ties: the SR clipped to [0, 1] (values at exactly
0 and 1), a block of exact 0s or 1s in both images, a region where the
SR equals the HR and a flat region equal in both.

Tolerances:
* adaptive, flip, haarpsi, pencil_sketch, lpips, dists, pieapp: the value
  within 1e-5 relative; the gradient with respect to the SR (and, for
  adaptive, its latent parameters) within 2^-10 of its largest finite
  magnitude, NaN and infinity where srtpu's are (FLIP's gradient is NaN
  where the SR equals the HR over a feature filter's width, in srtpu
  and the port alike);
* edge_loss within 1e-4 absolute; Canny's maps are counted pixel by
  pixel (a magnitude more than 1e-6 apart, an edge flipped) and the
  count printed: 0 on these inputs;
* gaussian_blur2d, laplacian, sobel, spatial_gradient: srtpu's tap order,
  within 2 ULP of the largest magnitude.

srtpu's jitted losses are the reference (its train step runs them
jitted). Where f32 arithmetic itself puts a value past its tolerance in
srtpu as in the port, a ``*_gap`` test holds the gap at its size and
ROADMAP.md queue 3 lists it: FLIP's gradient beside an SR = HR region,
the adaptive loss's latent_alpha gradient at its init, DISTS's value
(1 - a score near 1) and PieAPP's max pools at near-ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srtpu import losses as jl
from srtpu.losses import pieapp as jax_pieapp
from srtpu.losses import vgg as jax_vgg
from srtpu.utils import imgops as jax_imgops
from srtpu_torch import losses as tl
from srtpu_torch.losses import basic, pieapp, vgg
from srtpu_torch.utils import imgops

torch.set_num_threads(1)

VALUE_RTOL = 1e-5
GRAD_TOL = 2.0 ** -10
EDGE_ATOL = 1e-4


def tie_inputs(shape, seed):
    """(sr, hr): smooth-plus-noise HR, the SR its noisy copy clipped to
    [0, 1], with ties: SR = HR in the left quarter, a flat region equal
    in both, a block of exact 0s (image 0) or 1s (the others) in both."""
    rng = np.random.default_rng(seed)
    n, h, w, c = shape
    lo = rng.random((n, h // 8 + 1, w // 8 + 1, c))
    hr = (np.kron(lo, np.ones((1, 8, 8, 1)))[:, :h, :w] * 0.8
          + rng.random(shape) * 0.2).astype(np.float32)
    sr = np.clip(hr + rng.normal(0, 0.15, shape), 0, 1).astype(np.float32)
    sr[:, :, :w // 4] = hr[:, :, :w // 4]
    hr[:, 3 * h // 4:, w // 2:] = sr[:, 3 * h // 4:, w // 2:] = 0.5
    for i in range(n):
        sr[i, :6, -6:] = hr[i, :6, -6:] = 0.0 if i == 0 else 1.0
    return sr, hr


_JITTED: dict = {}


def jax_value_grad(fn, sr, hr):
    """srtpu's value and SR gradient, jitted (as its train step runs; one
    compilation per function and shape)."""
    if fn not in _JITTED:
        _JITTED[fn] = jax.jit(jax.value_and_grad(fn))
    v, g = _JITTED[fn](jnp.asarray(sr), jnp.asarray(hr))
    return float(v), np.asarray(g)


def port_value_grad(fn, sr, hr):
    t = torch.from_numpy(sr.copy()).requires_grad_()
    v = fn(t, torch.from_numpy(hr))
    v.backward()
    return float(v.detach()), t.grad.numpy()


def assert_grad_close(got, ref, tol=GRAD_TOL, what=''):
    """NaN and infinity where ``ref`` has them; the finite rest within
    ``tol`` of ``ref``'s largest finite magnitude."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), what)
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(ref), what)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref), what)
    fin = np.isfinite(ref)
    assert fin.any(), what
    scale = np.abs(ref[fin]).max()
    err = np.abs(got[fin] - ref[fin]).max()
    assert err <= tol * scale, (what, err, scale)


def check_loss(jax_fn, port_fn, sr, hr):
    v_ref, g_ref = jax_value_grad(jax_fn, sr, hr)
    v, g = port_value_grad(port_fn, sr, hr)
    assert abs(v - v_ref) <= VALUE_RTOL * abs(v_ref), (v, v_ref)
    assert_grad_close(g, g_ref)
    return g_ref


# ----------------------------------------------------------- image ops

@pytest.mark.parametrize('shape,seed', [((2, 48, 40, 3), 0),
                                        ((2, 32, 32, 3), 1)])
def test_imgops_match_srtpu(shape, seed):
    sr, _ = tie_inputs(shape, seed)
    j, t = jnp.asarray(sr), torch.from_numpy(sr)

    def close(a, b):
        a, b = np.asarray(a), b.numpy()
        ulp = np.spacing(np.float32(np.abs(a).max()))
        assert np.abs(a - b).max() <= 2 * ulp

    gray_j, gray_t = jax_imgops.rgb_to_grayscale(j), \
        imgops.rgb_to_grayscale(t)
    close(gray_j, gray_t)
    for k, sigma in ((3, 1.0), (5, 1.5), (11, 1.5)):
        close(jax_imgops.gaussian_blur2d(j, k, sigma),
              imgops.gaussian_blur2d(t, k, sigma))
    close(jax_imgops.sobel(gray_j), imgops.sobel(gray_t))
    for a, b in zip(jax_imgops.spatial_gradient(gray_j, False),
                    imgops.spatial_gradient(gray_t, False)):
        close(a, b)
    close(jax_imgops.laplacian(gray_j, 5), imgops.laplacian(gray_t, 5))
    mag_j, edges_j = map(np.asarray, jax_imgops.canny(gray_j))
    mag_t, edges_t = (a.numpy() for a in imgops.canny(gray_t))
    n_mag = int((np.abs(mag_j - mag_t) > 1e-6).sum())
    n_edge = int((edges_j != edges_t).sum())
    print(f'canny {shape}: {n_mag} magnitude and {n_edge} edge pixels '
          f'differ of {mag_j.size}; {int((mag_j > 0).sum())} kept')
    assert n_mag == 0 and n_edge == 0
    assert edges_t.dtype == np.float32 and set(np.unique(edges_t)) <= {0, 1}


@pytest.mark.parametrize('operator', ['canny', 'sobel', 'laplacian'])
def test_edge_loss_matches_srtpu(operator):
    sr, hr = tie_inputs((2, 48, 40, 3), 2)
    ref = float(jl.edge_loss(jnp.asarray(sr), jnp.asarray(hr), operator))
    t = torch.from_numpy(sr).requires_grad_()
    got = tl.edge_loss(t, torch.from_numpy(hr), operator)
    assert abs(float(got) - ref) <= EDGE_ATOL
    assert not got.requires_grad        # srtpu's stop_gradient


def test_pencil_sketch_matches_srtpu():
    sr, hr = tie_inputs((2, 48, 40, 3), 3)
    np.testing.assert_allclose(
        tl.pencil_sketch(torch.from_numpy(sr)).numpy(),
        np.asarray(jl.pencil_sketch(jnp.asarray(sr))), rtol=0, atol=1e-6)
    ref = float(jl.pencil_sketch_loss(jnp.asarray(sr), jnp.asarray(hr)))
    got = tl.pencil_sketch_loss(torch.from_numpy(sr).requires_grad_(),
                                torch.from_numpy(hr))
    assert abs(float(got) - ref) <= VALUE_RTOL * abs(ref)
    assert not got.requires_grad


# ----------------------------------------------- losses with a gradient

@pytest.mark.parametrize('shape,seed', [((2, 48, 40, 3), 4),
                                        ((2, 33, 41, 3), 5)])
def test_haarpsi_matches_srtpu(shape, seed):
    sr, hr = tie_inputs(shape, seed)
    g = check_loss(lambda s, h: jl.haarpsi_loss(jnp.clip(s, 0, 1), h),
                   lambda s, h: tl.haarpsi_loss(basic.clip(s, 0, 1), h),
                   sr, hr)
    assert np.isfinite(g).all()


@pytest.mark.parametrize('dsl', ['l1', 'mae'])
def test_l1_gradient_at_ties_matches_srtpu(dsl):
    """ROADMAP F15: where the SR equals the HR, jnp.abs's gradient is 1
    and torch.abs's 0; the port's l1 takes JAX's."""
    sr, hr = tie_inputs((2, 16, 16, 3), 16)
    g = check_loss(lambda s, h: jl.parse_losses(dsl)(s, h)[0],
                   lambda s, h: tl.parse_losses(dsl)(s, h)[0], sr, hr)
    assert (g[:, :, :4] > 0).all()


def test_ties_need_jax_gradients():
    """torch.abs and torch.clamp give another gradient on these inputs:
    the JAX forms in losses.basic are what match."""
    sr, hr = tie_inputs((2, 48, 40, 3), 4)
    _, g_ref = jax_value_grad(
        lambda s, h: jl.haarpsi_loss(jnp.clip(s, 0, 1), h), sr, hr)
    _, g = port_value_grad(
        lambda s, h: tl.haarpsi_loss(s.clamp(0, 1), h), sr, hr)
    assert np.abs(g - g_ref).max() > GRAD_TOL * np.abs(g_ref).max()


def test_flip_matches_srtpu():
    """The SR a noisy copy of the HR clipped to [0, 1] (exact 0s and 1s;
    the HR's flat region and 0 / 1 block): the value and gradient."""
    _, hr = tie_inputs((2, 32, 40, 3), 6)
    rng = np.random.default_rng(7)
    sr = np.clip(hr + rng.normal(0, 0.1, hr.shape), 0, 1).astype(np.float32)
    g = check_loss(jl.flip_loss, tl.flip_loss, sr, hr)
    assert np.isfinite(g).all()


def test_flip_equal_region_gap():
    """A gap of srtpu's FLIP, which the port keeps (ROADMAP queue 3):
    where the SR equals the HR over a feature filter's width the feature
    error is exactly 0 and the derivative of its 0.5 power infinite, so
    the gradient is NaN there, in srtpu and the port alike, and finite
    but ill-conditioned beside it: srtpu's own eager and jitted
    gradients there differ by about 8% of the largest. Held: the value
    within 1e-5 relative, NaN where srtpu's jitted gradient is, and the
    finite rest within 2^-3 of the largest."""
    sr, hr = tie_inputs((2, 32, 40, 3), 6)
    v_ref, g_ref = jax_value_grad(jl.flip_loss, sr, hr)
    v, g = port_value_grad(tl.flip_loss, sr, hr)
    assert abs(v - v_ref) <= VALUE_RTOL * abs(v_ref)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(g_ref))
    assert np.isnan(g).any()
    assert_grad_close(g, g_ref, tol=2.0 ** -3)


def _adaptive_case(pert: float, seed: int = 8):
    """(sr, hr, latents): the init latents (alpha 1, scale 1) moved by
    N(0, pert), alpha within eps of 2 at band 0 channel 0."""
    sr, hr = tie_inputs((2, 48, 40, 3), seed)
    rng = np.random.default_rng(9)
    params = {k: np.asarray(v) + rng.normal(0, pert, v.shape).astype(
        np.float32) for k, v in jl.AdaptiveLoss().init(None).items()}
    params['latent_alpha'][0, 0] = 40.0
    return sr, hr, params


def _adaptive_port(sr, hr, params, dtype=torch.float32):
    ts = torch.from_numpy(sr).to(dtype).requires_grad_()
    tp = {k: torch.from_numpy(v).to(dtype).requires_grad_()
          for k, v in params.items()}
    v = tl.AdaptiveLoss()(ts, torch.from_numpy(hr).to(dtype), tp)
    v.backward()
    return float(v.detach()), ts.grad.numpy(), {
        k: p.grad.double().numpy() for k, p in tp.items()}


def _adaptive_jax(sr, hr, params):
    v, (gs, gp) = jax.jit(jax.value_and_grad(
        lambda s, h, p: jl.AdaptiveLoss()(s, h, p), argnums=(0, 2)))(
        jnp.asarray(sr), jnp.asarray(hr),
        {k: jnp.asarray(v) for k, v in params.items()})
    return float(v), np.asarray(gs), {k: np.asarray(g)
                                      for k, g in gp.items()}


def test_adaptive_matches_srtpu():
    """Latents moved from the init: the value, the SR's gradient and both
    latents' gradients."""
    init = jl.AdaptiveLoss().init(None)
    for k, v in tl.AdaptiveLoss().init().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(init[k]))
    sr, hr, params = _adaptive_case(0.5)
    v_ref, gs_ref, gp_ref = _adaptive_jax(sr, hr, params)
    v, gs, gp = _adaptive_port(sr, hr, params)
    assert abs(v - v_ref) <= VALUE_RTOL * abs(v_ref)
    assert_grad_close(gs, gs_ref, what='sr')
    for k in params:
        assert_grad_close(gp[k], gp_ref[k], what=k)


def test_adaptive_at_init_matches_srtpu():
    """srtpu's init latents (alpha 1, scale 1): the value, the SR's
    gradient and latent_scale's; latent_alpha's is the gap below."""
    sr, hr, params = _adaptive_case(0.0)
    v_ref, gs_ref, gp_ref = _adaptive_jax(sr, hr, params)
    v, gs, gp = _adaptive_port(sr, hr, params)
    assert abs(v - v_ref) <= VALUE_RTOL * abs(v_ref)
    assert_grad_close(gs, gs_ref, what='sr')
    assert_grad_close(gp['latent_scale'], gp_ref['latent_scale'],
                      what='latent_scale')


def test_adaptive_latent_alpha_gradient_gap():
    """A gap the port keeps (ROADMAP queue 3): at the init latents the
    gradient with respect to latent_alpha sums terms that cancel to
    second order in the residual, so srtpu's own f32 value sits about
    0.5% of its largest magnitude from the f64 value of the same formula
    (the port run in f64), and the port's f32 value about as far with
    its own roundings (XLA's log and pow are not PyTorch's). The two f32
    values are then 0.19% apart, past 2^-10. Held: srtpu's f32 error past
    2^-10 here, and the port's f32 error no more than 2^-5."""
    sr, hr, params = _adaptive_case(0.0)
    _, _, gp_ref = _adaptive_jax(sr, hr, params)
    _, _, gp = _adaptive_port(sr, hr, params)
    _, _, gp64 = _adaptive_port(sr, hr, params, torch.float64)
    g64 = gp64['latent_alpha']
    scale = np.abs(g64).max()
    err_ref = np.abs(gp_ref['latent_alpha'] - g64).max() / scale
    err = np.abs(gp['latent_alpha'] - g64).max() / scale
    gap = np.abs(gp['latent_alpha'] - gp_ref['latent_alpha']).max() / scale
    print(f'latent_alpha grad vs f64: srtpu {err_ref:.3g}, port {err:.3g};'
          f' port vs srtpu {gap:.3g} of the largest')
    assert err_ref > GRAD_TOL and err <= 2.0 ** -5


@pytest.mark.parametrize('masked', [False, True])
def test_vgg16_features_match_srtpu(masked):
    """VGG16 through relu5_3 at every tap, with srtpu's validity mask
    (activations and the min-pooled mask) or with L2 pooling."""
    sr, _ = tie_inputs((2, 48, 40, 3), 10)
    params, loaded = vgg.init_vgg_params('vgg16', 0)
    jparams = jax_vgg.init_vgg_params('vgg16', 0)
    assert not loaded
    for (k, b), p in zip(params, jparams):
        np.testing.assert_array_equal(k, np.asarray(p['kernel']))
        np.testing.assert_array_equal(b, np.asarray(p['bias']))
    taps = vgg.LPIPS_TAPS
    mask = np.zeros((2, 48, 40, 1), np.float32)
    mask[:, :41, :35] = 1.0
    m_t = torch.from_numpy(mask).permute(0, 3, 1, 2) if masked else None
    m_j = jnp.asarray(mask) if masked else None
    pool = 'max' if masked else 'l2'
    ref, ref_m = jax_vgg.vgg_features(jparams, jax_vgg.VGG16_PLAN,
                                      jnp.asarray(sr), taps, pool=pool,
                                      mask=m_j)
    got, got_m = vgg.vgg_features(vgg.to_torch(params),
                                  torch.from_numpy(sr).permute(0, 3, 1, 2),
                                  taps, vgg.VGG16_PLAN, pool=pool, mask=m_t)
    for tap in taps:
        r = np.asarray(ref[tap])
        g = got[tap].permute(0, 2, 3, 1).numpy()
        assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max(), tap
        if masked:
            np.testing.assert_array_equal(
                got_m[tap].permute(0, 2, 3, 1).numpy(), np.asarray(ref_m[tap]))


@pytest.fixture(scope='module')
def perceptual():
    return {'lpips': (jl.LPIPS(), tl.LPIPS()), 'dists': (jl.DISTS(),
                                                          tl.DISTS())}


def test_lpips_loss_matches_srtpu(perceptual):
    j, t = perceptual['lpips']
    assert j.pretrained is False and t.pretrained is False
    sr, hr = tie_inputs((2, 32, 32, 3), 11)
    check_loss(lambda s, h: j(s, h), lambda s, h: t(s, h), sr, hr)


def test_dists_loss_matches_srtpu(perceptual):
    """The gradient within 2^-10; the value as the gap below says."""
    j, t = perceptual['dists']
    assert j.pretrained is False and t.pretrained is False
    sr, hr = tie_inputs((2, 32, 32, 3), 11)
    _, g_ref = jax_value_grad(j, sr, hr)
    _, g = port_value_grad(t, sr, hr)
    assert_grad_close(g, g_ref)


def test_dists_value_gap(perceptual):
    """A gap the port keeps (ROADMAP queue 3): DISTS is 1 - a score, the
    score near 0.99 on this near pair, and its structure terms take
    variances as E[x^2] - E[x]^2 of VGG features, which carry the convs'
    1e-6 relative rounding differences: srtpu's jitted score and the
    port's land 5 ULPs of 1 apart (3e-7), 2.9e-5 of the 0.0102 loss, past
    1e-5 (srtpu's own eager value sits 3 ULPs from its jitted one). Held:
    within 8 ULPs of 1, and the value's gap printed."""
    j, t = perceptual['dists']
    sr, hr = tie_inputs((2, 32, 32, 3), 11)
    v_ref, _ = jax_value_grad(j, sr, hr)
    v = float(t(torch.from_numpy(sr), torch.from_numpy(hr)))
    print(f'dists value gap: {abs(v - v_ref):.3g} = '
          f'{abs(v - v_ref) / abs(v_ref):.3g} of the loss {v_ref:.4g}')
    assert abs(v - v_ref) <= 8 * np.spacing(np.float32(0.5))


@pytest.fixture(scope='module')
def pieapps():
    """(srtpu's PieAPP on the clipped SR, one function for every test so
    that its jit compiles once a shape; the port's; srtpu's PieAPP)."""
    j = jax_pieapp.PieAPP()
    return (lambda s, h: j(jnp.clip(s, 0, 1), h)), pieapp.PieAPP(), j


def test_pieapp_matches_srtpu(pieapps):
    j, t, jax_obj = pieapps
    np.testing.assert_array_equal(
        t._frozen.on('cpu')['fc_score'][0][0].numpy(),
        np.asarray(jax_obj.params['fc_score'][0][0]))
    sr, hr = tie_inputs((2, 64, 64, 3), 12)
    sr[0, 20:30] += 0.3                  # past 1: the clip's bound ties
    check_loss(j, lambda s, h: t(basic.clip(s, 0, 1), h), sr, hr)


def test_pieapp_patch_grid_matches_srtpu(pieapps):
    """Several patches an image (100 x 92: 2 x 2 at stride 27), summed
    per image in srtpu's order."""
    j, t, _ = pieapps
    rng = np.random.default_rng(13)
    hr = rng.random((2, 100, 92, 3)).astype(np.float32)
    sr = np.clip(hr + rng.normal(0, 0.1, hr.shape), 0, 1).astype(np.float32)
    sr[:, :, :10] = hr[:, :, :10]
    check_loss(j, lambda s, h: t(basic.clip(s, 0, 1), h), sr, hr)
    assert tuple(pieapp.patches(torch.from_numpy(hr)).shape) == \
        (8, 3, 64, 64)


def test_pieapp_max_pool_near_tie_gap(pieapps):
    """A gap the port keeps (ROADMAP queue 3): where two candidates of a
    max pool are within a rounding of each other, srtpu's XLA convs and
    the port's may round them into opposite order, and the pool's
    gradient then goes to the other pixel. On this input (seed 0,
    2 x 100 x 92, rows of exact 0s and 1s) one such flip moves the SR
    gradient by more than 2^-10 of its largest, over a patch of pixels;
    the value still agrees within 1e-5."""
    j, t, _ = pieapps
    sr, hr = tie_inputs((2, 100, 92, 3), 0)
    sr[:, 10:14] = 1.0
    sr[:, 14:16] = 0.0
    v_ref, g_ref = jax_value_grad(j, sr, hr)
    v, g = port_value_grad(lambda s, h: t(basic.clip(s, 0, 1), h), sr, hr)
    assert abs(v - v_ref) <= VALUE_RTOL * abs(v_ref)
    err = np.abs(g - g_ref)
    scale = np.abs(g_ref).max()
    print(f'pieapp near-tie gap: {err.max() / scale:.3g} of the largest, '
          f'{int((err > GRAD_TOL * scale).sum())} elements past 2^-10')
    assert err.max() <= 2.0 ** -6 * scale


@pytest.mark.parametrize('dsl', ['0.5 * l1 + 0.5 * adaptive',
                                 '0.7 * haarpsi + 0.3 * mse',
                                 '0.5 * l1 + 0.5 * edge_loss',
                                 '0.5 * l1 + 0.5 * pencil_sketch'])
def test_composite_matches_srtpu(dsl):
    """The DSL's total, parts, clamp dispatch and the trainable loss's
    parameters (keyed {i}_{name}) against srtpu's composite, on an SR
    that leaves [0, 1]."""
    sr, hr = tie_inputs((2, 48, 40, 3), 14)
    sr[0, 10:20] += 0.4
    sr[1, 10:20] -= 0.4
    jc, tc = jl.parse_losses(dsl), tl.parse_losses(dsl)
    jp = jc.init_params(jax.random.PRNGKey(0))
    tp = tc.init_params()
    assert tp.keys() == jp.keys()

    def jax_total(s, h):
        return jc(s, h, jp)[0]

    def port_total(s, h):
        params = {k: {n: v.clone() for n, v in p.items()}
                  for k, p in tp.items()}
        return tc(s, h, params)[0]
    g = check_loss(jax_total, port_total, sr, hr)
    assert np.isfinite(g).all()
    _, ref_parts = jc(jnp.asarray(sr), jnp.asarray(hr), jp)
    _, parts = tc(torch.from_numpy(sr), torch.from_numpy(hr), tp)
    assert parts.keys() == ref_parts.keys()


@pytest.mark.parametrize('padding,groups', [(1, 1), (0, 3)])
def test_conv2d_f32_is_the_plain_conv_on_the_cpu(padding, groups):
    """``imgops.conv2d_f32`` (the losses' and metrics' frozen filters, in
    full f32 on a card) on the CPU: ``F.conv2d``'s value and its input,
    weight and bias gradients bit for bit; cuDNN's TF32 setting as it
    was after the forward and after the backward."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, 3, 11, 9)).astype(np.float32)
    w = rng.standard_normal((6, 3 // groups, 3, 3)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    g = rng.standard_normal((2, 6, 9 + 2 * padding, 7 + 2 * padding)
                            ).astype(np.float32)
    saved = torch.backends.cudnn.allow_tf32
    outs = []
    for conv in (imgops.conv2d_f32, torch.nn.functional.conv2d):
        ts = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
        y = conv(ts[0], ts[1], ts[2], padding=padding, groups=groups)
        assert torch.backends.cudnn.allow_tf32 == saved
        y.backward(torch.from_numpy(g))
        assert torch.backends.cudnn.allow_tf32 == saved
        outs.append([y.detach()] + [t.grad for t in ts])
    for got, ref in zip(*outs):
        assert torch.equal(got, ref)


@pytest.mark.cuda
def test_conv2d_f32_runs_full_f32_on_the_card():
    """On the card, under PyTorch's TF32 default for cuDNN, VGG16's first
    3x3 conv through ``conv2d_f32``: its value and input gradient within
    1e-5 of the f64 convolution's largest magnitude (TF32's 10-bit
    products are about 1e-3 off)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    rng = np.random.default_rng(22)
    x = rng.standard_normal((4, 64, 32, 32))
    w = rng.standard_normal((64, 64, 3, 3)) / 24.0
    g = rng.standard_normal((4, 64, 32, 32))

    def run(conv, dtype, device):
        xt = torch.tensor(x, dtype=dtype, device=device, requires_grad=True)
        wt = torch.tensor(w, dtype=dtype, device=device)
        y = conv(xt, wt, None, padding=1)
        y.backward(torch.tensor(g, dtype=dtype, device=device))
        return y.detach().double().cpu(), xt.grad.double().cpu()

    ref = run(torch.nn.functional.conv2d, torch.float64, 'cpu')
    with imgops.cudnn_tf32(True):
        got = run(imgops.conv2d_f32, torch.float32, 'cuda')
    for a, r in zip(got, ref):
        assert float((a - r).abs().max()) <= 1e-5 * float(r.abs().max())
