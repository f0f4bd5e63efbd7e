"""The port's metrics (srtpu_torch.metrics) against srtpu.metrics on the
CPU, f32, on the same numpy inputs from a seed.

Tolerances: PSNR within 1e-4 dB, SSIM and MS-SSIM within 1e-5 (the two
sides run srtpu's slice-add order; XLA and PyTorch may still reduce the
final means in another order). The constant-image identity (SSIM and
MS-SSIM of an image with itself is 1) within 1e-4, srtpu's own bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srtpu import metrics as jax_metrics
from srtpu_torch import metrics

torch.set_num_threads(1)

PSNR_TOL, SSIM_TOL = 1e-4, 1e-5
# HR of at least 176 per side: MS-SSIM's five scales at 11 taps need
# min(H, W) > 160. Masked, the coarsest scale of the first two has no
# valid window left (srtpu's value there is its 1e-6 floor); the third
# keeps some at every scale.
SHAPES = ((1, 176, 200, 3), (2, 192, 184, 3), (1, 256, 264, 3))


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    hr = rng.random(shape, np.float32)
    sr = np.clip(hr + rng.normal(0, 0.05, shape), 0, 1).astype(np.float32)
    mask = np.zeros(shape[:3] + (1,), np.float32)
    mask[:, :shape[1] - 13, :shape[2] - 21] = 1.0
    return sr, hr, mask


def _both(name, sr, hr, mask):
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    ref = float(getattr(jax_metrics, name)(jnp.asarray(sr), jnp.asarray(hr),
                                           mask=jm))
    got = getattr(metrics, name)(torch.from_numpy(sr), torch.from_numpy(hr),
                                 mask=tm)
    assert got.dtype == torch.float32 and got.dim() == 0
    return float(got), ref


@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('name', ['psnr', 'ssim', 'ms_ssim'])
def test_metric_matches_srtpu(name, shape, masked):
    sr, hr, mask = _pair(shape, sum(shape))
    got, ref = _both(name, sr, hr, mask if masked else None)
    tol = PSNR_TOL if name == 'psnr' else SSIM_TOL
    assert abs(got - ref) <= tol, (got, ref)


@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('name', ['ssim', 'ms_ssim'])
def test_constant_image_identity(name, masked):
    shape = SHAPES[2]
    img = np.full(shape, 0.37, np.float32)
    _, _, mask = _pair(shape, 3)
    got, ref = _both(name, img, img, mask if masked else None)
    assert abs(got - 1.0) <= 1e-4 and abs(got - ref) <= SSIM_TOL


def test_masked_equals_unpadded():
    """A bucket-padded image scores as its unpadded original, within the
    f32 rounding of the means: PSNR, SSIM and MS-SSIM (its re-mask after
    each pool keeps exactly the pooled pixels the unpadded image's VALID
    pool keeps)."""
    sr, hr, _ = _pair((1, 180, 190, 3), 5)
    pad = ((0, 0), (0, 12), (0, 34), (0, 0))
    mask = np.pad(np.ones((1, 180, 190, 1), np.float32), pad)
    t = torch.from_numpy
    for fn in (metrics.psnr, metrics.ssim, metrics.ms_ssim):
        whole = float(fn(t(sr), t(hr)))
        padded = float(fn(t(np.pad(sr, pad, mode='edge')),
                          t(np.pad(hr, pad, mode='edge')), mask=t(mask)))
        assert abs(whole - padded) <= 1e-5, fn


def test_registry_names_and_errors():
    assert metrics.supported_metrics() == \
        jax_metrics.supported_metrics()
    assert metrics.NO_REFERENCE == jax_metrics.NO_REFERENCE
    assert metrics.LOWER_IS_BETTER == jax_metrics.LOWER_IS_BETTER
    built = metrics.build_metrics(['PSNR', 'SSIM', 'MS-SSIM'])
    assert list(built) == ['PSNR', 'SSIM', 'MS-SSIM']
    sr, hr, mask = _pair(SHAPES[0], 9)
    ref = jax_metrics.build_metrics(['PSNR'])['PSNR'](
        jnp.asarray(sr), jnp.asarray(hr), mask=jnp.asarray(mask))
    got = built['PSNR'](torch.from_numpy(sr), torch.from_numpy(hr),
                        mask=torch.from_numpy(mask))
    assert abs(float(got) - float(ref)) <= PSNR_TOL
    # every srtpu metric builds
    names = metrics.supported_metrics()
    assert list(metrics.build_metrics(names)) == names
    with pytest.raises(AttributeError) as port_err:
        metrics.build_metrics(['NIQE'])
    with pytest.raises(AttributeError) as jax_err:
        jax_metrics.build_metrics(['NIQE'])
    assert str(port_err.value) == str(jax_err.value)
