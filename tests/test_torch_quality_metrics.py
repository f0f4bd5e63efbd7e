"""srtpu's BRISQUE, FLIP and LPIPS metrics in the port
(srtpu_torch.metrics) against srtpu's on the CPU, f32, on the same numpy
inputs from a seed: the functions (masked: a padded image scored on its
valid pixels), the weight files (``lpips_lin.npz``, ``dists_ab.npz``,
``brisque_svm.npz`` written here from a seed under
``$SRTPU_WEIGHTS_DIR``), and ``Trainer.validate`` with them on a tiny
EDSR, BRISQUE scored again on the true shape of a bucket-padded image.

Tolerances: FLIP within 1e-5, LPIPS within 1e-5 relative; BRISQUE's
fitted shape parameters (the GGD's and each AGGD's alpha) within one
table step (0.001), its other features within 1e-3 of their largest
magnitude (each AGGD mean reads a table entry at its alpha), the score
within 1e-3 relative. The images carry exact 0s and 1s (a noisy copy
clipped to [0, 1]); an exactly flat region is BRISQUE's gap (below).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srtpu import metrics as jax_metrics
from srtpu.losses import DISTS as JaxDISTS
from srtpu.losses import LPIPS as JaxLPIPS
from srtpu_torch import metrics
from srtpu_torch.losses import DISTS

# the modules (each package exports a function of the same name)
jax_brisque = importlib.import_module('srtpu.metrics.brisque')
port_brisque = importlib.import_module('srtpu_torch.metrics.brisque')

torch.set_num_threads(1)

FLIP_TOL, LPIPS_RTOL = 1e-5, 1e-5
TABLE_STEP, FEAT_RTOL, SCORE_RTOL = 1e-3, 1e-3, 1e-3
# the GGD's alpha and each AGGD's alpha, at both scales
SHAPE_COLS = [0, 2, 6, 10, 14, 18, 20, 24, 28, 32]


def images(shape, seed):
    """(sr, hr, mask): a smooth-plus-noise HR, the SR a noisy copy
    clipped to [0, 1]; the mask's valid rectangle leaves out the last
    rows and columns (a padded bucket's)."""
    rng = np.random.default_rng(seed)
    n, h, w, c = shape
    lo = rng.random((n, h // 8 + 1, w // 8 + 1, c))
    hr = (np.kron(lo, np.ones((1, 8, 8, 1)))[:, :h, :w] * 0.8
          + rng.random(shape) * 0.2).astype(np.float32)
    sr = np.clip(hr + rng.normal(0, 0.15, shape), 0, 1).astype(np.float32)
    mask = np.zeros((n, h, w, 1), np.float32)
    mask[:, :h - 7, :w - 12] = 1.0
    return sr, hr, mask


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize('masked', [False, True])
def test_flip_metric_matches_srtpu(masked):
    sr, hr, mask = images((2, 48, 40, 3), 0)
    m = mask if masked else None
    ref = float(jax_metrics.build_metrics(['FLIP'])['FLIP'](
        _j(sr), _j(hr), mask=_j(m)))
    got = float(metrics.build_metrics(['FLIP'])['FLIP'](
        _t(sr), _t(hr), mask=_t(m)))
    assert abs(got - ref) <= FLIP_TOL


@pytest.fixture(scope='module')
def lpips_pair():
    return jax_metrics.build_metrics(['LPIPS'])['LPIPS'], \
        metrics.build_metrics(['LPIPS'])['LPIPS']


@pytest.mark.parametrize('masked', [False, True])
def test_lpips_metric_matches_srtpu(lpips_pair, masked):
    sr, hr, mask = images((2, 48, 40, 3), 1)
    m = mask if masked else None
    ref = float(lpips_pair[0](_j(sr), _j(hr), mask=_j(m)))
    got = float(lpips_pair[1](_t(sr), _t(hr), mask=_t(m)))
    assert abs(got - ref) <= LPIPS_RTOL * abs(ref)


def test_masked_equals_unpadded(lpips_pair):
    """LPIPS and FLIP of an edge-padded image with its mask equal the
    unpadded image's, within f32 rounding (srtpu's masking)."""
    sr, hr, _ = images((1, 41, 28, 3), 2)
    pad = ((0, 0), (0, 7), (0, 12), (0, 0))
    mask = np.pad(np.ones((1, 41, 28, 1), np.float32), pad)
    fns = {'LPIPS': lpips_pair[1],
           'FLIP': metrics.build_metrics(['FLIP'])['FLIP']}
    for name, fn in fns.items():
        whole = float(fn(_t(sr), _t(hr)))
        padded = float(fn(_t(np.pad(sr, pad, mode='edge')),
                          _t(np.pad(hr, pad, mode='edge')), mask=_t(mask)))
        assert abs(padded - whole) <= 1e-5 * abs(whole), name


def _check_brisque_features(got, ref):
    d = np.abs(got - ref)
    other = [c for c in range(36) if c not in SHAPE_COLS]
    assert d[:, SHAPE_COLS].max() <= TABLE_STEP + 1e-6, d[:, SHAPE_COLS]
    scale = np.abs(ref[:, other]).max(axis=0)
    assert (d[:, other] <= FEAT_RTOL * scale).all()


@pytest.mark.parametrize('shape,seed', [((2, 48, 40, 3), 3),
                                        ((1, 57, 43, 3), 4),
                                        ((1, 64, 64, 1), 5)])
def test_brisque_matches_srtpu(shape, seed):
    sr, _, _ = images(shape, seed)
    ref = np.asarray(jax_brisque.brisque_features(jnp.asarray(sr)))
    got = port_brisque.brisque_features(torch.from_numpy(sr))
    _check_brisque_features(got.numpy(), ref)
    # the score from the same features (srtpu's brisque recomputes them)
    ref_s = float(jax_brisque.brisque(jnp.asarray(sr)))
    got_s = float(port_brisque.brisque(torch.from_numpy(sr)))
    assert abs(got_s - ref_s) <= SCORE_RTOL * abs(ref_s)


def test_brisque_on_a_padded_bucket():
    """The eval step's BRISQUE sees the edge-padded bucket; the re-score
    on the true shape (brisque_exact) is srtpu's, and the two differ."""
    sr, _, _ = images((1, 72, 56, 3), 6)
    padded = np.pad(sr, ((0, 0), (0, 24), (0, 40), (0, 0)), mode='edge')
    in_step = float(metrics.build_metrics(['BRISQUE'])['BRISQUE'](
        torch.from_numpy(padded)))
    ref_step = float(jax_metrics.build_metrics(['BRISQUE'])['BRISQUE'](
        jnp.asarray(padded)))
    assert abs(in_step - ref_step) <= SCORE_RTOL * abs(ref_step)
    exact = metrics.brisque_exact(torch.from_numpy(padded)[:, :72, :56])
    ref = jax_metrics.brisque_exact(padded[:, :72, :56])
    assert abs(exact - ref) <= SCORE_RTOL * abs(ref)
    assert abs(exact - in_step) > 10 * SCORE_RTOL * abs(ref)


def test_brisque_flat_region_gap():
    """A gap of srtpu's BRISQUE, which the port keeps (ROADMAP queue 3):
    in an exactly flat region the MSCN coefficients are the blur's
    rounding noise, whose signs decide the AGGD fits' left and right
    counts; srtpu's XLA convolution and the port's round differently, so
    the AGGD features move by more than a table step though the GGD's
    (no signs) agree. Held: the GGD's two features within their
    tolerances, the AGGD shape parameters apart by more than a step."""
    sr, _, _ = images((2, 48, 40, 3), 7)
    sr[:, 24:, 20:] = 0.5
    ref = np.asarray(jax_brisque.brisque_features(jnp.asarray(sr)))
    got = port_brisque.brisque_features(torch.from_numpy(sr)).numpy()
    d = np.abs(got - ref)
    print(f'brisque flat-region gap: AGGD alphas up to '
          f'{d[:, SHAPE_COLS].max():.4f} apart, features up to '
          f'{d.max():.4f}')
    assert d[:, 0].max() <= TABLE_STEP + 1e-6
    assert d[:, 1].max() <= FEAT_RTOL * np.abs(ref[:, 1]).max()
    assert d[:, SHAPE_COLS].max() > TABLE_STEP


def _write_weights(wdir, seed=0):
    """Small lpips_lin.npz, dists_ab.npz and brisque_svm.npz from a seed."""
    rng = np.random.default_rng(seed)
    dims = (64, 128, 256, 512, 512)
    np.savez(wdir / 'lpips_lin.npz', **{
        f'lin{i}': rng.random(d).astype(np.float32) / d
        for i, d in enumerate(dims)})
    ab = (3,) + dims
    np.savez(wdir / 'dists_ab.npz', **{
        f'{k}{i}': (rng.random(d) / (2 * sum(ab))).astype(np.float32)
        for k in ('alpha', 'beta') for i, d in enumerate(ab)})
    np.savez(wdir / 'brisque_svm.npz',
             sv=rng.uniform(-1, 1, (20, 36)).astype(np.float32),
             alpha=rng.normal(0, 1, 20).astype(np.float32),
             gamma=np.float32(0.05), rho=np.float32(-0.3),
             scale_min=np.full(36, -0.5, np.float32),
             scale_max=np.full(36, 3.0, np.float32))


def test_weight_files_load_as_srtpu(tmp_path, monkeypatch):
    _write_weights(tmp_path)
    monkeypatch.setenv('SRTPU_WEIGHTS_DIR', str(tmp_path))
    sr, hr, mask = images((2, 48, 40, 3), 8)
    lp_j, lp_t = JaxLPIPS(), metrics.build_metrics(['LPIPS'])['LPIPS']
    ref = float(lp_j(jnp.asarray(sr), jnp.asarray(hr), mask=_j(mask)))
    got = float(lp_t(_t(sr), _t(hr), mask=_t(mask)))
    assert abs(got - ref) <= LPIPS_RTOL * abs(ref)
    d_j, d_t = JaxDISTS(), DISTS()
    ref = float(d_j(jnp.asarray(sr), jnp.asarray(hr)))
    got = float(d_t(_t(sr), _t(hr)))
    # DISTS is 1 - a score near 1: two ULPs of 1 (test_torch_losses_dsl)
    assert abs(got - ref) <= 2 * np.spacing(np.float32(0.5))
    ref = float(jax_brisque.brisque(jnp.asarray(sr)))
    got = float(port_brisque.brisque(_t(sr)))
    assert abs(got - ref) <= SCORE_RTOL * abs(ref)
    monkeypatch.delenv('SRTPU_WEIGHTS_DIR')
    fallback = float(port_brisque.brisque(_t(sr)))
    assert abs(fallback - got) > SCORE_RTOL * abs(got)  # the SVR was read


def test_validate_matches_srtpu(tmp_path):
    """``Trainer.validate`` with BRISQUE and PSNR on srtpu's
    tiny EDSR (the same weights through the converter), the eval set's
    second image bucket-padded: every mean within its metric's
    tolerance, BRISQUE on the true shapes."""
    from srtpu.data import SRData as JaxSRData
    from srtpu.train import Trainer as JaxTrainer
    from srtpu.train import TrainerConfig as JaxTrainerConfig
    from srtpu_torch.data import SRData
    from srtpu_torch.train import Trainer, TrainerConfig
    from test_torch_fit_val import jax_initial, port_model, write_sets
    datasets = write_sets(tmp_path, n_train=1)
    jm, state = jax_initial()
    names = ['BRISQUE', 'PSNR']
    jt = JaxTrainer(JaxTrainerConfig(default_root_dir=str(tmp_path / 'j'),
                                     metrics=tuple(names)))
    try:
        ref = jt.validate(state, JaxSRData(
            datasets_dir=str(datasets), eval_datasets=['Val'],
            scale_factor=4, batch_size=1, num_workers=1))
    finally:
        jt.close()
    tt = Trainer(TrainerConfig(default_root_dir=str(tmp_path / 't'),
                               metrics=tuple(names)))
    try:
        got = tt.validate(port_model(state.params), SRData(
            datasets_dir=str(datasets), eval_datasets=['Val'],
            scale_factor=4))
    finally:
        tt.close()
    assert got.keys() == ref.keys()
    tol = {'Val/BRISQUE': SCORE_RTOL * abs(ref['Val/BRISQUE']),
           'Val/PSNR': 1e-4}
    for k in ref:
        assert abs(got[k] - ref[k]) <= tol[k], (k, got[k], ref[k])


def test_validate_scores_brisque_once_on_the_true_shape(tmp_path,
                                                        monkeypatch):
    """The Trainer's val pass scores BRISQUE once an image, on the SR
    cropped to the image's true HR shape, not on the padded bucket (the
    eval set's HR 64 x 80 and 72 x 56 are padded to 128 x 128)."""
    from srtpu_torch.data import SRData
    from srtpu_torch.models import create_model
    from srtpu_torch.train import Trainer, TrainerConfig
    from test_torch_fit_val import KW, write_sets
    datasets = write_sets(tmp_path, n_train=1)
    seen = []
    real = metrics.brisque

    def counted(sr):
        seen.append(tuple(sr.shape))
        return real(sr)
    monkeypatch.setattr(metrics, 'brisque', counted)
    model = create_model('EDSR', scale_factor=4,
                         generator=torch.Generator().manual_seed(0), **KW)
    tt = Trainer(TrainerConfig(default_root_dir=str(tmp_path / 't'),
                               metrics=('PSNR', 'BRISQUE')))
    try:
        got = tt.validate(model, SRData(datasets_dir=str(datasets),
                                        eval_datasets=['Val'],
                                        scale_factor=4))
    finally:
        tt.close()
    assert sorted(seen) == [(1, 64, 80, 3), (1, 72, 56, 3)]
    assert list(got) == ['Val/BRISQUE', 'Val/PSNR']
