"""The port's tiled inference (srtpu_torch.train.tiled and the tiled
steps) against srtpu's on the CPU, f32.

(a) ``_anchors`` equal to srtpu's on a table of (size, tile, stride);
(b) the host ``tiled_predict`` equal to srtpu's with one forward shared
    by both (the converted tiny EDSR, on numpy tiles): bit for bit, the
    stitching being the only code under test;
(c) ``make_tiled_apply`` against srtpu's, each side with its own forward
    of the same weights (srtpu's EDSR.apply, the port's converted EDSR):
    within 1e-5 (f32 sums in another order), over a batch of two ragged
    images and a sub-tile image;
(d) exact interiors: with ``overlap`` at least ``receptive_field_radius``
    the tiled SR equals the direct forward within 1e-5;
(e) ``_route_tiled`` and the gate equal to srtpu's on a table of shapes
    (srtpu's plans opted in off the TPU, ``SRTPU_CS_OFF_TPU=1``; the port
    has no backend check); RCAN is never routed to tiles;
(f) ``make_tiled_eval_step`` / ``make_tiled_predict_step`` against
    srtpu's (tiled against tiled, the seams being an approximation, F2):
    SR within 1e-5, metrics within 1e-4 dB / 1e-5; then the Trainer's
    tiled validate and its three predict routes (tiled step, host tiles,
    direct) against the same computations on srtpu's side, PNGs within
    +-1 uint8 level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from srtpu.metrics import build_metrics as jax_build_metrics
from srtpu.models import create_model as jax_create_model
from srtpu.optim import build_optimizer
from srtpu.train import Trainer as JaxTrainer
from srtpu.train import create_train_state
from srtpu.train import steps as jax_steps
from srtpu.train import tiled as jax_tiled
from srtpu_torch.convert import params_from_jax
from srtpu_torch.data import SRData
from srtpu_torch.metrics import build_metrics
from srtpu_torch.models import create_model
from srtpu_torch.train import (Trainer, TrainerConfig, make_tiled_eval_step,
                               make_tiled_predict_step, tiled)

torch.set_num_threads(1)

KW = dict(n_feats=16, n_resblocks=2)
METRICS = ('PSNR', 'SSIM')
TOL = {'PSNR': 1e-4, 'SSIM': 1e-5}


@pytest.fixture(scope='module')
def edsr():
    jm = jax_create_model('EDSR', scale_factor=4, **KW)
    state = create_train_state(jm, build_optimizer('ADAM', []),
                               jax.random.PRNGKey(2),
                               jnp.zeros((1, 16, 16, 3)))
    model = create_model('EDSR', scale_factor=4,
                         generator=torch.Generator().manual_seed(0), **KW)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), {'params': state.params})))
    return jm, state, model.eval()


def _img(shape, seed):
    rng = np.random.default_rng(seed)
    b, h, w, c = shape
    lo = rng.random((b, h // 4 + 1, w // 4 + 1, c))
    x = np.kron(lo, np.ones((1, 4, 4, 1)))[:, :h, :w] * 0.8 \
        + rng.random(shape) * 0.2
    return x.astype(np.float32)


@pytest.mark.parametrize('size,tile,stride', [
    (10, 32, 16), (32, 32, 16), (33, 32, 16), (100, 32, 16), (100, 40, 24),
    (128, 80, 64), (512, 80, 64), (352, 80, 64), (97, 64, 16), (64, 64, 0)])
def test_anchors_match_srtpu(size, tile, stride):
    if stride == 0:
        stride = 1
    assert tiled._anchors(size, tile, stride) == \
        jax_tiled._anchors(size, tile, stride)


def test_tiled_predict_matches_srtpu(edsr):
    _, _, model = edsr

    def forward(t):
        with torch.inference_mode():
            return model(torch.from_numpy(np.ascontiguousarray(t))).numpy()

    lr = _img((1, 45, 70, 3), 1)[0]
    for tile, overlap in ((32, 8), (24, 4), (64, 8)):
        got = tiled.tiled_predict(forward, lr, 4, tile=tile, overlap=overlap)
        ref = jax_tiled.tiled_predict(forward, lr, 4, tile=tile,
                                      overlap=overlap)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('shape,tile,overlap,batch', [
    ((2, 40, 53, 3), (24, 32), 4, 4), ((1, 20, 18, 3), (24, 24), 4, 16),
    ((1, 50, 50, 3), (32, 32), 8, 3)])
def test_tiled_apply_matches_srtpu(edsr, shape, tile, overlap, batch):
    jm, state, model = edsr
    lr = _img(shape, sum(shape))
    th, tw = tile
    ref = jax_tiled.make_tiled_apply(4, th, tw, overlap, batch)(
        lambda t: state.apply_fn({'params': state.params}, t, train=False),
        jnp.asarray(lr))
    seen = []

    def forward(t):
        seen.append(t.shape[0])
        return model(t)

    with torch.inference_mode():
        got = tiled.make_tiled_apply(4, th, tw, overlap, batch)(
            forward, torch.from_numpy(lr))
    assert tuple(got.shape) == ref.shape == (shape[0], 4 * shape[1],
                                              4 * shape[2], 3)
    assert max(seen) <= batch and len(set(seen)) == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def test_exact_interiors(edsr):
    _, _, model = edsr
    radius = tiled.receptive_field_radius(model)
    assert radius == jax_tiled.receptive_field_radius(
        type('M', (), {'n_resblocks': 2})())
    lr = torch.from_numpy(_img((1, 70, 150, 3), 4))
    with torch.inference_mode():
        direct = model(lr)
        got = tiled.make_tiled_apply(4, 2 * radius + 16, 2 * radius + 16,
                                     radius, 4)(model, lr)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=0,
                               atol=1e-5)


SHAPES = [(1, 32, 32), (1, 64, 64), (1, 80, 80), (1, 96, 96), (1, 91, 91),
          (1, 128, 128), (1, 64, 130), (1, 512, 352), (1, 256, 192),
          (16, 80, 80), (16, 32, 32), (2, 67, 45), (1, 42, 42),
          (4, 42, 42), (1, 100, 83), (1, 250, 170)]


@pytest.mark.parametrize('n_feats', [16, 64, 24])
def test_route_tiled_matches_srtpu(monkeypatch, n_feats):
    monkeypatch.setenv('SRTPU_CS_OFF_TPU', '1')
    model = type('M', (), {'n_feats': n_feats, 'use_pallas': 'cs',
                           'scale_factor': 4})()
    trainer = Trainer(TrainerConfig(eval_tile=80))
    decisions = []
    for b, h, w in SHAPES:
        shape = (b, h, w, 3)
        ref = JaxTrainer._route_tiled(None, model, shape)
        assert trainer._route_tiled(model, shape) == ref, shape
        assert tiled.route_tiled(shape, n_feats) == ref
        decisions.append(ref)
    # srtpu's eval routing at 64 features: a full 512 x 352 LR is tiled,
    # the 16 x 80 x 80 tile batch has a direct plan
    if n_feats == 64:
        assert decisions[SHAPES.index((1, 512, 352))]
        assert not decisions[SHAPES.index((16, 80, 80))]
    from srtpu.ops import cs_conv
    for b, h, w in SHAPES:
        for c in (16, 24, 64):
            assert tiled.cs_plan((b, h, w, c)) == cs_conv.cs_plan((b, h, w, c))
            assert tiled.cs_plan_pad((b, h, w, c)) == \
                cs_conv.cs_plan_pad((b, h, w, c))


def test_gate_matches_srtpu_and_rcan_never_tiles(monkeypatch):
    monkeypatch.setenv('SRTPU_CS_OFF_TPU', '1')
    jax_trainer = JaxTrainer.__new__(JaxTrainer)
    for tile in (0, 80):
        jax_trainer.cfg = type('C', (), {'eval_tile': tile,
                                         'eval_tile_overlap': 8})()
        trainer = Trainer(TrainerConfig(eval_tile=tile))
        for name, kw in (('EDSR', KW), ('EDSR', dict(KW, use_pallas=True)),
                         ('RCAN', dict(KW, n_resgroups=1, reduction=4)),
                         ('SRResNet', KW), ('SRCNN', {}), ('RDN', {}),
                         ('DDBPN', dict(n0=32, nr=16, depth=3)),
                         ('WDSR', dict(KW, use_pallas='cs')),
                         ('WDSR', KW)):
            jm = jax_create_model(name, scale_factor=4, **kw)
            model = create_model(name, scale_factor=4,
                                 generator=torch.Generator(), **kw)
            ref = jax_trainer._tiled_gate(jm)
            assert trainer._tiled_gate(model) == ref, (name, kw, tile)
            if name == 'RCAN' or tile == 0:
                assert ref is None


@pytest.mark.parametrize('tile,overlap', [(32, 8), ((24, 40), 4)])
def test_tiled_steps_match_srtpu(edsr, tile, overlap):
    _, state, model = edsr
    lr = _img((1, 56, 72, 3), 6)
    hr = _img((1, 224, 288, 3), 7)
    mask = np.zeros((1, 224, 288, 1), np.float32)
    mask[:, :210, :270] = 1.0
    ref_eval = jax_steps.make_tiled_eval_step(
        jax_build_metrics(list(METRICS)), 4, tile, overlap)
    ref_pred = jax_steps.make_tiled_predict_step(4, tile, overlap)
    sr_ref, res_ref = ref_eval(state, jnp.asarray(lr), jnp.asarray(hr),
                               jnp.asarray(mask))
    t = torch.from_numpy
    sr, res = make_tiled_eval_step(model, build_metrics(METRICS), 4, tile,
                                   overlap)(t(lr), t(hr), t(mask))
    np.testing.assert_allclose(sr.numpy(), np.asarray(sr_ref), rtol=0,
                               atol=1e-5)
    for k in METRICS:
        assert abs(float(res[k]) - float(res_ref[k])) <= TOL[k], k
    pred = make_tiled_predict_step(model, 4, tile, overlap)(t(lr))
    np.testing.assert_allclose(pred.numpy(), np.asarray(
        ref_pred(state, jnp.asarray(lr))), rtol=0, atol=1e-5)


def _png(path):
    return np.asarray(Image.open(path).convert('RGB'), dtype=np.int16)


def test_trainer_tiled_routes_match_srtpu(edsr, tmp_path):
    """validate with eval_tile routes the bucket-padded 128 x 96 LR (past
    srtpu's lane budget) to the tiled step; predict's three routes: the
    tiled step (LR edge-padded to eval_tile multiples), host tiles, and
    the direct forward, each against srtpu's computation of it."""
    jm, state, model = edsr
    root = tmp_path / 'datasets'
    val = root / 'Val'
    (val / 'HR').mkdir(parents=True)
    (val / 'LR' / 'X4').mkdir(parents=True)
    lr = _img((1, 100, 90, 3), 8)[0]
    hr = _img((1, 400, 360, 3), 9)[0]
    np.save(val / 'HR' / 'a.npy', hr)
    np.save(val / 'LR' / 'X4' / 'a.npy', lr)
    # an overlap below the receptive radius, so the seams show
    cfg = dict(eval_tile=40, eval_tile_overlap=2)
    got = Trainer(TrainerConfig(
        default_root_dir=str(tmp_path / 'val_tiled'), metrics=METRICS,
        **cfg)).validate(
        model, SRData(datasets_dir=str(root), eval_datasets=['Val']))
    # srtpu's tiled step on the same bucket-padded batch
    lr_p = np.pad(lr, ((0, 28), (0, 6), (0, 0)), mode='edge')[None]
    hr_p = np.pad(hr, ((0, 112), (0, 24), (0, 0)), mode='edge')[None]
    mask = np.zeros((1, 512, 384, 1), np.float32)
    mask[:, :400, :360] = 1.0
    _, ref = jax_steps.make_tiled_eval_step(
        jax_build_metrics(list(METRICS)), 4, 40, 2)(
        state, jnp.asarray(lr_p), jnp.asarray(hr_p), jnp.asarray(mask))
    for k in METRICS:
        assert abs(got[f'Val/{k}'] - float(ref[k])) <= TOL[k], k
    # without eval_tile: the direct step, which differs at the seams
    direct = Trainer(TrainerConfig(
        default_root_dir=str(tmp_path / 'val_direct'),
        metrics=METRICS)).validate(
        model, SRData(datasets_dir=str(root), eval_datasets=['Val']))
    assert direct['Val/PSNR'] != got['Val/PSNR']

    routes = {'tiled': dict(cfg), 'host': dict(predict_tile=48,
                                               predict_tile_overlap=8),
              'direct': {}}
    predict_step = jax_steps.make_predict_step()
    src = np.pad(lr, ((0, 20), (0, 30), (0, 0)), mode='edge')[None]
    refs = {
        'tiled': np.asarray(jax_steps.make_tiled_predict_step(4, 40, 2)(
            state, jnp.asarray(src)))[0, :400, :360],
        'host': jax_tiled.tiled_predict(
            lambda t: np.asarray(predict_step(state, jnp.asarray(t))),
            lr, 4, tile=48, overlap=8)[:400, :360],
        'direct': np.asarray(predict_step(state, jnp.asarray(
            np.pad(lr, ((0, 28), (0, 6), (0, 0)), mode='edge')[None])))[
            0, :400, :360]}
    from srtpu.utils.logging import save_image as jax_save_image
    for route, kw in routes.items():
        out = tmp_path / route
        Trainer(TrainerConfig(default_root_dir=str(out), **kw)).predict(
            model, SRData(datasets_dir=str(root), predict_datasets=['Val'],
                          scale_factor=4))
        jax_save_image(refs[route], tmp_path / f'{route}_ref.png')
        port, want = _png(out / 'Val' / 'a.png'), _png(
            tmp_path / f'{route}_ref.png')
        assert port.shape == want.shape == (400, 360, 3)
        assert np.abs(port - want).max() <= 1, route
    assert np.abs(_png(tmp_path / 'tiled' / 'Val' / 'a.png')
                  - _png(tmp_path / 'direct' / 'Val' / 'a.png')).max() > 0
