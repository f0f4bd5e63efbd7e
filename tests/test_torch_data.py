"""The port's training data path against srtpu's on the CPU.

(a) TrainLoader: the port's batches are bit-identical to srtpu's for a
    seed, over two epochs, with and without drop_remainder, through
    SRData and directly; ``peek`` too;
(b) sources: .npy and PNG folders with LR/X{scale}, HR-only folders
    whose LR is synthesized (Pillow bicubic, as srtpu), and
    concatenated datasets give srtpu's arrays exactly; without Pillow a
    missing LR raises a clear error;
(c) setup errors.
"""

import sys

import numpy as np
import pytest
from PIL import Image

from srtpu.data import SRData as JaxSRData
from srtpu.data import pipeline as jax_pipeline
from srtpu.data import sources as jax_sources
from srtpu_torch.data import SRData, TrainLoader
from srtpu_torch.data import sources


def _smooth(rng, h, w):
    lo = rng.random((h // 4 + 1, w // 4 + 1, 3))
    return np.kron(lo, np.ones((4, 4, 1)))[:h, :w].astype(np.float32)


def _dataset(root, name, sizes, fmt='npy', with_lr=True, scale=4, seed=0):
    hr_dir = root / name / 'HR'
    lr_dir = root / name / 'LR' / f'X{scale}'
    hr_dir.mkdir(parents=True)
    if with_lr:
        lr_dir.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate(sizes):
        hr = _smooth(rng, h, w)
        lr = hr.reshape(h // scale, scale, w // scale, scale, 3).mean((1, 3))
        for d, img in ((hr_dir, hr), (lr_dir, lr)):
            if d is lr_dir and not with_lr:
                continue
            if fmt == 'npy':
                np.save(d / f'{i:02d}.npy', img.astype(np.float32))
            else:
                Image.fromarray((img * 255 + 0.5).astype(np.uint8)) \
                    .save(d / f'{i:02d}.png')
    return root


SIZES = [(64, 80), (48, 48), (64, 64), (80, 48), (52, 60)]


def _assert_same_batches(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.lr, r.lr)
        np.testing.assert_array_equal(g.hr, r.hr)
        assert tuple(g.names) == tuple(r.names)


def test_train_loader_matches_srtpu_through_srdata(tmp_path):
    root = _dataset(tmp_path, 'Train', SIZES)
    kw = dict(batch_size=2, datasets_dir=str(root), patch_size=32,
              scale_factor=4, train_datasets=['Train'], seed=11)
    ref_dm = JaxSRData(eval_datasets=[], num_workers=1, **kw)
    ref_dm.setup('fit')
    dm = SRData(**kw)
    dm.setup('fit')
    ref, got = ref_dm.train_loader(), dm.train_loader()
    assert len(got) == len(ref) == 2
    for epoch in range(2):
        ref.set_epoch(epoch)
        got.set_epoch(epoch)
        _assert_same_batches(list(got), list(ref))
    _assert_same_batches([got.peek()], [ref.peek()])


def test_srdata_augment_reaches_the_loader(tmp_path):
    """``SRData(augment=False)`` gives srtpu's unaugmented batches."""
    root = _dataset(tmp_path, 'Train', SIZES)
    kw = dict(batch_size=2, datasets_dir=str(root), patch_size=32,
              scale_factor=4, train_datasets=['Train'], seed=11,
              augment=False)
    ref_dm = JaxSRData(eval_datasets=[], num_workers=1, **kw)
    ref_dm.setup('fit')
    dm = SRData(**kw)
    dm.setup('fit')
    _assert_same_batches(list(dm.train_loader()),
                         list(ref_dm.train_loader()))
    aug = SRData(**dict(kw, augment=True))
    aug.setup('fit')
    assert any(not np.array_equal(a.lr, b.lr) for a, b in zip(
        aug.train_loader(), dm.train_loader()))


@pytest.mark.parametrize('drop', [True, False])
@pytest.mark.parametrize('augment', [True, False])
def test_train_loader_matches_srtpu_direct(tmp_path, drop, augment):
    """Epochs advance on their own after each pass, as srtpu's do."""
    root = _dataset(tmp_path, 'Train', SIZES)
    hr, lr = root / 'Train' / 'HR', root / 'Train' / 'LR' / 'X4'
    ref = jax_pipeline.TrainLoader(
        jax_sources.NpySource(hr, lr, 4), 2, 16, 4, augment=augment, seed=3,
        drop_remainder=drop, process_index=0, process_count=1,
        num_workers=1)
    got = TrainLoader(sources.NpySource(hr, lr, 4), 2, 16, 4,
                      augment=augment, seed=3, drop_remainder=drop)
    assert len(got) == len(ref) == (2 if drop else 3)
    for _ in range(2):
        _assert_same_batches(list(got), list(ref))


@pytest.mark.parametrize('fmt,with_lr', [('png', True), ('png', False),
                                         ('npy', False)])
def test_sources_match_srtpu(tmp_path, fmt, with_lr):
    root = _dataset(tmp_path, 'A', SIZES[:3], fmt=fmt, with_lr=with_lr)
    _dataset(tmp_path, 'B', SIZES[3:], fmt='npy', seed=1)
    lr_dir = root / 'A' / 'LR' / 'X4' if with_lr else None
    ref_cls = {'png': jax_sources.ImageFolderSource,
               'npy': jax_sources.NpySource}[fmt]
    got_cls = {'png': sources.ImageFolderSource,
               'npy': sources.NpySource}[fmt]
    b = (root / 'B' / 'HR', root / 'B' / 'LR' / 'X4')
    ref = jax_sources.ConcatSource([ref_cls(root / 'A' / 'HR', lr_dir, 4),
                                    jax_sources.NpySource(*b, 4)])
    got = sources.ConcatSource([got_cls(root / 'A' / 'HR', lr_dir, 4),
                                sources.NpySource(*b, 4)])
    assert len(got) == len(ref) == 5
    for i in range(5):
        (glr, ghr, gname), (rlr, rhr, rname) = got.get(i), ref.get(i)
        assert gname == rname and glr.dtype == ghr.dtype == np.float32
        np.testing.assert_array_equal(glr, rlr)
        np.testing.assert_array_equal(ghr, rhr)


def test_missing_lr_without_pillow_raises(tmp_path, monkeypatch):
    root = _dataset(tmp_path, 'A', SIZES[:1], with_lr=False)
    src = sources.NpySource(root / 'A' / 'HR', None, 4)
    monkeypatch.setitem(sys.modules, 'PIL', None)
    with pytest.raises(RuntimeError, match='needs Pillow'):
        src.get(0)


def test_setup_errors(tmp_path):
    with pytest.raises(FileNotFoundError, match='HR images'):
        SRData(datasets_dir=str(tmp_path), train_datasets=['X']).setup('fit')
    with pytest.raises(ValueError, match='divisible'):
        TrainLoader(sources.ConcatSource([]), 2, 30, 4)
    with pytest.raises(FileNotFoundError, match='HR images'):
        SRData(datasets_dir=str(tmp_path),
               eval_datasets=['X']).setup('validate')
    with pytest.raises(ValueError, match='stage'):
        SRData().setup('test')
    with pytest.raises(RuntimeError, match='setup'):
        SRData().eval_loaders()
    with pytest.raises(RuntimeError, match='setup'):
        SRData().train_loader()
