"""The port's training data path against srtpu's on the CPU.

(a) TrainLoader: the port's batches are bit-identical to srtpu's for a
    seed, over two epochs, with and without drop_remainder, through
    SRData and directly; ``peek`` too;
(b) sources: .npy and PNG folders with LR/X{scale}, HR-only folders
    whose LR is synthesized (Pillow bicubic, as srtpu), and
    concatenated datasets give srtpu's arrays exactly; without Pillow a
    missing LR raises a clear error;
(c) setup errors;
(d) the on-disk decode cache (every case points ``SRTPU_DECODE_CACHE``
    at its own ``tmp_path``): a miss writes the raw decode, a hit reads
    it, a torn entry is decoded again and rewritten, ``0`` / ``off``
    writes nothing, and a cached item equals an uncached one and srtpu's
    bit for bit; the synthesized LR's entry carries its algorithm tag, so
    an entry under srtpu's untagged key is not read as the port's;
(e) srtpu's loader knobs: YAML ``data.num_workers``, ``prefetch`` and
    ``cache_train_images`` reach the loader through ``build_all`` and
    ``SRData``, as srtpu's; ``Trainer.fit`` with ``num_workers`` 3 and
    ``prefetch`` 1 ends at srtpu's weights (within 1e-4 of each tensor's
    largest magnitude, as ``test_torch_train``'s fit).
"""

import logging
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


# ---------------------------------------------------------- decode cache

def _png_item(tmp_path, with_lr=True):
    root = _dataset(tmp_path, 'A', SIZES[:2], fmt='png', with_lr=with_lr)
    return root / 'A' / 'HR', (root / 'A' / 'LR' / 'X4' if with_lr
                               else None)


def _entries(cache):
    return sorted(p.name for p in cache.iterdir()) if cache.exists() else []


def test_decode_cache_miss_hit_and_uncached_equal(tmp_path, monkeypatch):
    hr_dir, lr_dir = _png_item(tmp_path)
    path = sorted(hr_dir.iterdir())[0]
    monkeypatch.setenv('SRTPU_DECODE_CACHE', 'off')
    uncached = sources.load_image(path)
    cache = tmp_path / 'cache'
    monkeypatch.setenv('SRTPU_DECODE_CACHE', str(cache))
    entry = sources.decode_cache_path(path)
    assert entry.parent == cache and not entry.exists()
    first = sources.load_image(path)            # a miss: decoded, stored
    assert entry.exists() and np.load(entry).dtype == np.uint8
    second = sources.load_image(path)           # a hit
    for got in (first, second):
        np.testing.assert_array_equal(got, uncached)
    np.testing.assert_array_equal(first, jax_sources._load_image(path))
    # the hit reads the entry, not the file
    np.save(entry, np.full((2, 2, 3), 255, np.uint8))
    np.testing.assert_array_equal(sources.load_image(path),
                                  np.ones((2, 2, 3), np.float32))
    # a source over the folder: every item as the uncached source's
    cached = sources.ImageFolderSource(hr_dir, lr_dir, 4)
    monkeypatch.setenv('SRTPU_DECODE_CACHE', '0')
    plain = sources.ImageFolderSource(hr_dir, lr_dir, 4)
    for i in (1,):
        for a, b in zip(cached.get(i), plain.get(i)):
            np.testing.assert_array_equal(a, b)


def test_decode_cache_torn_entry_is_decoded_again(tmp_path, monkeypatch,
                                                   caplog):
    hr_dir, _ = _png_item(tmp_path)
    path = sorted(hr_dir.iterdir())[0]
    monkeypatch.setenv('SRTPU_DECODE_CACHE', str(tmp_path / 'cache'))
    want = sources.load_image(path)
    entry = sources.decode_cache_path(path)
    entry.write_bytes(entry.read_bytes()[:100])     # torn mid-write
    with caplog.at_level(logging.WARNING, logger=sources.__name__):
        np.testing.assert_array_equal(sources.load_image(path), want)
    assert 'unreadable decode-cache entry' in caplog.text
    np.testing.assert_array_equal(np.load(entry).astype(np.float32) / 255,
                                  want)             # written again


@pytest.mark.parametrize('off', ['0', 'off'])
def test_decode_cache_off_writes_nothing(tmp_path, monkeypatch, off):
    hr_dir, lr_dir = _png_item(tmp_path, with_lr=False)
    monkeypatch.setenv('HOME', str(tmp_path / 'home'))
    monkeypatch.setenv('SRTPU_DECODE_CACHE', off)
    assert sources.decode_cache_dir() is None
    src = sources.ImageFolderSource(hr_dir, None, 4)
    src.get(0)
    assert not (tmp_path / 'home').exists()
    monkeypatch.setenv('SRTPU_DECODE_CACHE', '')
    assert sources.decode_cache_dir() == \
        tmp_path / 'home' / '.cache' / 'srtpu' / 'decoded'


def test_synthesized_lr_entry_carries_its_algorithm_tag(tmp_path,
                                                        monkeypatch):
    """An HR-only image folder's LR is cached raw under a key naming
    Pillow's bicubic and uint8; srtpu's untagged ``-x4lr`` entry (here
    holding something else) is not read as it."""
    hr_dir, _ = _png_item(tmp_path, with_lr=False)
    path = sorted(hr_dir.iterdir())[0]
    cache = tmp_path / 'cache'
    monkeypatch.setenv('SRTPU_DECODE_CACHE', str(cache))
    untagged = sources.decode_cache_path(path, '-x4lr')
    cache.mkdir()
    stale = np.zeros((16, 20, 3), np.uint8)
    np.save(untagged, stale)
    ref = jax_sources.ImageFolderSource(hr_dir, None, 4)
    lr, hr, _ = sources.ImageFolderSource(hr_dir, None, 4).get(0)
    np.testing.assert_array_equal(ref.get(0)[0], 0)    # srtpu reads it
    monkeypatch.setenv('SRTPU_DECODE_CACHE', 'off')
    want_lr, want_hr, _ = jax_sources.ImageFolderSource(hr_dir, None,
                                                        4).get(0)
    np.testing.assert_array_equal(lr, want_lr)
    np.testing.assert_array_equal(hr, want_hr)
    assert lr.max() > 0
    monkeypatch.setenv('SRTPU_DECODE_CACHE', str(cache))
    entry = sources.decode_cache_path(path, f'-x4lr-{sources.LR_TAG}')
    assert sources.LR_TAG == 'pil-bicubic-u8' and entry.exists()
    assert np.load(entry).dtype == np.uint8
    np.testing.assert_array_equal(np.load(entry).astype(np.float32) / 255,
                                  lr)
    np.testing.assert_array_equal(np.load(untagged), stale)


# ------------------------------------------------------------ the knobs

def test_yaml_loader_knobs_reach_the_loader(tmp_path):
    from srtpu import config as jax_config
    from srtpu_torch import config
    from test_torch_config import DEFAULT, OVERRIDES
    from test_torch_fit_val import write_sets
    datasets = write_sets(tmp_path, n_train=2)
    over = OVERRIDES + [f'data.datasets_dir={datasets}',
                        'data.train_datasets=[Train]', 'data.patch_size=32',
                        'data.scale_factor=4', 'data.num_workers=3',
                        'data.prefetch=1', 'data.cache_train_images=false']
    _, dm, _, fit_kw = config.build_all(config.load_config([DEFAULT], over))
    _, jdm, _, jfit_kw = jax_config.build_all(
        jax_config.load_config([DEFAULT], over))
    assert (dm.num_workers, dm.prefetch, dm.cache_train_images) == \
        (jdm._num_workers, jdm._prefetch, jdm._cache_train) == (3, 1, False)
    dm.setup('fit')
    jdm.setup('fit')
    got, ref = dm.train_loader(), jdm.train_loader()
    assert (got._workers, got._prefetch) == (ref._workers, ref._prefetch) \
        == (3, 1)
    assert got._source._sources[0]._cache is None
    assert not ref._source._sources[0]._cache_enabled
    _assert_same_batches(list(got), list(ref))
    on = SRData(datasets_dir=str(datasets), train_datasets=['Train'])
    on.setup('fit')                 # srtpu's default: the RAM cache on
    assert on._train_source._sources[0]._cache == {}


def test_fit_with_item_threads_matches_srtpu(tmp_path):
    """``Trainer.fit`` on ``SRData(num_workers=3, prefetch=1)`` against
    srtpu's ``Trainer.fit`` with the same knobs, from the same state."""
    from srtpu.train import Trainer as JaxTrainer
    from srtpu.train import TrainerConfig as JaxTrainerConfig
    from srtpu_torch.train import Trainer, TrainerConfig
    from test_torch_fit_val import (OPT, SEED, assert_params_close,
                                    jax_initial, port_model, write_sets)
    datasets = write_sets(tmp_path)
    jm, state = jax_initial()
    model = port_model(state.params)
    kw = dict(batch_size=2, datasets_dir=str(datasets), eval_datasets=[],
              patch_size=32, scale_factor=4, train_datasets=['Train'],
              seed=SEED, num_workers=3, prefetch=1)
    cfg = dict(max_epochs=2, num_sanity_val_steps=0,
               enable_checkpointing=False)
    trainer = JaxTrainer(JaxTrainerConfig(
        default_root_dir=str(tmp_path / 'jax'), seed=SEED, **cfg))
    try:
        ref = trainer.fit(jm, JaxSRData(**kw), losses='l1',
                          optimizer_name='ADAM', optimizer_params=OPT,
                          state=state)
    finally:
        trainer.close()
    port = Trainer(TrainerConfig(default_root_dir=str(tmp_path / 'port'),
                                 **cfg))
    try:
        port.fit(model, SRData(**kw), losses='l1', optimizer_name='ADAM',
                 optimizer_params=OPT)
    finally:
        port.close()
    assert port.global_step == trainer.global_step == 6
    log = (tmp_path / 'port' / 'run.log').read_text()
    assert 'train loader: the native core, batches on the host' in log
    assert_params_close(model.state_dict(), ref.params)
