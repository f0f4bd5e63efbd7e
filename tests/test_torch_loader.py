"""The port's training loader against srtpu's on the CPU.

(a) the native core (``srtpu_torch/data/csrc/patchops.cc``, built into
    ``build/srtpu_torch/``) against srtpu's ``srtpu.data.native`` and
    against numpy: ``extract_patch_pair`` for all 16 transforms and HR
    sizes that are not a multiple of the scale, ``extract_patch_batch``
    threaded against serial, the bicubic downscale (uint8 and float32)
    against srtpu's native and Pillow. Crops and augments move values
    without arithmetic, so they are held bit for bit; the bicubic
    computes the same double sums as srtpu's (bit for bit), and Pillow's
    function up to its rounding of the first pass (one uint8 step; 1e-5
    in float32);
(b) ``TrainLoader`` against srtpu's, bit for bit over two epochs, for
    every combination of ``num_workers`` 1 and 3, ``prefetch`` 1 and 2,
    ``(process_index, process_count)`` (0, 1), (0, 2) and (1, 2), with
    and without augment and drop, on each core; ``prefetch`` 0 and the
    auto worker count; ``peek``;
(c) the producer: an abandoned iterator leaves no live producer, a
    source's error reaches the consumer, many item threads under a short
    switch interval give the same batches; a failed native build is
    logged, leaves the numpy core, and raises where the native core is
    called.
"""

import logging
import os
import sys
import threading

import numpy as np
import pytest
from PIL import Image

from srtpu.data import native as jax_native
from srtpu.data import pipeline as jax_pipeline
from srtpu.data import sources as jax_sources
from srtpu_torch.data import native
from srtpu_torch.data import pipeline, sources

PRODUCER = 'srtpu-torch-train-producer'
SIZES = [(64, 80), (48, 48), (64, 64), (80, 48), (52, 60), (56, 72),
         (48, 64)]


def _numpy_transform(a, rot, hflip, vflip):
    a = np.rot90(a, rot, axes=(0, 1))
    if hflip:
        a = a[:, ::-1]
    if vflip:
        a = a[::-1, :]
    return np.ascontiguousarray(a)


@pytest.mark.parametrize('scale,patch,hr_extra', [(2, 8, (0, 0)),
                                                  (3, 9, (2, 1)),
                                                  (4, 16, (3, 2))])
def test_extract_patch_pair_all_transforms(scale, patch, hr_extra):
    """Every (rot, hflip, vflip) against numpy and srtpu's native, on HR
    sizes that are LR x scale plus ``hr_extra`` (the true row stride)."""
    rng = np.random.default_rng(scale)
    lp = patch // scale
    lr = rng.random((12, 14, 3)).astype(np.float32)
    hr = rng.random((12 * scale + hr_extra[0], 14 * scale + hr_extra[1],
                     3)).astype(np.float32)
    y, x = 3, 5
    for rot in range(4):
        for hflip in (False, True):
            for vflip in (False, True):
                outs = []
                for mod in (native, jax_native):
                    out_lr = np.empty((lp, lp, 3), np.float32)
                    out_hr = np.empty((patch, patch, 3), np.float32)
                    mod.extract_patch_pair(lr, hr, patch, scale, y, x, rot,
                                           hflip, vflip, out_lr, out_hr)
                    outs.append((out_lr, out_hr))
                want_lr = _numpy_transform(lr[y:y + lp, x:x + lp], rot,
                                           hflip, vflip)
                want_hr = _numpy_transform(
                    hr[scale * y:scale * y + patch,
                       scale * x:scale * x + patch], rot, hflip, vflip)
                for out_lr, out_hr in outs:
                    np.testing.assert_array_equal(out_lr, want_lr)
                    np.testing.assert_array_equal(out_hr, want_hr)


def _batch_case(seed=3, n=7, scale=2, patch=16):
    rng = np.random.default_rng(seed)
    lrs = [rng.random((20 + i, 22, 3)).astype(np.float32) for i in range(n)]
    hrs = [rng.random((scale * (20 + i) + i % 3, scale * 22 + 1, 3))
           .astype(np.float32) for i in range(n)]
    draws = [rng.integers(0, 5, n).astype(np.int32) for _ in range(2)] + \
        [rng.integers(0, k, n).astype(np.int32) for k in (4, 2, 2)]
    return lrs, hrs, draws, scale, patch


def _run_batch(mod, case, nthreads):
    lrs, hrs, draws, scale, patch = case
    n, lp = len(lrs), patch // scale
    out_lr = np.empty((n, lp, lp, 3), np.float32)
    out_hr = np.empty((n, patch, patch, 3), np.float32)
    mod.extract_patch_batch(lrs, hrs, patch, scale, *draws, out_lr, out_hr,
                            nthreads=nthreads)
    return out_lr, out_hr


@pytest.mark.parametrize('nthreads', [2, 3, 7, 16])
def test_extract_patch_batch_threaded_matches_serial_and_srtpu(nthreads):
    case = _batch_case()
    serial = _run_batch(native, case, 1)
    for got in (_run_batch(native, case, nthreads),
                _run_batch(jax_native, case, nthreads)):
        np.testing.assert_array_equal(got[0], serial[0])
        np.testing.assert_array_equal(got[1], serial[1])
    lrs, hrs, (ys, xs, rots, hfs, vfs), scale, patch = case
    lp = patch // scale
    for j in range(len(lrs)):
        y, x = ys[j], xs[j]
        np.testing.assert_array_equal(serial[0][j], _numpy_transform(
            lrs[j][y:y + lp, x:x + lp], rots[j], hfs[j], vfs[j]))
        np.testing.assert_array_equal(serial[1][j], _numpy_transform(
            hrs[j][scale * y:scale * y + patch, scale * x:scale * x + patch],
            rots[j], hfs[j], vfs[j]))


def test_native_wrappers_refuse_what_the_core_cannot_read():
    lrs, hrs, draws, scale, patch = _batch_case(n=2)
    lp = patch // scale
    out_lr = np.empty((2, lp, lp, 3), np.float32)
    out_hr = np.empty((2, patch, patch, 3), np.float32)
    with pytest.raises(ValueError, match='float32'):
        native.extract_patch_batch([a.astype(np.float64) for a in lrs], hrs,
                                   patch, scale, *draws, out_lr, out_hr)
    far = [d.copy() for d in draws]
    far[0][1] = 30                  # the crop leaves the image
    with pytest.raises(ValueError, match='leaves'):
        native.extract_patch_batch(lrs, hrs, patch, scale, *far, out_lr,
                                   out_hr)
    with pytest.raises(ValueError, match='slots'):
        native.extract_patch_batch(lrs, hrs, patch, scale, *draws,
                                   out_lr[:1], out_hr)


@pytest.mark.parametrize('scale', [2, 3, 4])
@pytest.mark.parametrize('shape', [(48, 64), (37, 50)])
def test_bicubic_matches_srtpu_native_and_pillow(scale, shape):
    """Bit for bit with srtpu's core on noise and on an image; against
    Pillow on the image, whose values (32-223) keep the passes' overshoot
    inside 0-255: Pillow rounds and clips its first pass to uint8 where
    the core keeps a float, so they agree to one step (uint8) or 1e-5
    (float32), and only on images that do not clip there."""
    rng = np.random.default_rng(scale + shape[0])
    noise = (rng.random((*shape, 3)) * 255).astype(np.uint8)
    lo = rng.random((shape[0] // 8 + 1, shape[1] // 8 + 1, 3))
    img = (32 + 191 * np.kron(lo, np.ones((8, 8, 1)))[:shape[0], :shape[1]]
           ).astype(np.uint8)
    for a in (noise, img, noise.astype(np.float32) / 255,
              img.astype(np.float32) / 255):
        ours = native.bicubic_downscale(a, scale)
        assert ours.dtype == a.dtype
        np.testing.assert_array_equal(ours,
                                      jax_native.bicubic_downscale(a, scale))
    oh, ow = shape[0] // scale, shape[1] // scale
    ours = native.bicubic_downscale(img, scale)
    pil = np.asarray(Image.fromarray(img).resize((ow, oh), Image.BICUBIC))
    assert ours.shape == pil.shape
    assert np.abs(ours.astype(int) - pil.astype(int)).max() <= 1
    f = img.astype(np.float32) / 255
    pil32 = np.stack([np.asarray(Image.fromarray(f[..., c], mode='F')
                                 .resize((ow, oh), Image.BICUBIC))
                      for c in range(3)], -1)
    np.testing.assert_allclose(native.bicubic_downscale(f, scale), pil32,
                               rtol=0, atol=1e-5)


def test_native_core_is_the_ports_own_build():
    """Built from the port's copy of the source into build/srtpu_torch/,
    keyed on the source, the flags and the CPU."""
    pkg = os.path.dirname(os.path.dirname(native.__file__))
    assert native.SOURCE.is_file()
    assert str(native.SOURCE).startswith(os.path.join(pkg, 'data', 'csrc'))
    assert native.available()
    lib = native.library_path()
    assert lib.parent == native.BUILD_DIR and lib.is_file()
    assert native.BUILD_DIR.parts[-2:] == ('build', 'srtpu_torch')
    assert native.get_lib()._name == str(lib)


# ----------------------------------------------------------- the loader

def _dataset(root, sizes=SIZES, scale=4, seed=0):
    hr_dir, lr_dir = root / 'HR', root / 'LR'
    hr_dir.mkdir(parents=True)
    lr_dir.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate(sizes):
        hr = rng.random((h, w, 3)).astype(np.float32)
        lr = hr[:h // scale * scale, :w // scale * scale].reshape(
            h // scale, scale, w // scale, scale, 3).mean((1, 3))
        np.save(hr_dir / f'{i:02d}.npy', hr)
        np.save(lr_dir / f'{i:02d}.npy', lr.astype(np.float32))
    return hr_dir, lr_dir


@pytest.fixture
def numpy_core(monkeypatch):
    """Both packages on their numpy cores."""
    monkeypatch.setattr(native, 'available', lambda: False)
    monkeypatch.setattr(jax_native, '_lib', None)
    monkeypatch.setattr(jax_native, '_tried', True)


def _pair(dirs, **kw):
    ref = jax_pipeline.TrainLoader(jax_sources.NpySource(*dirs, 4), 2, 16, 4,
                                   seed=3, **kw)
    got = pipeline.TrainLoader(sources.NpySource(*dirs, 4), 2, 16, 4, seed=3,
                               **kw)
    return ref, got


def _assert_same_epochs(got, ref, epochs=2):
    assert len(got) == len(ref)
    for _ in range(epochs):
        a, b = list(ref), list(got)
        assert len(a) == len(b) == len(ref)
        for r, g in zip(a, b):
            np.testing.assert_array_equal(g.lr, r.lr)
            np.testing.assert_array_equal(g.hr, r.hr)
            assert tuple(g.names) == tuple(r.names)


@pytest.mark.parametrize('core', ['native', 'numpy'])
@pytest.mark.parametrize('drop', [True, False])
@pytest.mark.parametrize('augment', [True, False])
@pytest.mark.parametrize('proc', [(0, 1), (0, 2), (1, 2)])
@pytest.mark.parametrize('prefetch', [1, 2])
@pytest.mark.parametrize('workers', [1, 3])
def test_loader_matches_srtpu(tmp_path, request, workers, prefetch, proc,
                              augment, drop, core):
    if core == 'numpy':
        request.getfixturevalue('numpy_core')
    ref, got = _pair(_dataset(tmp_path), augment=augment,
                     drop_remainder=drop, prefetch=prefetch,
                     process_index=proc[0], process_count=proc[1],
                     num_workers=workers)
    assert got.core == core
    _assert_same_epochs(got, ref)
    got.close()


def test_loader_unbounded_prefetch_and_auto_workers(tmp_path):
    """``prefetch`` 0 is an unbounded queue, as srtpu's; ``num_workers`` 0
    is ``max(1, cpu_count // 2)``."""
    ref, got = _pair(_dataset(tmp_path), prefetch=0, num_workers=0,
                     process_index=0, process_count=1)
    assert got._workers == max(1, (os.cpu_count() or 2) // 2)
    _assert_same_epochs(got, ref)


def _producers():
    return [t for t in threading.enumerate() if t.name == PRODUCER]


def test_peek_starts_no_thread(tmp_path):
    ref, got = _pair(_dataset(tmp_path), process_index=0, process_count=1)
    before = _producers()
    b = got.peek()
    assert _producers() == before
    r = ref.peek()
    np.testing.assert_array_equal(b.lr, r.lr)
    np.testing.assert_array_equal(b.hr, r.hr)


def _join_producers(timeout=10.0):
    for t in _producers():
        t.join(timeout)
    return _producers()


@pytest.mark.parametrize('prefetch', [1, 2, 0])
def test_abandoned_iterator_leaves_no_producer(tmp_path, prefetch):
    """A consumer that stops after one batch (limit_train_batches): the
    producer, blocked on the full queue or not, exits; the epoch moves on
    and the next epoch is srtpu's."""
    sizes = SIZES * 4
    dirs = _dataset(tmp_path, sizes)
    ref, got = _pair(dirs, prefetch=prefetch, process_index=0,
                     process_count=1, num_workers=2)
    it = iter(got)
    first = next(it)
    assert _producers()
    it.close()
    assert not _join_producers()
    r = next(iter(ref))
    np.testing.assert_array_equal(first.lr, r.lr)
    for _ in range(3):              # a for loop left by break
        for _ in got:
            break
    assert not _join_producers()
    assert got._epoch == 4
    ref.set_epoch(4)
    _assert_same_epochs(got, ref, epochs=1)


class _Failing(sources.Source):
    def __init__(self, inner, bad: int):
        self._inner, self._bad = inner, bad

    def __len__(self):
        return len(self._inner)

    def get(self, index):
        if index == self._bad:
            raise OSError(f'cannot read item {index}')
        return self._inner.get(index)


@pytest.mark.parametrize('workers', [1, 3])
def test_source_error_reaches_the_consumer(tmp_path, workers):
    src = _Failing(sources.NpySource(*_dataset(tmp_path), 4), bad=4)
    loader = pipeline.TrainLoader(src, 2, 16, 4, seed=3, num_workers=workers,
                                  drop_remainder=False)
    with pytest.raises(OSError, match='cannot read item 4'):
        for _ in range(2):
            list(loader)
    assert not _join_producers()


def test_items_in_ram_are_fetched_without_the_item_threads(tmp_path):
    """An epoch fills the sources' RAM cache on the item threads; the next
    fetches every item in turn, and both are srtpu's."""
    hr, lr = _dataset(tmp_path)
    ref = jax_pipeline.TrainLoader(jax_sources.NpySource(hr, lr, 4,
                                                         cache=True),
                                   2, 16, 4, seed=3, process_index=0,
                                   process_count=1, num_workers=3,
                                   drop_remainder=False)
    got = pipeline.TrainLoader(sources.NpySource(hr, lr, 4, cache=True),
                               2, 16, 4, seed=3, num_workers=3,
                               drop_remainder=False)
    threaded = []
    real = got._run_items
    got._run_items = lambda fn, n: (threaded.append(n), real(fn, n))
    _assert_same_epochs(got, ref, epochs=1)
    assert sum(threaded) == len(SIZES) and got._pool is not None
    threaded.clear()
    _assert_same_epochs(got, ref, epochs=1)
    assert threaded == [0, 0, 0, 0]
    got.close()


def test_many_item_threads_under_a_short_switch_interval(tmp_path):
    """More item threads than cores, the interpreter switching threads
    every microsecond: each thread writes its own slots, so the batches
    stay srtpu's."""
    ref, got = _pair(_dataset(tmp_path, SIZES * 3), process_index=0,
                     process_count=1, num_workers=2 * (os.cpu_count() or 2),
                     prefetch=1)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _assert_same_epochs(got, ref)
    finally:
        sys.setswitchinterval(old)
        got.close()


def test_failed_native_build_is_logged_and_raises(tmp_path, monkeypatch,
                                                  caplog):
    """A source g++ refuses: build() raises with g++'s output; available()
    logs it at WARNING and answers False; the loader takes the numpy core
    (srtpu's batches all the same); calling the core raises."""
    bad = tmp_path / 'patchops.cc'
    bad.write_text('extern "C" void extract_patch_pair( { }\n')
    monkeypatch.setattr(native, 'SOURCE', bad)
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, '_failed', None)
    with pytest.raises(RuntimeError, match='g\\+\\+ failed'):
        native.build()
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert not native.available()
    assert 'error' in caplog.text and 'numpy core' in caplog.text
    with pytest.raises(RuntimeError, match='unavailable'):
        native.bicubic_downscale(np.zeros((8, 8, 3), np.uint8), 2)
    ref, got = _pair(_dataset(tmp_path / 'd'), process_index=0,
                     process_count=1, num_workers=1)
    assert got.core == 'numpy'
    _assert_same_epochs(got, ref, epochs=1)
