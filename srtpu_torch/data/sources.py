"""Dataset sources (srtpu/data/sources.py): decode images to float32 HWC
arrays in [0, 1] with srtpu's uint8/uint16 -> float conversion.

* :class:`NpySource` and :class:`ImageFolderSource` read a training
  dataset's ``HR`` folder and, when it exists, its ``LR/X{scale}``
  folder (paired by sorted order); :class:`ConcatSource` chains them;
* predict datasets are flat LR folders (:func:`predict_dir`,
  :func:`list_images`).

``.npy`` files need nothing beyond numpy. ``.png``/``.jpg``/... decode
through Pillow, and a dataset without ``LR/X{scale}`` synthesizes its LR
with Pillow's bicubic resize, as srtpu does; Pillow is imported only
then, and its absence raises a clear error: supply the LR instead.

srtpu's on-disk decode cache: an image file's decoded raw array (uint8
or uint16, before the float conversion: bit-exact, half f32's bytes) is
written once to ``$SRTPU_DECODE_CACHE`` (a folder; default
``~/.cache/srtpu/decoded``; ``0`` / ``off`` disables it), keyed by the
file's resolved path (hashed), mtime and size, and read back later
instead of decoding. Writes are atomic (a temp file, then a rename), so
processes can share the folder; an entry that does not load is decoded
again. An image folder's synthesized LR is cached raw too, under a key
that names its algorithm (:data:`LR_TAG`), where srtpu's key has none.
``.npy`` folders keep no disk cache.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
from pathlib import Path

import numpy as np

_logger = logging.getLogger(__name__)

IMG_EXTENSIONS = {'.jpg', '.jpeg', '.png', '.ppm', '.bmp'}
NPY_EXTENSIONS = {'.npy', '.npz'}
PREDICT_EXTENSIONS = IMG_EXTENSIONS | {'.npy'}


def to_float(arr: np.ndarray) -> np.ndarray:
    if arr.dtype == np.uint8:
        return arr.astype(np.float32) / 255.0
    if arr.dtype == np.uint16:
        return arr.astype(np.float32) / 65535.0
    return arr.astype(np.float32)


def _pillow(what: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f'{what} needs Pillow, which is not installed; '
                           f'supply .npy images (and their LR at '
                           f'LR/X<scale>) instead') from e
    return Image


# the synthesized LR's algorithm: Pillow's bicubic resize of the HR
# (quantized to uint8 first), a uint8 result
LR_TAG = 'pil-bicubic-u8'


def decode_cache_dir() -> Path | None:
    val = os.environ.get('SRTPU_DECODE_CACHE', '')
    if val.lower() in ('0', 'off', 'none', 'disable', 'disabled'):
        return None
    if val:
        return Path(val)
    return Path.home() / '.cache' / 'srtpu' / 'decoded'


def decode_cache_path(path, suffix: str = '') -> Path | None:
    """The cache entry of ``path`` (None: the cache is off, or the file
    cannot be read)."""
    root = decode_cache_dir()
    if root is None:
        return None
    try:
        p = Path(path).resolve()
        st = p.stat()
    except OSError:
        return None
    key = hashlib.sha1(str(p).encode()).hexdigest()[:24]
    return root / f'{key}-{st.st_mtime_ns}-{st.st_size}{suffix}.npy'


def _cache_load(cache: Path | None) -> np.ndarray | None:
    if cache is None or not cache.exists():
        return None
    try:
        return np.load(cache)
    except (OSError, ValueError, EOFError) as e:    # a torn entry
        _logger.warning('unreadable decode-cache entry %s (%s); decoding '
                        'again', cache, e)
        return None


def _cache_store(cache: Path | None, raw: np.ndarray) -> None:
    if cache is None:
        return
    tmp = cache.with_suffix(f'.{os.getpid()}.{threading.get_ident()}'
                            '.tmp.npy')
    try:
        cache.parent.mkdir(parents=True, exist_ok=True)
        np.save(tmp, raw)
        os.replace(tmp, cache)
    except OSError as e:    # a full or read-only disk: train uncached
        tmp.unlink(missing_ok=True)
        _logger.warning('decode-cache write of %s failed (%s); continuing '
                        'uncached', cache, e)


def _load_npy(path) -> np.ndarray:
    arr = np.load(path)
    if not isinstance(arr, np.ndarray):  # .npz archive: first array
        arr = arr[list(arr.files)[0]]
    return to_float(arr)


def load_image(path) -> np.ndarray:
    """(H, W, 3) float32 image from ``.npy``/``.npz`` or an image file
    (decoded through the on-disk cache)."""
    path = Path(path)
    if path.suffix.lower() in NPY_EXTENSIONS:
        arr = _load_npy(path)
        if arr.ndim != 3 or arr.shape[-1] != 3:
            raise ValueError(f'{path}: expected an (H, W, 3) array, got '
                             f'{arr.shape}')
        return arr
    cache = decode_cache_path(path)
    raw = _cache_load(cache)
    if raw is None:
        with _pillow(f'decoding {path}').open(path) as im:
            raw = np.asarray(im.convert('RGB'))
        _cache_store(cache, raw)
    return to_float(raw)


def bicubic_downscale_raw(hr: np.ndarray, scale: int) -> np.ndarray:
    """Pillow bicubic downscale of a [0, 1] image quantized to uint8, as
    srtpu's ``bicubic_downscale_raw``: the uint8 LR."""
    image = _pillow('synthesizing a missing LR (no LR/X<scale> folder)')
    h, w = hr.shape[:2]
    img = image.fromarray((np.clip(hr, 0, 1) * 255.0 + 0.5).astype(np.uint8))
    return np.asarray(img.resize((w // scale, h // scale), image.BICUBIC))


def bicubic_downscale(hr: np.ndarray, scale: int) -> np.ndarray:
    return to_float(bicubic_downscale_raw(hr, scale))


class Source:
    """Interface: len() items; get(i) -> (lr, hr, name); cached(i): whether
    get(i) is a RAM lookup (the loader fetches those without threads)."""

    def __len__(self) -> int:
        raise NotImplementedError

    def get(self, index: int):
        raise NotImplementedError

    def cached(self, index: int) -> bool:
        return False


class _FolderSource(Source):
    """HR files of one extension set, with LR paired by sorted order or
    synthesized; decoded items cached in RAM when ``cache``."""

    extensions: set[str] = set()

    def __init__(self, hr_dir, lr_dir=None, scale_factor: int = 4,
                 cache: bool = False):
        self._scale = scale_factor
        self._hr_files = self._list(hr_dir)
        self._lr_files = None if lr_dir is None else self._list(lr_dir)
        if self._lr_files is not None and \
                len(self._lr_files) != len(self._hr_files):
            raise ValueError(f'LR/HR count mismatch: {len(self._lr_files)} '
                             f'vs {len(self._hr_files)}')
        self._cache: dict[int, tuple] | None = {} if cache else None

    def _list(self, folder) -> list[Path]:
        return sorted(f for f in Path(folder).glob('*')
                      if f.suffix.lower() in self.extensions)

    def __len__(self) -> int:
        return len(self._hr_files)

    def cached(self, index: int) -> bool:
        return self._cache is not None and index in self._cache

    def get(self, index: int):
        if self._cache is not None and index in self._cache:
            return self._cache[index]
        path = self._hr_files[index]
        hr = load_image(path)
        lr = self._synthesized_lr(path, hr) if self._lr_files is None \
            else load_image(self._lr_files[index])
        item = (lr, hr, path.stem)
        if self._cache is not None:
            self._cache[index] = item
        return item

    def _synthesized_lr(self, path: Path, hr: np.ndarray) -> np.ndarray:
        return bicubic_downscale(hr, self._scale)


class NpySource(_FolderSource):
    extensions = NPY_EXTENSIONS


class ImageFolderSource(_FolderSource):
    """Image files; decoded arrays and the synthesized LR go through the
    on-disk decode cache (module note)."""

    extensions = IMG_EXTENSIONS

    def _synthesized_lr(self, path: Path, hr: np.ndarray) -> np.ndarray:
        cache = decode_cache_path(path, f'-x{self._scale}lr-{LR_TAG}')
        raw = _cache_load(cache)
        if raw is None:
            raw = bicubic_downscale_raw(hr, self._scale)
            _cache_store(cache, raw)
        return to_float(raw)


class ConcatSource(Source):
    """Concatenation of sources (srtpu ``ConcatSource``)."""

    def __init__(self, sources: list[Source]):
        self._sources = sources
        self._offsets = np.cumsum([0] + [len(s) for s in sources])

    def __len__(self):
        return int(self._offsets[-1])

    def _locate(self, index) -> tuple:
        src = int(np.searchsorted(self._offsets, index, side='right')) - 1
        return self._sources[src], index - int(self._offsets[src])

    def get(self, index):
        source, i = self._locate(index)
        return source.get(i)

    def cached(self, index) -> bool:
        source, i = self._locate(index)
        return source.cached(i)


def predict_dir(datasets_dir, name: str, scale: int) -> Path:
    """``<name>/LR/X{scale}`` or ``<name>/LR`` when present, else the flat
    folder ``<name>``."""
    base = Path(datasets_dir) / name
    for sub in (base / 'LR' / f'X{scale}', base / 'LR'):
        if sub.is_dir():
            return sub
    if not base.is_dir():
        raise FileNotFoundError(f'Could not find images for predicting '
                                f'dataset {name} in {base}.')
    return base


def list_images(folder) -> list[Path]:
    files = sorted(f for f in Path(folder).glob('*')
                   if f.suffix.lower() in PREDICT_EXTENSIONS)
    if not files:
        # a silent zero-image predict looks like success — fail loudly
        raise FileNotFoundError(
            f'predict dataset has no images in {folder} (extensions: '
            f'{sorted(PREDICT_EXTENSIONS)})')
    return files
