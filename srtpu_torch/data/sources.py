"""Predict inputs: locate a predict dataset's LR folder, list its images
and decode them to float32 HWC arrays in [0, 1]
(srtpu/data/sources.py, srtpu/data/datamodule.py:135-160).

``.npy`` files need nothing beyond numpy; ``.png``/``.jpg``/... decode
through Pillow, which is imported only when such a file is read.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

IMG_EXTENSIONS = {'.jpg', '.jpeg', '.png', '.ppm', '.bmp'}
PREDICT_EXTENSIONS = IMG_EXTENSIONS | {'.npy'}


def to_float(arr: np.ndarray) -> np.ndarray:
    if arr.dtype == np.uint8:
        return arr.astype(np.float32) / 255.0
    if arr.dtype == np.uint16:
        return arr.astype(np.float32) / 65535.0
    return arr.astype(np.float32)


def load_image(path) -> np.ndarray:
    """(H, W, 3) float32 image."""
    path = Path(path)
    if path.suffix.lower() == '.npy':
        arr = np.load(path)
        if arr.ndim != 3 or arr.shape[-1] != 3:
            raise ValueError(f'{path}: expected an (H, W, 3) array, got '
                             f'{arr.shape}')
        return to_float(arr)
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f'{path}: decoding {path.suffix} needs Pillow; '
                           f'pass .npy images instead') from e
    with Image.open(path) as im:
        return to_float(np.asarray(im.convert('RGB')))


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
