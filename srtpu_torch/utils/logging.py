"""Image output: ``save_image`` writes PNGs with a small stdlib encoder,
so saving needs no Pillow."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (8-bit RGB, no filter, one IDAT)."""
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f'expected (H, W, 3) uint8, got {rgb.shape} '
                         f'{rgb.dtype}')
    h, w, _ = rgb.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)    # filter byte 0 per row
    rows[:, 1:] = rgb.reshape(h, 3 * w)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack('>I', len(data)) + tag + data
                + struct.pack('>I', zlib.crc32(tag + data) & 0xffffffff))

    return (b'\x89PNG\r\n\x1a\n'
            + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0))
            + chunk(b'IDAT', zlib.compress(rows.tobytes(), 1))
            + chunk(b'IEND', b''))


def save_image(img_hwc: np.ndarray, path) -> None:
    """Save a float [0, 1] HWC array as PNG: clip, x255, +0.5, uint8
    (srtpu/utils/logging.py:108-116)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arr = np.clip(np.asarray(img_hwc), 0.0, 1.0)
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    path.write_bytes(encode_png((arr * 255.0 + 0.5).astype(np.uint8)))
