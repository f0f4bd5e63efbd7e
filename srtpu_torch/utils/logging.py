"""Image output and the run log: ``save_image`` writes PNGs with a small
stdlib encoder, so saving needs no Pillow; ``attach_run_log`` adds a
run's ``run.log``."""

from __future__ import annotations

import logging
import logging.handlers
import struct
import zlib
from pathlib import Path

import numpy as np

LOG_FORMAT = '%(asctime)s %(levelname)s %(name)s: %(message)s'


def attach_run_log(log_dir, filename: str = 'run.log',
                   file_log_level: str = 'info') -> logging.Handler:
    """Attach a rotating ``<log_dir>/<filename>`` handler to the root
    logger and return it; other handlers and the root's level are left
    as they are, and the ``srtpu_torch`` loggers are opened to INFO so
    that their records reach the file (srtpu
    ``utils/logging.py:attach_run_log``)."""
    pkg = logging.getLogger('srtpu_torch')
    if pkg.getEffectiveLevel() > logging.INFO:
        pkg.setLevel(logging.INFO)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    fileh = logging.handlers.RotatingFileHandler(
        Path(log_dir) / filename, maxBytes=5 * 1024 * 1024, backupCount=3)
    fileh.setLevel(getattr(logging, file_log_level.upper(), logging.INFO))
    fileh.setFormatter(logging.Formatter(LOG_FORMAT))
    logging.getLogger().addHandler(fileh)
    return fileh


def has_run_log(log_dir, filename: str = 'run.log') -> bool:
    """Whether a root handler already writes ``<log_dir>/<filename>``."""
    target = str((Path(log_dir) / filename).absolute())
    return any(getattr(h, 'baseFilename', None) == target
               for h in logging.getLogger().handlers)


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
