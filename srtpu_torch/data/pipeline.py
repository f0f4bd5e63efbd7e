"""Host-side predict batching: bucket padding and center crops
(srtpu/data/pipeline.py:85-111, EvalLoader's predict mode :357-365)."""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, NamedTuple

import numpy as np

from .sources import list_images, load_image


class Batch(NamedTuple):
    lr: np.ndarray                # (1, H', W', 3) float32, bucket-padded
    names: tuple[str, ...]
    hr_size: tuple[int, int]      # SR size before padding: (H * s, W * s)


def center_crop(img: np.ndarray, th: int, tw: int) -> np.ndarray:
    """torchvision center_crop semantics: zero-pads symmetrically when the
    image is smaller than the crop."""
    h, w = img.shape[:2]
    if h < th or w < tw:
        pt = max((th - h) // 2, 0)
        pb = max(th - h - pt, 0)
        pl = max((tw - w) // 2, 0)
        pr = max(tw - w - pl, 0)
        img = np.pad(img, ((pt, pb), (pl, pr), (0, 0)))
        h, w = img.shape[:2]
    top, left = (h - th) // 2, (w - tw) // 2
    return img[top:top + th, left:left + tw]


def pad_to_bucket(img: np.ndarray, bucket: int):
    """Pad H/W up to the next multiple of ``bucket`` (edge mode). Returns
    (padded, (h, w))."""
    h, w = img.shape[:2]
    ph = (h + bucket - 1) // bucket * bucket
    pw = (w + bucket - 1) // bucket * bucket
    if (ph, pw) == (h, w):
        return img, (h, w)
    padded = np.pad(img, ((0, ph - h), (0, pw - w), (0, 0)), mode='edge')
    return padded, (h, w)


class PredictLoader:
    """One image per batch, edge-padded to ``bucket`` multiples."""

    def __init__(self, folder, scale_factor: int, bucket: int = 32):
        self._files: list[Path] = list_images(folder)
        self._scale = scale_factor
        self._bucket = max(bucket, 1)

    def __iter__(self) -> Iterator[Batch]:
        for path in self._files:
            lr_p, (h, w) = pad_to_bucket(load_image(path), self._bucket)
            yield Batch(lr=lr_p[None], names=(path.stem,),
                        hr_size=(h * self._scale, w * self._scale))
