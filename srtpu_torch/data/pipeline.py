"""Host-side batching (srtpu/data/pipeline.py): the training loader's
patch sampling and augmentation, eval and predict bucket padding with
the eval validity mask, and center crops."""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, NamedTuple

import numpy as np

from .sources import Source, list_images, load_image


class Batch(NamedTuple):
    lr: np.ndarray                # (N, H', W', 3) float32
    hr: np.ndarray | None = None  # training: (N, patch, patch, 3) float32
    names: tuple[str, ...] = ()
    hr_size: tuple[int, int] | None = None   # eval / predict: unpadded SR
    mask: np.ndarray | None = None  # eval: (1, H'', W'', 1) HR validity


def reconcile_eval_pair(lr: np.ndarray, hr: np.ndarray, scale: int):
    """Center-crop HR to a multiple of scale and LR to HR / scale
    (srtpu/data/pipeline.py:69-82)."""
    hh, hw = hr.shape[:2]
    th, tw = hh - hh % scale, hw - hw % scale
    if (th, tw) != (hh, hw):
        top, left = (hh - th) // 2, (hw - tw) // 2
        hr = hr[top:top + th, left:left + tw]
    lh, lw = lr.shape[:2]
    tlh, tlw = th // scale, tw // scale
    if (lh, lw) != (tlh, tlw):
        top, left = max((lh - tlh) // 2, 0), max((lw - tlw) // 2, 0)
        lr = lr[top:top + tlh, left:left + tlw]
    return lr, hr


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


class TrainLoader:
    """Shuffled epochs of aligned random LR/HR patches with 8-way
    augmentation, one static batch shape (srtpu ``TrainLoader`` in one
    process). It draws srtpu's random stream exactly: per epoch
    ``default_rng((seed, epoch))``, a permutation of the items, then per
    batch the vectorized crop and augment draws (srtpu
    ``_draw_params``), so a seed gives srtpu's batches bit for bit.
    Batches are made on the host, in the consumer's thread."""

    def __init__(self, source: Source, batch_size: int, patch_size: int,
                 scale_factor: int, augment: bool = True, seed: int = 0,
                 drop_remainder: bool = True):
        if patch_size % scale_factor:
            raise ValueError(f'patch size ({patch_size}) must be divisible '
                             f'by scale ({scale_factor})')
        self._source = source
        self._batch = batch_size
        self._patch = patch_size
        self._scale = scale_factor
        self._augment = augment
        self._seed = seed
        self._drop = drop_remainder
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self._source)
        return n // self._batch if self._drop else -(-n // self._batch)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def peek(self) -> Batch:
        """One batch for shape inspection, from a stream of its own (the
        epochs' streams are untouched)."""
        rng = np.random.default_rng((self._seed, 2 ** 31))
        n = len(self._source)
        idx = np.resize(np.arange(min(self._batch, n)), self._batch)
        return self._make_batch(idx, rng)

    def _draw_params(self, rng, lrs):
        n = len(lrs)
        lp = self._patch // self._scale
        lhs = np.array([a.shape[0] for a in lrs])
        lws = np.array([a.shape[1] for a in lrs])
        ys = rng.integers(0, lhs - lp + 1).astype(np.int32)
        xs = rng.integers(0, lws - lp + 1).astype(np.int32)
        if self._augment:
            rots = rng.integers(0, 4, n).astype(np.int32)
            hfs = rng.integers(0, 2, n).astype(np.int32)
            vfs = rng.integers(0, 2, n).astype(np.int32)
        else:
            rots = hfs = vfs = np.zeros(n, np.int32)
        return ys, xs, rots, hfs, vfs

    def _make_batch(self, indices, rng) -> Batch:
        n = len(indices)
        lp, s = self._patch // self._scale, self._scale
        items = [self._source.get(int(i)) for i in indices]
        lrs = [np.ascontiguousarray(lr, np.float32) for lr, _, _ in items]
        hrs = [np.ascontiguousarray(hr, np.float32) for _, hr, _ in items]
        ys, xs, rots, hfs, vfs = self._draw_params(rng, lrs)
        out_lr = np.empty((n, lp, lp, 3), np.float32)
        out_hr = np.empty((n, self._patch, self._patch, 3), np.float32)
        for j in range(n):
            y, x = int(ys[j]), int(xs[j])
            lr_p = lrs[j][y:y + lp, x:x + lp]
            hr_p = hrs[j][y * s:(y + lp) * s, x * s:(x + lp) * s]
            if rots[j]:
                lr_p = np.rot90(lr_p, rots[j])
                hr_p = np.rot90(hr_p, rots[j])
            if hfs[j]:
                lr_p, hr_p = lr_p[:, ::-1], hr_p[:, ::-1]
            if vfs[j]:
                lr_p, hr_p = lr_p[::-1], hr_p[::-1]
            out_lr[j] = lr_p
            out_hr[j] = hr_p
        return Batch(lr=out_lr, hr=out_hr,
                     names=tuple(name for _, _, name in items))

    def __iter__(self) -> Iterator[Batch]:
        rng = np.random.default_rng((self._seed, self._epoch))
        order = rng.permutation(len(self._source))
        try:
            for b in range(len(self)):
                idx = order[b * self._batch:(b + 1) * self._batch]
                if len(idx) < self._batch:      # only without drop
                    idx = np.concatenate(
                        [idx, order[:self._batch - len(idx)]])
                yield self._make_batch(idx, rng)
        finally:
            self._epoch += 1


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


class EvalLoader:
    """One (LR, HR) pair per batch (srtpu ``EvalLoader``, eval mode): the
    pair reconciled to the scale, the LR edge-padded to ``bucket``
    multiples and the HR to ``bucket * scale`` multiples, with the HR's
    NHW1 validity mask and its unpadded size ``hr_size``."""

    def __init__(self, source: Source, scale_factor: int, bucket: int = 32):
        self._source = source
        self._scale = scale_factor
        self._bucket = max(bucket, 1)

    def __len__(self) -> int:
        return len(self._source)

    def __iter__(self) -> Iterator[Batch]:
        for i in range(len(self._source)):
            lr, hr, name = self._source.get(i)
            lr, hr = reconcile_eval_pair(lr, hr, self._scale)
            lr_p, (h, w) = pad_to_bucket(lr, self._bucket)
            hr_p, _ = pad_to_bucket(hr, self._bucket * self._scale)
            hs, ws = h * self._scale, w * self._scale
            mask = np.zeros(hr_p.shape[:2] + (1,), np.float32)
            mask[:hs, :ws] = 1.0
            yield Batch(lr=lr_p[None], hr=hr_p[None], names=(name,),
                        hr_size=(hs, ws), mask=mask[None])
