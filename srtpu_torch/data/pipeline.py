"""Batching (srtpu/data/pipeline.py): the training loader's patch
sampling and augmentation on a producer thread with device prefetch,
eval and predict bucket padding with the eval validity mask, and center
crops."""

from __future__ import annotations

import contextlib
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, NamedTuple

import numpy as np
import torch

from . import native
from .sources import Source, list_images, load_image


class Batch(NamedTuple):
    lr: np.ndarray                # (N, H', W', 3) float32 (training on a
    hr: np.ndarray | None = None  # card: tensors there); training's HR
                                  # (N, patch, patch, 3) float32
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


# A CUDA graph capture in PyTorch's default "global" mode forbids every
# other thread's potentially unsafe CUDA calls (allocations, event queries
# and syncs) while it runs. The capture mode is process-wide, so this lock
# is too: StepGraph holds it while it captures, a loader's producer around
# each of its CUDA calls.
capture_lock = threading.Lock()


def _pinned(shape) -> torch.Tensor:
    """A page-locked float32 host tensor (raises if it cannot be had)."""
    return torch.empty(shape, dtype=torch.float32, pin_memory=True)


class TrainLoader:
    """Shuffled epochs of aligned random LR/HR patches with 8-way
    augmentation, one static batch shape (srtpu ``TrainLoader``).

    It draws srtpu's random stream exactly: per epoch ``default_rng((seed,
    epoch))``, a permutation of the items (each of ``process_count``
    processes takes every ``process_count``-th from ``process_index``, on
    a stream of its own), then per batch the fetch and the vectorized crop
    and augment draws (``_draw_params``), so a seed gives srtpu's batches
    bit for bit for any ``num_workers`` and either core.

    * A producer thread makes the batches ahead into a queue of
      ``prefetch`` (0: unbounded, as ``queue.Queue(maxsize=0)``); its error
      is raised in the consumer; an iterator abandoned mid-epoch stops it
      and leaves no batch behind. Every draw happens on that thread.
    * ``num_workers`` threads (0: ``max(1, cpu_count // 2)``) fetch the
      batch's items that need a decode (those the source holds in RAM are
      fetched in turn: a thread's task costs more than such a fetch) and
      split the native core's call.
    * ``core`` is ``'native'`` (``data/native.py``: the whole batch's crops
      and augments in one C++ call) or ``'numpy'`` where the native core
      could not be built; both give the same bits.
    * With ``device`` a CUDA device, the producer writes each batch into a
      ring of ``prefetch + 2`` pinned host slots, copies it to the card on
      a stream of its own and records an event; the consumer's stream waits
      on that event before the batch (tensors on the card) is yielded, and
      a slot is written again only after its copy completed. Otherwise the
      batches are host arrays.
    """

    def __init__(self, source: Source, batch_size: int, patch_size: int,
                 scale_factor: int, augment: bool = True, seed: int = 0,
                 device=None, prefetch: int = 2, drop_remainder: bool = True,
                 process_index: int = 0, process_count: int = 1,
                 num_workers: int = 0):
        if patch_size % scale_factor:
            raise ValueError(f'patch size ({patch_size}) must be divisible '
                             f'by scale ({scale_factor})')
        if not 0 <= process_index < process_count:
            raise ValueError(f'process {process_index} of {process_count}')
        self._source = source
        self._batch = batch_size
        self._patch = patch_size
        self._scale = scale_factor
        self._augment = augment
        self._seed = seed
        device = None if device is None else torch.device(device)
        self._device = device if device is not None and \
            device.type == 'cuda' else None
        self._prefetch = prefetch
        self._drop = drop_remainder
        self._pidx, self._pcount = process_index, process_count
        self._epoch = 0
        self._workers = num_workers if num_workers > 0 else \
            max(1, (os.cpu_count() or 2) // 2)
        self._pool = None
        self._pool_lock = threading.Lock()
        self.core = 'native' if native.available() else 'numpy'

    def __len__(self) -> int:
        n = len(self._source) // self._pcount
        return n // self._batch if self._drop else -(-n // self._batch)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def close(self) -> None:
        """Stop the item threads (a later batch starts them again)."""
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown()

    def peek(self) -> Batch:
        """One host batch for shape inspection, from a stream of its own
        (the epochs' streams are untouched): no thread, no copy to the
        card."""
        rng = np.random.default_rng((self._seed, 2 ** 31))
        n = len(self._source)
        idx = np.resize(np.arange(min(self._batch, n)), self._batch)
        return self._make_batch(idx, rng)

    def _run_items(self, fn, n: int) -> None:
        """``fn(slot)`` for every batch slot: in turn, or on the loader's
        item threads, each taking a contiguous run of slots (one task a
        thread: a task costs more than a cached item's fetch)."""
        t = min(self._workers, n)
        if t <= 1:
            for s in range(n):
                fn(s)
            return
        with self._pool_lock:   # two live producers share one pool
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self._workers,
                    thread_name_prefix='srtpu-torch-data')
            pool = self._pool

        def run(j):
            for s in range(n * j // t, n * (j + 1) // t):
                fn(s)
        list(pool.map(run, range(t)))   # list() raises a worker's error

    def _fetch_items(self, indices):
        """``source.get`` for every slot: contiguous float32 images and
        names; the items the source holds in RAM in turn, the others (a
        decode) on the item threads."""
        n = len(indices)
        lrs, hrs, names = [None] * n, [None] * n, [None] * n

        def fetch(slot):
            lr, hr, name = self._source.get(int(indices[slot]))
            if hr is None:
                raise ValueError(f'No HR image for {name}')
            lrs[slot] = np.ascontiguousarray(lr, np.float32)
            hrs[slot] = np.ascontiguousarray(hr, np.float32)
            names[slot] = name

        todo = []
        for slot in range(n):
            if self._source.cached(int(indices[slot])):
                fetch(slot)
            else:
                todo.append(slot)
        self._run_items(lambda j: fetch(todo[j]), len(todo))
        return lrs, hrs, names

    def _draw_params(self, rng, lrs):
        """The batch's crops and augments, vectorized, from one stream."""
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

    def _make_batch(self, indices, rng, out_lr=None, out_hr=None) -> Batch:
        """The batch of ``indices`` into ``out_lr`` / ``out_hr`` (new
        arrays if None) on the loader's core."""
        n = len(indices)
        lp = self._patch // self._scale
        if out_lr is None:
            out_lr = np.empty((n, lp, lp, 3), np.float32)
            out_hr = np.empty((n, self._patch, self._patch, 3), np.float32)
        make = self._make_batch_native if self.core == 'native' \
            else self._make_batch_numpy
        return make(indices, rng, out_lr, out_hr)

    def _make_batch_numpy(self, indices, rng, out_lr, out_hr) -> Batch:
        lp, s = self._patch // self._scale, self._scale
        lrs, hrs, names = self._fetch_items(indices)
        ys, xs, rots, hfs, vfs = self._draw_params(rng, lrs)
        for j in range(len(indices)):
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
        return Batch(lr=out_lr, hr=out_hr, names=tuple(names))

    def _make_batch_native(self, indices, rng, out_lr, out_hr) -> Batch:
        """The whole batch's crops and augments in ONE C++ call, split
        over the item threads' count, on the numpy core's draws."""
        lrs, hrs, names = self._fetch_items(indices)
        ys, xs, rots, hfs, vfs = self._draw_params(rng, lrs)
        native.extract_patch_batch(
            lrs, hrs, self._patch, self._scale, ys, xs, rots, hfs, vfs,
            out_lr, out_hr, nthreads=self._workers)
        return Batch(lr=out_lr, hr=out_hr, names=tuple(names))

    def _to_device(self, lr: torch.Tensor, hr: torch.Tensor, stream):
        """A pinned slot's copy to the card on ``stream`` (under
        :data:`capture_lock`): (lr, hr on the card, the copy's event)."""
        with torch.cuda.stream(stream):
            lr_d = lr.to(self._device, non_blocking=True)
            hr_d = hr.to(self._device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        return lr_d, hr_d, event

    def _batches(self, order, rng, n_batches: int, stop):
        """The producer's batches, (Batch, the copy's event or None)."""
        ring = None
        for b in range(n_batches):
            if stop.is_set():
                return
            idx = order[b * self._batch:(b + 1) * self._batch]
            if len(idx) < self._batch:
                if self._drop:
                    return
                idx = np.concatenate([idx, order[:self._batch - len(idx)]])
            if self._device is None:
                yield self._make_batch(idx, rng), None
                continue
            if ring is None:
                lp = self._patch // self._scale
                with capture_lock:
                    stream = torch.cuda.Stream(self._device)
                    ring = [(_pinned((self._batch, lp, lp, 3)),
                             _pinned((self._batch, self._patch, self._patch,
                                      3)))
                            for _ in range(max(self._prefetch, 0) + 2)]
                events = [None] * len(ring)
            i = b % len(ring)
            lr_h, hr_h = ring[i]
            if events[i] is not None:
                with capture_lock:      # the slot's last copy has completed
                    events[i].synchronize()
            batch = self._make_batch(idx, rng, lr_h.numpy(), hr_h.numpy())
            with capture_lock:
                lr_d, hr_d, events[i] = self._to_device(lr_h, hr_h, stream)
            yield Batch(lr=lr_d, hr=hr_d, names=batch.names), events[i]

    def __iter__(self) -> Iterator[Batch]:
        rng = np.random.default_rng((self._seed, self._epoch))
        order = rng.permutation(len(self._source))
        if self._pcount > 1:
            order = order[self._pidx::self._pcount]
            rng = np.random.default_rng((self._seed, self._epoch,
                                         self._pidx))
        n_batches = len(self)
        if n_batches == 0:
            return
        # a consumer may abandon the iterator mid-epoch (limit_train_batches,
        # fast_dev_run, overfit_batches): the stop event wakes a producer
        # blocked on a full queue, so it exits and drops its batches
        stop = threading.Event()

        def put(q, item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer(q):
            batches = self._batches(order, rng, n_batches, stop)
            item = None
            try:
                for item in batches:
                    if not put(q, item):
                        return
            except BaseException as e:  # raised again in the consumer
                put(q, e)
            finally:
                # the ring, the stream and a batch not handed over are
                # released here: CUDA calls, kept out of a capture
                with capture_lock if self._device is not None \
                        else contextlib.nullcontext():
                    del item
                    batches.close()
                put(q, None)

        q: queue.Queue = queue.Queue(maxsize=max(self._prefetch, 0))
        thread = threading.Thread(target=producer, args=(q,), daemon=True,
                                  name='srtpu-torch-train-producer')
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                batch, event = item
                if event is not None:
                    current = torch.cuda.current_stream(self._device)
                    current.wait_event(event)
                    batch.lr.record_stream(current)
                    batch.hr.record_stream(current)
                yield batch
        finally:
            stop.set()
            while True:     # drain so a blocked producer wakes and exits
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
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
