"""SRData (srtpu/data/datamodule.py): training, eval and predict
datasets under ``datasets_dir``.

A training or eval dataset is ``<datasets_dir>/<name>/HR`` with its LR,
when present, at ``<name>/LR/X{scale}``; ``.npy``/``.npz`` folders read
through :class:`NpySource`, image folders through
:class:`ImageFolderSource`. A predict dataset is a flat LR folder, or
``<name>/LR/X{scale}`` / ``<name>/LR``. ``setup('fit')`` builds the
train and the eval sources, ``setup('validate')`` the eval sources, as
srtpu's; srtpu's hub names (DIV2K, Set5, ...) are local folders here,
since nothing is downloaded. ``prefetch``, ``num_workers`` and
``cache_train_images`` (the train sources' RAM cache of decoded images)
are srtpu's loader knobs; :meth:`SRData.train_loader` on a CUDA device
prefetches the batches onto it.
"""

from __future__ import annotations

from pathlib import Path

from .pipeline import EvalLoader, PredictLoader, TrainLoader
from .sources import ConcatSource, ImageFolderSource, NpySource, predict_dir


class SRData:
    def __init__(self, datasets_dir: str = 'datasets',
                 train_datasets: list[str] | tuple[str, ...] = (),
                 predict_datasets: list[str] | tuple[str, ...] = (),
                 eval_datasets: list[str] | tuple[str, ...] = (),
                 batch_size: int = 16, patch_size: int = 128,
                 scale_factor: int = 4, seed: int = 0, eval_bucket: int = 32,
                 augment: bool = True, prefetch: int = 2,
                 cache_train_images: bool = True, num_workers: int = 0):
        self.datasets_dir = Path(datasets_dir)
        self.train_dataset_names = list(train_datasets)
        self.eval_dataset_names = list(eval_datasets)
        self.predict_dataset_names = list(predict_datasets)
        self.batch_size = batch_size
        self.patch_size = patch_size
        self.scale_factor = scale_factor
        self.seed = seed
        self.eval_bucket = eval_bucket
        self.augment = augment      # the train loader's 8-way augmentation
        self.prefetch = prefetch
        self.cache_train_images = cache_train_images
        self.num_workers = num_workers
        self._train_source = None
        self._eval_sources = None
        self._folders = None

    def _train_source_of(self, name: str, cache: bool = True):
        hr = self.datasets_dir / name / 'HR'
        if not hr.is_dir():
            raise FileNotFoundError(f'Could not find HR images for dataset '
                                    f'{name} in {hr}.')
        lr = self.datasets_dir / name / 'LR' / f'X{self.scale_factor}'
        npy = any(hr.glob('*.npy')) or any(hr.glob('*.npz'))
        cls = NpySource if npy else ImageFolderSource
        return cls(hr, lr if lr.is_dir() else None, self.scale_factor,
                   cache=cache)

    def setup(self, stage: str = 'predict') -> None:
        if stage not in ('fit', 'validate', 'predict'):
            raise ValueError(f'stage must be fit, validate or predict, not '
                             f'{stage!r}')
        if stage == 'fit':
            # every epoch re-reads every image
            self._train_source = ConcatSource(
                [self._train_source_of(n, self.cache_train_images)
                 for n in self.train_dataset_names])
        if stage in ('fit', 'validate'):
            self._eval_sources = [self._train_source_of(n)
                                  for n in self.eval_dataset_names]
        if stage == 'predict':
            self._folders = [predict_dir(self.datasets_dir, n,
                                         self.scale_factor)
                             for n in self.predict_dataset_names]

    def train_loader(self, device=None) -> TrainLoader:
        """The train loader; on a CUDA ``device`` its batches arrive
        there (device prefetch), otherwise as host arrays."""
        if self._train_source is None:
            raise RuntimeError('call setup("fit") first')
        return TrainLoader(self._train_source, self.batch_size,
                           self.patch_size, self.scale_factor,
                           augment=self.augment, seed=self.seed,
                           device=device, prefetch=self.prefetch,
                           num_workers=self.num_workers)

    def eval_loaders(self) -> list[EvalLoader]:
        if self._eval_sources is None:
            raise RuntimeError('call setup("validate") first')
        return [EvalLoader(s, self.scale_factor, self.eval_bucket)
                for s in self._eval_sources]

    def predict_loaders(self) -> list[PredictLoader]:
        if self._folders is None:
            raise RuntimeError('call setup("predict") first')
        return [PredictLoader(f, self.scale_factor, self.eval_bucket)
                for f in self._folders]
