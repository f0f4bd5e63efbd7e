"""Data loading for training, eval and predict (no JAX)."""

from .datamodule import SRData
from .pipeline import (Batch, EvalLoader, PredictLoader, TrainLoader,
                       center_crop, pad_to_bucket, reconcile_eval_pair)
from .sources import ConcatSource, ImageFolderSource, NpySource

__all__ = ['Batch', 'ConcatSource', 'EvalLoader', 'ImageFolderSource',
           'NpySource', 'PredictLoader', 'SRData', 'TrainLoader',
           'center_crop', 'pad_to_bucket', 'reconcile_eval_pair']
