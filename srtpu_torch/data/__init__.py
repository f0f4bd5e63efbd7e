"""Data loading for training and predict (no JAX)."""

from .datamodule import SRData
from .pipeline import (Batch, PredictLoader, TrainLoader, center_crop,
                       pad_to_bucket)
from .sources import ConcatSource, ImageFolderSource, NpySource

__all__ = ['Batch', 'ConcatSource', 'ImageFolderSource', 'NpySource',
           'PredictLoader', 'SRData', 'TrainLoader', 'center_crop',
           'pad_to_bucket']
