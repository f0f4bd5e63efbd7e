"""Predict-side data loading (no JAX)."""

from .datamodule import SRData
from .pipeline import Batch, PredictLoader, center_crop, pad_to_bucket

__all__ = ['Batch', 'PredictLoader', 'SRData', 'center_crop',
           'pad_to_bucket']
