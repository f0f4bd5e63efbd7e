"""Metric registry (srtpu/metrics/__init__.py), keyed by srtpu's names.

``build_metrics`` maps each name to ``fn(sr, hr, mask=None)`` on NHWC
[0, 1] tensors, computed on their device: BRISQUE (no reference: it
reads the SR only), FLIP (the HR the reference), LPIPS (VGG16, built
once; its frozen weights move to the SR's device at the first image),
MS-SSIM, PSNR and SSIM. The mask (NHW1) restricts every full-reference
metric to a padded image's valid pixels. BRISQUE's global statistics
move under padding, so the Trainer scores it on the true shape alone
(:func:`brisque_exact`; srtpu scores it again there).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..losses.flip import flip
from ..losses.vgg import LPIPS
from .brisque import brisque, brisque_features
from .psnr_ssim import ms_ssim, psnr, ssim

# no-reference metrics receive only the SR image
NO_REFERENCE = {'BRISQUE'}
# metrics where lower is better (a checkpoint monitor's mode)
LOWER_IS_BETTER = {'BRISQUE', 'FLIP', 'LPIPS'}


def _flip_metric(sr, hr, mask=None):
    return flip(hr, sr, mask=mask)


_REGISTRY: dict[str, Callable] = {
    'BRISQUE': lambda sr, hr=None, mask=None: brisque(sr),
    'FLIP': _flip_metric,
    'MS-SSIM': lambda sr, hr, mask=None: ms_ssim(sr, hr, mask=mask),
    'PSNR': lambda sr, hr, mask=None: psnr(sr, hr, mask=mask),
    'SSIM': lambda sr, hr, mask=None: ssim(sr, hr, mask=mask),
}


def supported_metrics() -> list[str]:
    """srtpu's metric names."""
    return ['BRISQUE', 'FLIP', 'LPIPS', 'MS-SSIM', 'PSNR', 'SSIM']


def build_metrics(names) -> dict[str, Callable]:
    """``{name: fn}`` for ``names``; an unknown name raises srtpu's
    ``AttributeError``. LPIPS is built here, once."""
    out = {}
    for name in names:
        if name not in supported_metrics():
            raise AttributeError(
                f"Couldn't find metric {name}. Supported metrics: "
                f"{', '.join(supported_metrics())}")
        if name == 'LPIPS':
            lp = LPIPS()
            out[name] = lambda sr, hr, mask=None, _lp=lp: _lp(sr, hr,
                                                              mask=mask)
        else:
            out[name] = _REGISTRY[name]
    return out


def brisque_exact(sr: torch.Tensor) -> float:
    """BRISQUE of the SR cropped to its true (unpadded) shape, on its
    device: the bucketed eval step sees edge-padded images, and BRISQUE's
    global statistics move under padding (srtpu ``brisque_exact``, which
    runs on its CPU backend; the shape is what matters)."""
    with torch.inference_mode():
        return float(brisque(sr.float()))


__all__ = ['LOWER_IS_BETTER', 'NO_REFERENCE', 'brisque', 'brisque_exact',
           'brisque_features', 'build_metrics', 'flip', 'ms_ssim', 'psnr',
           'ssim', 'supported_metrics']
