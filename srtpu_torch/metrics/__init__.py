"""Metric registry (srtpu/metrics/__init__.py), keyed by srtpu's names.

``build_metrics`` maps each name to ``fn(sr, hr, mask=None)`` on NHWC
[0, 1] tensors, computed on their device. The port has PSNR, SSIM and
MS-SSIM; BRISQUE, FLIP and LPIPS are srtpu names that raise
``NotImplementedError`` (ROADMAP.md queue 1, item 15).
"""

from __future__ import annotations

from typing import Callable

from .psnr_ssim import ms_ssim, psnr, ssim

# no-reference metrics receive only the SR image
NO_REFERENCE = {'BRISQUE'}
# metrics where lower is better (a checkpoint monitor's mode)
LOWER_IS_BETTER = {'BRISQUE', 'FLIP', 'LPIPS'}
NOT_PORTED = ('BRISQUE', 'FLIP', 'LPIPS')

_REGISTRY: dict[str, Callable] = {
    'MS-SSIM': lambda sr, hr, mask=None: ms_ssim(sr, hr, mask=mask),
    'PSNR': lambda sr, hr, mask=None: psnr(sr, hr, mask=mask),
    'SSIM': lambda sr, hr, mask=None: ssim(sr, hr, mask=mask),
}


def supported_metrics() -> list[str]:
    """srtpu's metric names."""
    return ['BRISQUE', 'FLIP', 'LPIPS', 'MS-SSIM', 'PSNR', 'SSIM']


def build_metrics(names) -> dict[str, Callable]:
    """``{name: fn}`` for ``names``; an unknown name raises srtpu's
    ``AttributeError``, a name the port lacks ``NotImplementedError``."""
    out = {}
    for name in names:
        if name not in supported_metrics():
            raise AttributeError(
                f"Couldn't find metric {name}. Supported metrics: "
                f"{', '.join(supported_metrics())}")
        if name in NOT_PORTED:
            raise NotImplementedError(
                f'metric {name} is not ported to srtpu_torch yet (ROADMAP.md '
                f'queue 1, item 15); it has PSNR, SSIM and MS-SSIM')
        out[name] = _REGISTRY[name]
    return out


__all__ = ['LOWER_IS_BETTER', 'NO_REFERENCE', 'build_metrics', 'ms_ssim',
           'psnr', 'ssim', 'supported_metrics']
