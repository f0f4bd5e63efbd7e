"""HaarPSI, the Haar wavelet-based perceptual similarity index
(srtpu/losses/haarpsi.py; Reisenhofer et al. 2016): 3 Haar scales, two
orientations, logistic pooling with C = 30 on [0, 255] and alpha = 4.2,
a 2x2 mean pool first, YIQ chroma for RGB. The loss is 1 - HaarPSI.

srtpu's details kept: the 'same' padding of an even-sized filter is
asymmetric, ``((k - 1) // 2, k // 2)`` zeros; the pool is a 'SAME' 2x2 /
2 window sum over 4, so an odd side is padded with zeros at its end
(not ``avg_pool2d``'s); each filter is srtpu's slice-scale-add tree
(``utils.imgops._depthwise``); ``abs``, ``clip`` and ``maximum`` take
JAX's gradients at ties (a Haar response is exactly 0 in a flat region).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.imgops import DeviceConst, _depthwise
from .basic import abs_, clip

RGB2YIQ = np.array([[0.299, 0.587, 0.114],
                    [0.5959, -0.2746, -0.3213],
                    [0.2115, -0.5227, 0.3112]], dtype=np.float32)
_RGB2YIQ = DeviceConst(RGB2YIQ)


@functools.lru_cache(maxsize=4)
def _haar_filters(scales: int):
    filters = []
    for j in range(1, scales + 1):
        size = 2 ** j
        f = np.zeros((size, size), dtype=np.float32)
        f[:size // 2, :] = -1.0 / (size * size)
        f[size // 2:, :] = 1.0 / (size * size)
        filters.append(f)
    return filters


def _conv_same(x: torch.Tensor, k2d: np.ndarray) -> torch.Tensor:
    kh, kw = k2d.shape
    x = torch.nn.functional.pad(x, (0, 0, (kw - 1) // 2, kw // 2,
                                    (kh - 1) // 2, kh // 2))
    return _depthwise(x, k2d)


def _pool2(v: torch.Tensor) -> torch.Tensor:
    """2x2 / 2 window sums ('SAME': zeros past an odd end) over 4."""
    v = torch.nn.functional.pad(v, (0, 0, 0, v.shape[2] % 2,
                                    0, v.shape[1] % 2))
    return (((v[:, 0::2, 0::2] + v[:, 0::2, 1::2]) + v[:, 1::2, 0::2])
            + v[:, 1::2, 1::2]) / 4.0


def haarpsi(x: torch.Tensor, y: torch.Tensor, scales: int = 3,
            c: float = 30.0, alpha: float = 4.2,
            data_range: float = 1.0) -> torch.Tensor:
    """HaarPSI of NHWC ``x`` and ``y`` (RGB or gray) in [0, 1]; 1 is
    identical."""
    x = x.float() * (255.0 / data_range)
    y = y.float() * (255.0 / data_range)
    is_color = x.shape[-1] == 3
    if is_color:
        m = _RGB2YIQ.on(x.device).T
        x_yiq, y_yiq = x @ m, y @ m
        x_l, y_l = x_yiq[..., 0:1], y_yiq[..., 0:1]
        x_iq, y_iq = _pool2(x_yiq[..., 1:3]), _pool2(y_yiq[..., 1:3])
    else:
        x_l, y_l = x, y
    x_l, y_l = _pool2(x_l), _pool2(y_l)

    filters = _haar_filters(scales)
    sims, weights = [], []
    for orientation in range(2):   # 0: horizontal edges, 1: vertical
        cx, cy = [], []
        for f in filters:
            k = f if orientation == 0 else f.T
            cx.append(abs_(_conv_same(x_l, k)))
            cy.append(abs_(_conv_same(y_l, k)))
        s = ((2 * cx[0] * cy[0] + c) / (cx[0] ** 2 + cy[0] ** 2 + c)
             + (2 * cx[1] * cy[1] + c) / (cx[1] ** 2 + cy[1] ** 2 + c)) / 2.0
        sims.append(s)
        weights.append(torch.maximum(cx[scales - 1], cy[scales - 1]))
    if is_color:
        mean_k = np.full((2, 2), 0.25, dtype=np.float32)

        def mean2(v):
            return abs_(_conv_same(v, mean_k))
        sim_iq = (2 * mean2(x_iq) * mean2(y_iq) + c) / \
            (mean2(x_iq) ** 2 + mean2(y_iq) ** 2 + c)
        sims.append((sim_iq[..., 0:1] + sim_iq[..., 1:2]) / 2.0)
        weights.append((weights[0] + weights[1]) / 2.0)

    n = x.shape[0]
    sims = torch.cat([s.reshape(n, -1) for s in sims], dim=1)
    weights = torch.cat([w.reshape(n, -1) for w in weights], dim=1)
    pooled = (torch.sigmoid(alpha * sims) * weights).sum(1) / \
        torch.maximum(weights.sum(1), weights.new_full((), 1e-12))
    pooled = clip(pooled, 1e-6, 1 - 1e-6)
    return ((torch.log(pooled / (1 - pooled)) / alpha) ** 2).mean()


def haarpsi_loss(sr: torch.Tensor, hr: torch.Tensor, **kwargs) -> torch.Tensor:
    """1 - HaarPSI (piq's ``HaarPSILoss``); the composite clamps the SR to
    [0, 1] first."""
    return 1.0 - haarpsi(sr, hr, **kwargs)
