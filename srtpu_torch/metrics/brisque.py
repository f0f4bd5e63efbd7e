"""BRISQUE, the no-reference quality score of Mittal et al. 2012
(srtpu/metrics/brisque.py): MSCN coefficients of the luma (x 255), a GGD
fit of them and AGGD fits of their four pairwise products, at two
scales: 36 features per image. The score is the RBF SVR of
``$SRTPU_WEIGHTS_DIR/brisque_svm.npz`` (gamma, rho, sv, alpha,
scale_min, scale_max) where that file exists, else srtpu's fallback:
ten times the RMS z-score of the features against its natural-scene
statistics (lower is better either way). Nothing is downloaded.

The shape parameters are srtpu's moment-matching lookups: the nearest
entry (the first of equals) of a table of gamma-function ratios at steps
of 0.001 from 0.2 to 10, built with scipy in f64 and kept in f32. The
pairwise products roll the MSCN map with wrap-around (``torch.roll``),
the blur pads by reflection, the second scale is a 2x2 mean. The blur is
one convolution (srtpu's is a convolution too), in full f32 on a card
(``imgops.conv2d_f32``).
"""

from __future__ import annotations

import functools
import os
from pathlib import Path

import numpy as np
import torch

from ..utils.imgops import GRAY_WEIGHTS, DeviceConst, conv2d_f32, pad_nhwc


@functools.lru_cache(maxsize=1)
def _tables() -> DeviceConst:
    """gam, the GGD ratio, the AGGD ratio, the AGGD mean constant and the
    NSS statistics."""
    from scipy.special import gamma as G
    gam = np.arange(0.2, 10.001, 0.001)
    gam32 = gam.astype(np.float32)
    return DeviceConst({'gam': gam32,
            'ggd': ((G(1.0 / gam) * G(3.0 / gam)) / (G(2.0 / gam) ** 2)
                    ).astype(np.float32),
            'aggd': ((G(2.0 / gam) ** 2) / (G(1.0 / gam) * G(3.0 / gam))
                     ).astype(np.float32),
            # srtpu evaluates this one on the f32 table
            'aggd_c1': (G(2.0 / gam32) / G(1.0 / gam32)).astype(np.float32),
            'nss_mean': NSS_MEAN, 'nss_std': NSS_STD})


def _lookup(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Index of the nearest table entry per row (the first of equals)."""
    return torch.argmin((x[:, None] - table[None, :]).abs(), dim=-1)


def _fit_ggd(x: torch.Tensor, tab: dict):
    """Moment-matching GGD fit of each row of (B, N): (alpha, sigma^2)."""
    sigma_sq = (x * x).mean(-1)
    e_abs = x.abs().mean(-1)
    rho = sigma_sq / torch.clamp_min(e_abs * e_abs, 1e-12)
    return tab['gam'][_lookup(rho, tab['ggd'])], sigma_sq


def _fit_aggd(x: torch.Tensor, tab: dict):
    """AGGD fit of each row of (B, N): (alpha, mean, left and right
    sigma)."""
    mask_l, mask_r = x < 0, x > 0
    cnt_l = torch.clamp_min(mask_l.sum(-1), 1)
    cnt_r = torch.clamp_min(mask_r.sum(-1), 1)
    sq = x * x
    sigma_l = torch.sqrt((sq * mask_l).sum(-1) / cnt_l)
    sigma_r = torch.sqrt((sq * mask_r).sum(-1) / cnt_r)
    gamma_hat = sigma_l / torch.clamp_min(sigma_r, 1e-12)
    e_abs = x.abs().mean(-1)
    rhat = e_abs * e_abs / torch.clamp_min(sq.mean(-1), 1e-12)
    rhat_norm = (rhat * (gamma_hat ** 3 + 1) * (gamma_hat + 1)
                 / torch.clamp_min((gamma_hat ** 2 + 1) ** 2, 1e-12))
    idx = _lookup(rhat_norm, tab['aggd'])
    mean = (sigma_r - sigma_l) * tab['aggd_c1'][idx]
    return tab['gam'][idx], mean, sigma_l, sigma_r


def _gaussian_kernel7() -> np.ndarray:
    xs = np.arange(7) - 3.0
    g = np.exp(-(xs ** 2) / (2 * (7.0 / 6.0) ** 2))
    g = (g / g.sum()).astype(np.float32)
    return np.outer(g, g)[None, None]


_KERNEL7 = DeviceConst(_gaussian_kernel7())


def _mscn(luma: torch.Tensor) -> torch.Tensor:
    """Mean-subtracted contrast-normalised coefficients of NHW1 luma."""
    k = _KERNEL7.on(luma.device)

    def blur(v):
        y = conv2d_f32(pad_nhwc(v, 3, 3, 'reflect').permute(0, 3, 1, 2), k)
        return y.permute(0, 2, 3, 1)
    mu = blur(luma)
    sigma = torch.sqrt((blur(luma * luma) - mu * mu).abs())
    return (luma - mu) / (sigma + 1.0)


def brisque_features(x: torch.Tensor) -> torch.Tensor:
    """(B, 36) BRISQUE features of NHWC RGB or gray ``x`` in [0, 1]."""
    tab = _tables().on(x.device)
    if x.shape[-1] == 3:
        luma = sum(x[..., i:i + 1] * w for i, w in enumerate(GRAY_WEIGHTS))
    else:
        luma = x
    luma = luma.float() * 255.0
    feats = []
    for scale in range(2):
        mscn = _mscn(luma)
        b = mscn.shape[0]
        feats.extend(_fit_ggd(mscn.reshape(b, -1), tab))
        for dy, dx in ((0, 1), (1, 0), (1, 1), (1, -1)):
            pair = mscn * torch.roll(mscn, shifts=(-dy, -dx), dims=(1, 2))
            a, m, sl, sr_ = _fit_aggd(pair.reshape(b, -1), tab)
            feats.extend([a, m, sl * sl, sr_ * sr_])
        if scale == 0:
            h, w = luma.shape[1] // 2 * 2, luma.shape[2] // 2 * 2
            v = luma[:, :h, :w]
            luma = (((v[:, 0::2, 0::2] + v[:, 0::2, 1::2]) + v[:, 1::2, 0::2])
                    + v[:, 1::2, 1::2]) / 4.0
    return torch.stack(feats, dim=-1)


# srtpu's natural-scene feature statistics for the fallback score
NSS_MEAN = np.array([2.0, 0.4] + [0.7, 0.0, 0.15, 0.15] * 4
                    + [2.0, 0.4] + [0.7, 0.0, 0.15, 0.15] * 4,
                    dtype=np.float32)
NSS_STD = np.array([0.6, 0.3] + [0.3, 0.05, 0.1, 0.1] * 4
                   + [0.6, 0.3] + [0.3, 0.05, 0.1, 0.1] * 4,
                   dtype=np.float32)


@functools.lru_cache(maxsize=8)
def _svm_file(path: str, mtime_ns: int, size: int) -> DeviceConst:
    with np.load(path) as d:
        return DeviceConst({k: np.asarray(d[k], np.float32)
                            for k in d.files})


def load_svm(device) -> dict[str, torch.Tensor] | None:
    """``$SRTPU_WEIGHTS_DIR/brisque_svm.npz`` on ``device`` (read and moved
    once per file version and device), or None where it does not exist."""
    path = Path(os.environ.get('SRTPU_WEIGHTS_DIR', 'weights')) / \
        'brisque_svm.npz'
    if not path.exists():
        return None
    st = path.stat()
    return _svm_file(str(path), st.st_mtime_ns, st.st_size).on(device)


def brisque(x: torch.Tensor) -> torch.Tensor:
    """The batch-mean BRISQUE score of NHWC ``x`` in [0, 1]."""
    feats = brisque_features(x)
    svm = load_svm(x.device)
    if svm is not None:
        lo, hi = svm['scale_min'], svm['scale_max']
        f = -1.0 + 2.0 * (feats - lo) / (hi - lo)
        d = ((svm['sv'][None, :, :] - f[:, None, :]) ** 2).sum(-1)
        score = (svm['alpha'][None, :] * torch.exp(-svm['gamma'] * d)
                 ).sum(-1) - svm['rho']
        return score.mean()
    tab = _tables().on(x.device)
    z = (feats - tab['nss_mean']) / tab['nss_std']
    return torch.sqrt((z * z).mean(-1)).mean() * 10.0
