"""PieAPP, perceptual image-error assessment through pairwise preference
(srtpu/losses/pieapp.py; Prashnani et al. 2018, v0.1): one CNN (11 3x3
convs, 2x2 max pools after every second, taps after convs 3, 5, 7, 9
and 11) on 64 x 64 patches at stride 27, two MLP heads on the
HR-minus-SR features (a score and, on the coarse features, a weight) and
the weighted mean score. Lower is better.

The weights are ``$SRTPU_WEIGHTS_DIR/pieapp.npz`` where it exists, else
srtpu's deterministic random init (``np.random.default_rng(0)``, srtpu's
draw order), with its warning. They are frozen (no gradient, no
optimizer, no checkpoint) and moved to the SR's device once.

srtpu loops over the images and runs each one's patches through the
network; here every patch of the batch is one batch of the network (the
features are the same per patch), and the per-image sums of score x
weight and of weight are added image after image, srtpu's order of the
two sums. Taps are flattened in srtpu's NHWC order, so its fully
connected weights apply as they lie. The convs run in full f32 on a
card, forward and backward (``imgops.conv2d_f32``; in TF32 they moved
the SR gradient by 21% of its largest on an H100); the heads' matmuls
are f32 (PyTorch's default keeps TF32 off for matmuls).
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.imgops import DeviceConst, conv2d_f32
from .basic import abs_

_logger = logging.getLogger(__name__)

PATCH = 64
STRIDE = 27
# (out_channels, a 2x2 max pool after)
CONV_PLAN = ((64, False), (64, True), (64, False), (128, True),
             (128, False), (128, True), (128, False), (256, True),
             (256, False), (512, True), (512, False))
TAPS = (3, 5, 7, 9, 11)


def feature_length() -> int:
    size, total = PATCH, 0
    for i, (out_c, pool) in enumerate(CONV_PLAN, 1):
        if i in TAPS:
            total += size * size * out_c
        if pool:
            size //= 2
    return total


def _try_load(weights):
    path = Path(weights) if weights is not None else Path(
        os.environ.get('SRTPU_WEIGHTS_DIR', 'weights')) / 'pieapp.npz'
    if path.exists():
        _logger.info('Loaded PieAPP weights from %s', path)
        with np.load(path) as f:
            return dict(f)
    _logger.warning('PieAPP pretrained weights not found at %s — using '
                    'deterministic random init (ordering-only proxy).', path)
    return None


def init_params(rng_seed: int = 0, weights=None):
    """({'convs': [(OIHW, bias)], 'fc_score' / 'fc_weight': [(w (in,
    out), bias)] x 2}, whether ``pieapp.npz`` was found), srtpu's draw."""
    loaded = _try_load(weights)
    rng = np.random.default_rng(rng_seed)
    params = {'convs': []}
    in_c = 3
    for i, (out_c, _) in enumerate(CONV_PLAN):
        if loaded is not None:
            k = np.transpose(loaded[f'conv{i + 1}.weight'], (2, 3, 1, 0))
            b = loaded[f'conv{i + 1}.bias']
        else:
            bound = 1.0 / np.sqrt(9 * in_c)
            k = rng.uniform(-bound, bound, (3, 3, in_c, out_c)).astype(
                np.float32)
            b = rng.uniform(-bound, bound, out_c).astype(np.float32)
        params['convs'].append((
            torch.from_numpy(np.asarray(k, np.float32)).permute(
                3, 2, 0, 1).contiguous(),
            torch.from_numpy(np.asarray(b, np.float32))))
        in_c = out_c

    def fc_stack(name, in_dim):
        out = []
        for j, (a, b_) in enumerate(((in_dim, 512), (512, 1))):
            if loaded is not None:
                w = loaded[f'{name}{j + 1}.weight'].T
                bias = loaded[f'{name}{j + 1}.bias']
            else:
                bound = 1.0 / np.sqrt(a)
                w = rng.uniform(-bound, bound, (a, b_)).astype(np.float32)
                bias = rng.uniform(-bound, bound, b_).astype(np.float32)
            out.append((torch.from_numpy(np.ascontiguousarray(w, np.float32)),
                        torch.from_numpy(np.asarray(bias, np.float32))))
        return out

    params['fc_score'] = fc_stack('fc_score', feature_length())
    params['fc_weight'] = fc_stack('fc_weight', 512 * 2 * 2)
    return params, loaded is not None


def _flat(h: torch.Tensor) -> torch.Tensor:
    """NCHW -> (N, H * W * C), srtpu's NHWC flattening."""
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


def _pool(h: torch.Tensor) -> torch.Tensor:
    """The 2x2 / 2 max pool."""
    return F.max_pool2d(h, 2)


def extract_features(params, x: torch.Tensor):
    """NCHW 64 x 64 patches -> (the concatenated taps, the coarse
    features)."""
    taps, h = [], x
    for i, ((k, b), (_, pool)) in enumerate(zip(params['convs'], CONV_PLAN),
                                            1):
        h = F.relu(conv2d_f32(h, k, b, padding=1))
        if i in TAPS:
            taps.append(_flat(h))
        if pool:
            h = _pool(h)
    return torch.cat(taps, dim=1), _flat(h)


def _mlp(stack, x):
    (w1, b1), (w2, b2) = stack
    return F.relu(x @ w1 + b1) @ w2 + b2


def patches(img: torch.Tensor) -> torch.Tensor:
    """NHWC (B, H, W, C) -> NCHW (B * ny * nx, C, 64, 64), srtpu's grid
    (rows, then columns, at stride 27 from 0, image after image)."""
    b, h, w, c = img.shape
    if h < PATCH or w < PATCH:
        raise ValueError(f'PieAPP needs images of at least {PATCH} x '
                         f'{PATCH}, got {h} x {w}')
    p = img.unfold(1, PATCH, STRIDE).unfold(2, PATCH, STRIDE)
    return p.reshape(-1, c, PATCH, PATCH)


class PieAPP:
    """PieAPP of NHWC sr against hr in [0, 1] (the composite clamps the
    SR first); images of at least 64 x 64."""

    trainable = False

    def __init__(self, weights=None, rng_seed: int = 0):
        params, self.pretrained = init_params(rng_seed, weights)
        self._frozen = DeviceConst(params)

    def __call__(self, sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
        params = self._frozen.on(sr.device)
        n = sr.shape[0]
        f_sr, c_sr = extract_features(params, patches(sr.float()))
        f_hr, c_hr = extract_features(params, patches(hr.float()))
        score = _mlp(params['fc_score'], f_hr - f_sr)[:, 0]
        weight = abs_(_mlp(params['fc_weight'], c_hr - c_sr)[:, 0] + 1e-6)
        per_score = (score * weight).view(n, -1).sum(1)
        per_weight = weight.view(n, -1).sum(1)
        total, wsum = 0.0, 0.0
        for i in range(n):
            total = total + per_score[i]
            wsum = wsum + per_weight[i]
        return total / wsum
