"""VGG19 features and the VGG feature loss (srtpu/losses/vgg.py:
``VGG19_PLAN``, ``init_vgg_params``, ``vgg_features`` without masks,
``VGGLoss``), SRGAN's content term. VGG16, LPIPS and DISTS wait for
ROADMAP.md queue 1, item 15.

Nothing is downloaded. The weights are converted torchvision features
read from ``$SRTPU_WEIGHTS_DIR/vgg19_features.npz`` (default directory
``weights``) only where that file already exists; otherwise they are
srtpu's deterministic random init, the same numpy draw in the same order
(``np.random.default_rng(0)``), with srtpu's warning. So the port and
srtpu compute the same features from the same files.

The network runs in f32, as srtpu's does. On the card its convolutions
go to cuDNN under PyTorch's default, which lets cuDNN take f32
convolutions in TF32 (``torch.backends.cudnn.allow_tf32`` is True unless
a caller turns it off); the port leaves that default as it is.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

_logger = logging.getLogger(__name__)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# the conv channel plan; 'M' = 2x2 max pool
VGG19_PLAN = (64, 64, 'M', 128, 128, 'M', 256, 256, 256, 256, 'M',
              512, 512, 512, 512, 'M', 512, 512, 512, 512, 'M')


def _layer_names(plan) -> list[str]:
    names, block, idx = [], 1, 1
    for p in plan:
        if p == 'M':
            names.append(f'pool{block}')
            block, idx = block + 1, 1
        else:
            names.append(f'relu{block}_{idx}')
            idx += 1
    return names


def _torchvision_conv_indices(plan) -> list[int]:
    idx, out = 0, []
    for p in plan:
        if p == 'M':
            idx += 1
        else:
            out.append(idx)
            idx += 2  # conv + relu
    return out


def _try_load():
    path = Path(os.environ.get('SRTPU_WEIGHTS_DIR', 'weights')) / \
        'vgg19_features.npz'
    if path.exists():
        with np.load(path) as f:
            data = dict(f)
        _logger.info('Loaded vgg19 features from %s', path)
        return data
    _logger.warning(
        'vgg19 pretrained weights not found at %s — using deterministic '
        'random init. Perceptual losses/metrics (VGG/LPIPS/DISTS) need '
        'converted weights for fidelity; see tools/convert_torch_weights.py.',
        path)
    return None


def init_vgg_params() -> tuple[list[tuple[np.ndarray, np.ndarray]], bool]:
    """([(HWIO kernel, bias) per conv], whether converted weights were
    found): srtpu's ``init_vgg_params('vgg19', return_loaded=True)``; the
    random init draws U(+-1/sqrt(9 cin)) kernel then bias, conv by conv,
    from ``np.random.default_rng(0)``."""
    loaded = _try_load()
    rng = np.random.default_rng(0)
    params, in_c = [], 3
    for p, conv_i in zip((p for p in VGG19_PLAN if p != 'M'),
                         _torchvision_conv_indices(VGG19_PLAN)):
        if loaded is not None:
            kernel = np.transpose(loaded[f'features.{conv_i}.weight'],
                                  (2, 3, 1, 0))     # torch OIHW -> HWIO
            b = loaded[f'features.{conv_i}.bias']
        else:
            bound = 1.0 / np.sqrt(3 * 3 * in_c)
            kernel = rng.uniform(-bound, bound, (3, 3, in_c, p)).astype(
                np.float32)
            b = rng.uniform(-bound, bound, p).astype(np.float32)
        params.append((np.asarray(kernel, np.float32),
                       np.asarray(b, np.float32)))
        in_c = p
    return params, loaded is not None


def vgg_features(params: list[tuple[torch.Tensor, torch.Tensor]],
                 x: torch.Tensor, taps: tuple[str, ...]
                 ) -> dict[str, torch.Tensor]:
    """The conv stack (3x3 SAME conv + bias + ReLU; 2x2 max pools) on NCHW
    x in its dtype, stopping at the last of ``taps``: {tap: activation}
    (srtpu's ``vgg_features`` without a mask, on NCHW). ``params`` are
    (OIHW kernel, bias) per conv."""
    out, conv_i = {}, 0
    for p, name in zip(VGG19_PLAN, _layer_names(VGG19_PLAN)):
        if p == 'M':
            x = F.max_pool2d(x, 2)
        else:
            w, b = params[conv_i]
            x = F.relu(F.conv2d(x, w, b, padding=1))
            conv_i += 1
        if name in taps:
            out[name] = x
        if len(out) == len(taps):
            return out
    raise ValueError(f'Unknown VGG taps: {sorted(set(taps) - set(out))}')


class VGGLoss:
    """Feature MSE at one VGG19 relu layer, x ``rescale`` (srtpu
    ``VGGLoss('vgg19', layer)``): sr and hr in [0, 1] NHWC,
    ImageNet-normalised in f32. The weights are frozen (no gradients);
    hr's features are taken without autograd."""

    LAYERS = ('relu1_2', 'relu2_2', 'relu3_4', 'relu4_4', 'relu5_4')

    def __init__(self, layer: str = 'relu5_4', rescale: float = 0.006,
                 device=None):
        if layer not in self.LAYERS:
            raise ValueError(f'{layer} invalid for vgg19')
        self.layer, self.rescale = layer, rescale
        params, self.pretrained = init_vgg_params()
        self.params = [
            (torch.from_numpy(k).permute(3, 2, 0, 1).contiguous().to(device),
             torch.from_numpy(b).to(device)) for k, b in params]
        self.mean = torch.tensor(IMAGENET_MEAN, device=device)
        self.std = torch.tensor(IMAGENET_STD, device=device)

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        x = ((x.float() - self.mean) / self.std).permute(0, 3, 1, 2)
        return vgg_features(self.params, x, (self.layer,))[self.layer]

    def __call__(self, sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            f_hr = self._features(hr)
        return (self._features(sr) - f_hr).square().mean() * self.rescale
