"""VGG16 / VGG19 features and the perceptual losses on them
(srtpu/losses/vgg.py): :class:`VGGLoss` (feature MSE at one relu layer,
SRGAN's content term), :class:`LPIPS` (VGG16, channel-unit-normalised
squared differences, per-channel linear weights, a spatial mean, summed
over five taps) and :class:`DISTS` (VGG16 with L2 pooling: texture and
structure terms per stage, alpha / beta weights).

Nothing is downloaded. The weights are converted torchvision features
read from ``$SRTPU_WEIGHTS_DIR/vgg{16,19}_features.npz`` (default
directory ``weights``), LPIPS's ``lpips_lin.npz`` and DISTS's
``dists_ab.npz``, only where those files already exist; otherwise
srtpu's deterministic random init (the same numpy draw in the same
order, ``np.random.default_rng(rng_seed)``), unit LPIPS weights over the
channels and uniform DISTS weights, with srtpu's warnings. So the port
and srtpu compute the same features from the same files. The backbones
are frozen: their tensors take no gradient and sit in no optimizer or
checkpoint; each loss moves them to the SR's device at its first call
there and keeps them.

The networks run in f32, as srtpu's do, NCHW here. LPIPS's and DISTS's
VGG16 convolutions run in full f32 on a card, forward and backward
(``imgops.conv2d_f32``): under PyTorch's default cuDNN would take them
in TF32 (10-bit products), which moved their SR gradients by 8-21% of
the largest against the CPU's f32 on an H100. :class:`VGGLoss`'s VGG19
(SRGAN's content term) keeps cuDNN's default.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.imgops import DeviceConst, conv2d_f32, tree_sum

_logger = logging.getLogger(__name__)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# conv channel plans; 'M' = 2x2 max pool
VGG16_PLAN = (64, 64, 'M', 128, 128, 'M', 256, 256, 256, 'M',
              512, 512, 512, 'M', 512, 512, 512, 'M')
VGG19_PLAN = (64, 64, 'M', 128, 128, 'M', 256, 256, 256, 256, 'M',
              512, 512, 512, 512, 'M', 512, 512, 512, 512, 'M')
PLANS = {'vgg16': VGG16_PLAN, 'vgg19': VGG19_PLAN}


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


def _weights_dir(weights_dir=None) -> Path:
    return Path(weights_dir or os.environ.get('SRTPU_WEIGHTS_DIR', 'weights'))


def _try_load(net_type: str, path: Path):
    if path.exists():
        with np.load(path) as f:
            data = dict(f)
        _logger.info('Loaded %s features from %s', net_type, path)
        return data
    _logger.warning(
        '%s pretrained weights not found at %s — using deterministic random '
        'init. Perceptual losses/metrics (VGG/LPIPS/DISTS) need converted '
        'weights for fidelity; see tools/convert_torch_weights.py.',
        net_type, path)
    return None


def init_vgg_params(net_type: str = 'vgg19', rng_seed: int = 0,
                    weights=None
                    ) -> tuple[list[tuple[np.ndarray, np.ndarray]], bool]:
    """([(HWIO kernel, bias) per conv], whether converted weights were
    found): srtpu's ``init_vgg_params(net_type, rng_seed, weights,
    return_loaded=True)``, ``weights`` defaulting to
    ``$SRTPU_WEIGHTS_DIR/<net_type>_features.npz``; the random init draws
    U(+-1/sqrt(9 cin)) kernel then bias, conv by conv."""
    plan = PLANS[net_type]
    path = Path(weights) if weights is not None else \
        _weights_dir() / f'{net_type}_features.npz'
    loaded = _try_load(net_type, path)
    rng = np.random.default_rng(rng_seed)
    params, in_c = [], 3
    for p, conv_i in zip((p for p in plan if p != 'M'),
                         _torchvision_conv_indices(plan)):
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


def to_torch(params, device=None) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """(OIHW kernel, bias) tensors of :func:`init_vgg_params`' list."""
    return [(torch.from_numpy(k).permute(3, 2, 0, 1).contiguous().to(device),
             torch.from_numpy(b).to(device)) for k, b in params]


def _l2_pool(x: torch.Tensor) -> torch.Tensor:
    """Depthwise L2 pooling of NCHW ``x`` (the DISTS paper's): the square
    root of a 3x3 hann-windowed sum of squares at stride 2, padding 1 —
    srtpu's nine strided slices summed as a pairwise tree."""
    w = np.hanning(5)[1:-1]
    k = np.outer(w, w)
    k = (k / k.sum()).astype(np.float32)
    xsq = F.pad(x * x, (1, 1, 1, 1))
    oh, ow = (xsq.shape[2] - 3) // 2 + 1, (xsq.shape[3] - 3) // 2 + 1
    terms = [float(k[i, j]) * xsq[:, :, i:i + 2 * (oh - 1) + 1:2,
                                  j:j + 2 * (ow - 1) + 1:2]
             for i in range(3) for j in range(3)]
    return torch.sqrt(tree_sum(terms) + 1e-12)


def vgg_features(params, x: torch.Tensor, taps: tuple[str, ...],
                 plan=VGG19_PLAN, pool: str = 'max',
                 mask: torch.Tensor | None = None, f32: bool = False):
    """The conv stack (3x3 SAME conv + bias + ReLU; 2x2 max or L2 pools)
    on NCHW ``x``, stopping at the last of ``taps``: ({tap: activation},
    {tap: its N1HW validity mask or None}) (srtpu's ``vgg_features``).

    With ``mask`` (N1HW validity of a top-left rectangle, the padded
    eval image's), the activations are zeroed outside it after every
    layer and the mask is min-pooled by every max pool, so a padded
    image computes, inside its valid region, what its unpadded original
    does. ``params`` are (OIHW kernel, bias) per conv. ``f32`` runs the
    convolutions in full f32 on a card (module note)."""
    if mask is not None and pool != 'max':
        raise ValueError('masking is implemented for max pooling')
    out, masks, conv_i = {}, {}, 0
    if mask is not None:
        mask = mask.to(x.dtype)
        x = x * mask
    for p, name in zip(plan, _layer_names(plan)):
        if p == 'M':
            if pool == 'l2':
                x = _l2_pool(x)
            else:
                x = F.max_pool2d(x, 2)
                if mask is not None:
                    mask = -F.max_pool2d(-mask, 2)
        else:
            w, b = params[conv_i]
            conv = conv2d_f32 if f32 else F.conv2d
            x = F.relu(conv(x, w, b, padding=1))
            conv_i += 1
        if mask is not None:
            x = x * mask
        if name in taps and name not in out:
            out[name], masks[name] = x, mask
        if len(out) == len(taps):
            return out, masks
    raise ValueError(f'Unknown VGG taps: {sorted(set(taps) - set(out))}')


def _normalize_imagenet(x: torch.Tensor, mean: torch.Tensor,
                        std: torch.Tensor) -> torch.Tensor:
    """NHWC [0, 1] -> ImageNet-normalised f32 NCHW."""
    return ((x.float() - mean) / std).permute(0, 3, 1, 2)


class VGGLoss:
    """Feature MSE at one VGG19 relu layer, x ``rescale`` (srtpu
    ``VGGLoss('vgg19', layer)``): sr and hr in [0, 1] NHWC,
    ImageNet-normalised in f32. hr's features are taken without
    autograd."""

    LAYERS = ('relu1_2', 'relu2_2', 'relu3_4', 'relu4_4', 'relu5_4')

    def __init__(self, layer: str = 'relu5_4', rescale: float = 0.006,
                 device=None):
        if layer not in self.LAYERS:
            raise ValueError(f'{layer} invalid for vgg19')
        self.layer, self.rescale = layer, rescale
        params, self.pretrained = init_vgg_params()
        self.params = to_torch(params, device)
        self.mean = torch.tensor(IMAGENET_MEAN, device=device)
        self.std = torch.tensor(IMAGENET_STD, device=device)

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        x = _normalize_imagenet(x, self.mean, self.std)
        return vgg_features(self.params, x, (self.layer,))[0][self.layer]

    def __call__(self, sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            f_hr = self._features(hr)
        return (self._features(sr) - f_hr).square().mean() * self.rescale


LPIPS_TAPS = ('relu1_2', 'relu2_2', 'relu3_3', 'relu4_3', 'relu5_3')
# LPIPS normalises its inputs with its own shift and scale
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)
VGG16_DIMS = (64, 128, 256, 512, 512)


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt((x * x).sum(1, keepdim=True)) + eps)


class LPIPS:
    """Learned perceptual metric over VGG16 features (srtpu ``LPIPS``,
    piq's): NHWC sr and hr in [0, 1]; ``mask`` (NHW1) takes each tap's
    spatial mean over the valid pixels only."""

    trainable = False

    def __init__(self, weights_dir=None, rng_seed: int = 0):
        wdir = _weights_dir(weights_dir)
        params, vgg_loaded = init_vgg_params(
            'vgg16', rng_seed, wdir / 'vgg16_features.npz')
        lin, lin_loaded = self._load_lin(wdir)
        self.pretrained = vgg_loaded and lin_loaded
        self._frozen = DeviceConst((to_torch(params), lin, (
            torch.tensor(LPIPS_SHIFT), torch.tensor(LPIPS_SCALE))))

    @staticmethod
    def _load_lin(wdir: Path):
        path = wdir / 'lpips_lin.npz'
        if path.exists():
            with np.load(path) as data:
                return [torch.from_numpy(np.asarray(data[f'lin{i}'],
                                                    np.float32))
                        for i in range(5)], True
        _logger.warning('LPIPS linear weights not found at %s — using unit '
                        'weights (feature distances unweighted).', path)
        return [torch.ones(d) / d for d in VGG16_DIMS], False

    def __call__(self, sr: torch.Tensor, hr: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
        params, lins, (shift, scale) = self._frozen.on(sr.device)

        def prep(x):
            return ((x.float() * 2.0 - 1.0 - shift) / scale).permute(0, 3,
                                                                     1, 2)
        m = None if mask is None else mask.float().permute(0, 3, 1, 2)
        f_sr, msks = vgg_features(params, prep(sr), LPIPS_TAPS, VGG16_PLAN,
                                  mask=m, f32=True)
        f_hr, _ = vgg_features(params, prep(hr), LPIPS_TAPS, VGG16_PLAN,
                               mask=m, f32=True)
        total = 0.0
        for tap, lin in zip(LPIPS_TAPS, lins):
            d = (_unit_normalize(f_sr[tap]) - _unit_normalize(f_hr[tap])) ** 2
            d = (d * lin[:, None, None]).sum(1)         # the learned 1x1
            if msks[tap] is None:
                total = total + d.mean((1, 2))
            else:
                m2 = msks[tap][:, 0]
                total = total + (d * m2).sum((1, 2)) / torch.clamp_min(
                    m2.sum((1, 2)), 1.0)
        return total.mean()


class DISTS:
    """Deep image structure and texture similarity (srtpu ``DISTS``,
    piq's): per VGG16 stage (and the image itself) a texture term of the
    means and a structure term of the covariances, weighted by alpha and
    beta; the loss is 1 - the score."""

    trainable = False
    DIMS = (3,) + VGG16_DIMS

    def __init__(self, weights_dir=None, rng_seed: int = 0):
        wdir = _weights_dir(weights_dir)
        params, vgg_loaded = init_vgg_params(
            'vgg16', rng_seed, wdir / 'vgg16_features.npz')
        (alpha, beta), ab_loaded = self._load_ab(wdir)
        self.pretrained = vgg_loaded and ab_loaded
        self._frozen = DeviceConst((to_torch(params), alpha, beta, (
            torch.tensor(IMAGENET_MEAN), torch.tensor(IMAGENET_STD))))

    def _load_ab(self, wdir: Path):
        path = wdir / 'dists_ab.npz'
        if path.exists():
            with np.load(path) as data:
                return ([torch.from_numpy(np.asarray(data[f'alpha{i}'],
                                                     np.float32))
                         for i in range(6)],
                        [torch.from_numpy(np.asarray(data[f'beta{i}'],
                                                     np.float32))
                         for i in range(6)]), True
        _logger.warning('DISTS alpha/beta weights not found at %s — using '
                        'uniform weights.', path)
        total = sum(self.DIMS) * 2
        return ([torch.full((d,), 1.0 / total) for d in self.DIMS],
                [torch.full((d,), 1.0 / total) for d in self.DIMS]), False

    def __call__(self, sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
        params, alphas, betas, norm = self._frozen.on(sr.device)
        c1 = c2 = 1e-6
        sr_taps = vgg_features(params, _normalize_imagenet(sr, *norm),
                               LPIPS_TAPS, VGG16_PLAN, pool='l2',
                               f32=True)[0]
        hr_taps = vgg_features(params, _normalize_imagenet(hr, *norm),
                               LPIPS_TAPS, VGG16_PLAN, pool='l2',
                               f32=True)[0]
        feats_sr = [sr.float().permute(0, 3, 1, 2)] + [sr_taps[t]
                                                       for t in LPIPS_TAPS]
        feats_hr = [hr.float().permute(0, 3, 1, 2)] + [hr_taps[t]
                                                       for t in LPIPS_TAPS]
        score = 0.0
        for fx, fy, a, b in zip(feats_sr, feats_hr, alphas, betas):
            mx, my = fx.mean((2, 3)), fy.mean((2, 3))
            vx = (fx * fx).mean((2, 3)) - mx * mx
            vy = (fy * fy).mean((2, 3)) - my * my
            cxy = (fx * fy).mean((2, 3)) - mx * my
            tex = (2 * mx * my + c1) / (mx * mx + my * my + c1)
            struct = (2 * cxy + c2) / (vx + vy + c2)
            score = score + (a * tex + b * struct).sum(-1).mean()
        return 1.0 - score
