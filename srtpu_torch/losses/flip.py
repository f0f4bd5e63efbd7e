"""FLIP, the perceptual difference of Andersson et al. (HPG 2020), as a
metric and a loss (srtpu/losses/flip.py), on NHWC sRGB in [0, 1], with
srtpu's parameters (0.7 m from a 0.7 m wide 3840 px monitor; qc 0.7,
qf 0.5, pc 0.4, pt 0.95) and its stability clamp of the feature error.

Each step is srtpu's, with JAX's gradients at ties (``losses.basic``:
``clip`` at the sRGB bounds and the feature clamp, ``abs_`` of the HyAB
lightness difference and of the feature difference, which are exactly 0
where the images agree; ``amax`` shares a tie between the two detectors
as ``jnp.max`` does). One thing differs: srtpu computes its 21x21 CSF
filters and its 19x19 edge and point filters (at the default pixels per
degree) as 441 and 361 shifted slices summed as a pairwise tree. Eager
PyTorch would make that thousands of launches a call in each direction,
so each filter here is one depthwise ``F.conv2d`` (the CSF per channel,
the two detectors as four output channels of the luma), whose sums run
in the convolution's order, not srtpu's tree. They run in full f32 on
a card too, forward and backward, whatever cuDNN's TF32 setting
(``imgops.conv2d_f32``: srtpu's sums are exact f32).

Where the SR equals the HR over a feature filter's width the feature
error is exactly 0, and its 0.5 power has an infinite derivative: the
gradient is NaN there, in srtpu and here alike.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..utils.imgops import DeviceConst, conv2d_f32, pad_nhwc
from .basic import abs_, clip

# D65 linear RGB -> XYZ (the published algorithm's rational constants)
RGB2XYZ = np.array([
    [10135552 / 24577794, 8788810 / 24577794, 4435075 / 24577794],
    [2613072 / 12288897, 8788810 / 12288897, 887015 / 12288897],
    [1425312 / 73733382, 8788810 / 73733382, 70074185 / 73733382],
], dtype=np.float64)
REF_ILLUMINANT = RGB2XYZ.sum(axis=1)     # linrgb_to_xyz(ones)
XYZ2RGB = np.linalg.inv(RGB2XYZ)

DEFAULT_PPD = 0.7 * (3840 / 0.7) * (math.pi / 180)


_CONSTS = DeviceConst({'rgb2xyz': RGB2XYZ, 'xyz2rgb': XYZ2RGB,
                       'ref': REF_ILLUMINANT})


def _const(name: str, x: torch.Tensor) -> torch.Tensor:
    return _CONSTS.on(x.device)[name]


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    x = clip(x, 0.0, 1.0)
    return torch.where(x > 0.04045, ((x + 0.055) / 1.055) ** 2.4, x / 12.92)


def _matmul_c(x: torch.Tensor, m: str) -> torch.Tensor:
    """A 3x3 colour matrix (cast to f32) on the channels-last axis."""
    return x @ _const(m, x).T


def linrgb_to_xyz(x):
    return _matmul_c(x, 'rgb2xyz')


def xyz_to_linrgb(x):
    return _matmul_c(x, 'xyz2rgb')


def xyz_to_ycxcz(x):
    x = x / _const('ref', x)
    y = 116.0 * x[..., 1:2] - 16.0
    cx = 500.0 * (x[..., 0:1] - x[..., 1:2])
    cz = 200.0 * (x[..., 1:2] - x[..., 2:3])
    return torch.cat([y, cx, cz], dim=-1)


def ycxcz_to_xyz(x):
    y = (x[..., 0:1] + 16.0) / 116.0
    cx = x[..., 1:2] / 500.0
    cz = x[..., 2:3] / 200.0
    return torch.cat([y + cx, y, y - cz], dim=-1) * \
        _const('ref', x)


def xyz_to_lab(x):
    """CIELAB; ``x`` is never negative here (a clipped linear RGB through
    a positive matrix), so the cube root is the 1/3 power."""
    x = x / _const('ref', x)
    delta = 6.0 / 29.0
    x = torch.where(x > 0.00885, x ** (1.0 / 3.0),
                    x / (3 * delta * delta) + 4.0 / 29.0)
    lum = 116.0 * x[..., 1:2] - 16.0
    a = 500.0 * (x[..., 0:1] - x[..., 1:2])
    b = 200.0 * (x[..., 1:2] - x[..., 2:3])
    return torch.cat([lum, a, b], dim=-1)


def srgb_to_ycxcz(x):
    return xyz_to_ycxcz(linrgb_to_xyz(srgb_to_linear(x)))


def linrgb_to_lab(x):
    return xyz_to_lab(linrgb_to_xyz(x))


@functools.lru_cache(maxsize=4)
def _csf_filters(ppd: float):
    """Per-channel CSF gaussians (A, RG, BY) at one radius: ((3, 1, k, k),
    the radius)."""
    params = {'A': (1.0, 0.0047, 0.0, 1e-5), 'RG': (1.0, 0.0053, 0.0, 1e-5),
              'BY': (34.1, 0.04, 13.5, 0.025)}
    max_b = 0.04
    r = int(np.ceil(3 * np.sqrt(max_b / (2 * np.pi ** 2)) * ppd))
    dx = 1.0 / ppd
    xs, ys = np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1))
    z = (xs * dx) ** 2 + (ys * dx) ** 2
    filters = []
    for key in ('A', 'RG', 'BY'):
        a1, b1, a2, b2 = params[key]
        g = (a1 * np.sqrt(np.pi / b1) * np.exp(-np.pi ** 2 * z / b1)
             + a2 * np.sqrt(np.pi / b2) * np.exp(-np.pi ** 2 * z / b2))
        filters.append((g / g.sum()).astype(np.float32))
    return DeviceConst(np.stack(filters)[:, None]), r


@functools.lru_cache(maxsize=4)
def _feature_filters(ppd: float):
    """The edge and point detectors in x, then in y (their transposes),
    as four output channels of one input, (4, 1, k, k); the radius."""
    w = 0.082
    sd = 0.5 * w * ppd
    r = int(np.ceil(3 * sd))
    xs, ys = np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1))
    g = np.exp(-(xs ** 2 + ys ** 2) / (2 * sd * sd))

    def normalize(gx):
        neg = -gx[gx < 0].sum()
        pos = gx[gx > 0].sum()
        return np.where(gx < 0, gx / neg, gx / pos).astype(np.float32)

    edge, point = normalize(-xs * g), normalize((xs ** 2 / (sd * sd) - 1) * g)
    return DeviceConst(np.stack([edge, point, edge.T, point.T])[:, None]), r


def _conv_valid(x: torch.Tensor, weight: DeviceConst,
                groups: int) -> torch.Tensor:
    """Valid correlation of NHWC ``x`` with an (O, 1, k, k) weight, one
    f32 convolution (module note)."""
    y = conv2d_f32(x.permute(0, 3, 1, 2), weight.on(x.device),
                   groups=groups)
    return y.permute(0, 2, 3, 1)


def _hunt(lab):
    lum = lab[..., 0:1]
    return torch.cat([lum, 0.01 * lum * lab[..., 1:2],
                      0.01 * lum * lab[..., 2:3]], dim=-1)


def _hyab(a, b):
    d = a - b
    return abs_(d[..., 0:1]) + torch.sqrt(
        d[..., 1:2] * d[..., 1:2] + d[..., 2:3] * d[..., 2:3] + 1e-20)


@functools.lru_cache(maxsize=4)
def _cmax(qc: float) -> float:
    """The HyAB distance of green and blue to the power ``qc``."""
    def lab(rgb):
        xyz = RGB2XYZ @ rgb / REF_ILLUMINANT
        delta, limit = 6 / 29, 0.00885
        f = np.where(xyz > limit, np.cbrt(xyz),
                     xyz / (3 * delta * delta) + 4 / 29)
        return np.array([116 * f[1] - 16, 500 * (f[0] - f[1]),
                         200 * (f[1] - f[2])])

    def hunt(v):
        return np.array([v[0], 0.01 * v[0] * v[1], 0.01 * v[0] * v[2]])

    d = hunt(lab(np.array([0.0, 1.0, 0.0]))) - hunt(lab(np.array(
        [0.0, 0.0, 1.0])))
    return float((abs(d[0]) + np.linalg.norm(d[1:])) ** qc)


def flip(reference: torch.Tensor, test: torch.Tensor,
         ppd: float = DEFAULT_PPD, qc: float = 0.7, qf: float = 0.5,
         pc: float = 0.4, pt: float = 0.95,
         mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean FLIP error of NHWC sRGB ``test`` against ``reference``;
    ``mask`` (NHW1) restricts the mean to a padded image's valid
    pixels."""
    reference, test = reference.float(), test.float()
    ref_ycc, test_ycc = srgb_to_ycxcz(reference), srgb_to_ycxcz(test)

    # the colour pipeline
    csf_w, radius = _csf_filters(ppd)

    def filter_clamp(ycc):
        filtered = _conv_valid(pad_nhwc(ycc, radius, radius, 'replicate'),
                               csf_w, groups=3)
        return clip(xyz_to_linrgb(ycxcz_to_xyz(filtered)), 0.0, 1.0)

    pre_ref = _hunt(linrgb_to_lab(filter_clamp(ref_ycc)))
    pre_test = _hunt(linrgb_to_lab(filter_clamp(test_ycc)))
    delta_e_hyab = _hyab(pre_ref, pre_test) ** qc
    cmax = _cmax(qc)
    pccmax = pc * cmax
    delta_e_c = torch.where(
        delta_e_hyab < pccmax, (pt / pccmax) * delta_e_hyab,
        pt + ((delta_e_hyab - pccmax) / (cmax - pccmax)) * (1.0 - pt))

    # the feature pipeline: edge x, point x, edge y, point y of the luma
    feat_w, fr = _feature_filters(ppd)

    def features(y):
        f = _conv_valid(pad_nhwc(y, fr, fr, 'replicate'), feat_w, groups=1)
        fx, fy = f[..., 0:2], f[..., 2:4]
        return torch.sqrt(fx * fx + fy * fy + 1e-20)

    f_ref = features((ref_ycc[..., 0:1] + 16.0) / 116.0)
    f_test = features((test_ycc[..., 0:1] + 16.0) / 116.0)
    delta_e_f = torch.amax(abs_(f_ref - f_test), dim=-1, keepdim=True)
    delta_e_f = clip(((1.0 / math.sqrt(2.0)) * delta_e_f) ** qf, 0.0, 1.0)

    err = delta_e_c ** (1.0 - delta_e_f)
    if mask is not None:
        m = mask.float().expand_as(err)
        return (err * m).sum() / torch.clamp_min(m.sum(), 1.0)
    return err.mean()


def flip_loss(sr: torch.Tensor, hr: torch.Tensor, **kwargs) -> torch.Tensor:
    """FLIP as a loss: the HR is the reference image."""
    return flip(hr, sr, **kwargs)
