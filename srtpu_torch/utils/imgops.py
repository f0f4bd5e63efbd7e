"""Image-processing primitives on NHWC tensors (srtpu/utils/imgops.py):
grayscale, invert, a separable gaussian blur, Sobel gradients and
magnitude, the Laplacian and Canny, for the edge and pencil-sketch
losses and their val images.

The arithmetic is srtpu's, in its order: a filter is the shifted slices
of the padded image, each scaled by a nonzero tap, summed as a pairwise
tree in tap order (:func:`_depthwise`), not a convolution, whose sums
run in another order. Canny decides from that arithmetic (its
non-maximum suppression compares neighbours with ``>=``; its angle bins
round ``atan2``), so the order is kept. Its hysteresis runs srtpu's
fixed 16 propagation steps, not kornia's loop until nothing changes.
srtpu leaves all of this to XLA; here it is stock PyTorch ops.
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

# ITU-R BT.601 luma weights (kornia's rgb_to_grayscale)
GRAY_WEIGHTS = (0.299, 0.587, 0.114)


class DeviceConst:
    """A constant (a numpy array or a tensor, or a dict / list / tuple of
    them; arrays as f32 tensors) moved to a device at its first use there
    and kept, so a loss or a metric makes no host-to-device copy a call.
    The one cache of the losses' and metrics' constants: a module's
    tables and filters, a frozen backbone's weights (held by its loss and
    freed with it)."""

    def __init__(self, tree):
        self._by_device = {'cpu': _tree_to(tree, 'cpu')}

    def on(self, device):
        key = str(device)
        if key not in self._by_device:
            self._by_device[key] = _tree_to(self._by_device['cpu'], device)
        return self._by_device[key]


def _tree_to(tree, device):
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(np.asarray(tree, np.float32), device=device)
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return type(tree)(_tree_to(v, device) for v in tree)


@contextlib.contextmanager
def cudnn_tf32(on: bool):
    """cuDNN's TF32 for f32 convolutions set to ``on`` inside the block
    (PyTorch's default is on), the setting restored after."""
    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32
    cudnn.allow_tf32 = on
    try:
        yield
    finally:
        cudnn.allow_tf32 = saved


class _Conv2dF32(torch.autograd.Function):
    """``F.conv2d`` (stride 1) whose forward and backward both run with
    cuDNN's TF32 off."""

    @staticmethod
    def forward(ctx, x, w, b, padding, groups):
        with cudnn_tf32(False):
            y = F.conv2d(x, w, b, padding=padding, groups=groups)
        ctx.save_for_backward(x, w)
        ctx.conf = (padding, groups, b is not None)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        padding, groups, has_b = ctx.conf
        need = ctx.needs_input_grad
        with cudnn_tf32(False):
            gx, gw, gb = torch.ops.aten.convolution_backward(
                g, x, w, [w.shape[0]] if has_b else None, [1, 1],
                [padding, padding], [1, 1], False, [0, 0], groups,
                [need[0], need[1], has_b and need[2]])
        return gx, gw, gb, None, None


def conv2d_f32(x: torch.Tensor, w: torch.Tensor, b=None, padding: int = 0,
               groups: int = 1) -> torch.Tensor:
    """NCHW ``F.conv2d`` at stride 1 in full f32 on a card, forward and
    backward: srtpu's convolutions are f32, and cuDNN would take f32
    convolutions in TF32 (10-bit products) under PyTorch's default. The
    setting is turned off around each cuDNN call and restored after, so
    nothing else changes; on the CPU it is the plain convolution. The
    frozen filters of FLIP, BRISQUE, VGG16 (LPIPS, DISTS) and PieAPP run
    here."""
    return _Conv2dF32.apply(x, w, b, padding, groups)


def rgb_to_grayscale(x: torch.Tensor) -> torch.Tensor:
    """NHWC RGB -> NHW1 luma, the three products summed left to right."""
    if x.shape[-1] == 1:
        return x
    r, g, b = (x[..., i:i + 1] * w for i, w in enumerate(GRAY_WEIGHTS))
    return r + g + b


def invert(x: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    return max_val - x


def pad_nhwc(x: torch.Tensor, ph: int, pw: int, mode: str) -> torch.Tensor:
    """Pad H by ``ph`` and W by ``pw`` on both sides: ``constant`` (zeros),
    ``reflect`` (numpy's: the edge not repeated) or ``replicate``."""
    if ph == 0 and pw == 0:
        return x
    if mode == 'constant':
        return F.pad(x, (0, 0, pw, pw, ph, ph))
    return F.pad(x.permute(0, 3, 1, 2), (pw, pw, ph, ph),
                 mode=mode).permute(0, 2, 3, 1)


def tree_sum(terms: list) -> torch.Tensor:
    """Pairwise sum of ``terms`` in srtpu's order."""
    while len(terms) > 1:
        terms = [terms[i] + terms[i + 1]
                 for i in range(0, len(terms) - 1, 2)] \
            + ([terms[-1]] if len(terms) % 2 else [])
    return terms[0]


def _depthwise(x: torch.Tensor, kernel2d) -> torch.Tensor:
    """Valid correlation of NHWC ``x`` with one 2-D kernel for every
    channel: the slice at each nonzero tap times the tap, as an f32
    scalar, summed as a pairwise tree in row-major tap order."""
    k2 = np.asarray(kernel2d, np.float32)
    kh, kw = k2.shape
    n, m = x.shape[1] - kh + 1, x.shape[2] - kw + 1
    terms = [float(k2[i, j]) * x[:, i:i + n, j:j + m]
             for i in range(kh) for j in range(kw) if float(k2[i, j]) != 0.0]
    return tree_sum(terms)


@functools.lru_cache(maxsize=32)
def _gaussian_1d(size: int, sigma: float) -> np.ndarray:
    xs = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(xs ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def gaussian_blur2d(x: torch.Tensor, kernel_size, sigma=1.0,
                    border_type: str = 'reflect') -> torch.Tensor:
    """Separable gaussian blur: the rows' 1-D pass, then the columns'."""
    kh, kw = (kernel_size, kernel_size) if isinstance(kernel_size, int) \
        else kernel_size
    sh, sw = (sigma, sigma) if isinstance(sigma, (int, float)) else sigma
    x = _depthwise(pad_nhwc(x, kh // 2, 0, border_type),
                   _gaussian_1d(kh, sh)[:, None])
    return _depthwise(pad_nhwc(x, 0, kw // 2, border_type),
                      _gaussian_1d(kw, sw)[None, :])


SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=np.float32)


def spatial_gradient(x: torch.Tensor, normalized: bool = True):
    """Sobel (gx, gy) of NHWC ``x`` with reflect padding (kornia's
    ``spatial_gradient``)."""
    kx = SOBEL_X / 8.0 if normalized else SOBEL_X
    xp = pad_nhwc(x, 1, 1, 'reflect')
    return _depthwise(xp, kx), _depthwise(xp, kx.T)


def sobel(x: torch.Tensor, normalized: bool = True,
          eps: float = 1e-6) -> torch.Tensor:
    """Sobel edge magnitude (kornia's ``sobel``)."""
    gx, gy = spatial_gradient(x, normalized)
    return torch.sqrt(gx * gx + gy * gy + eps)


@functools.lru_cache(maxsize=32)
def _laplacian_kernel(size: int, normalized: bool = True) -> np.ndarray:
    k = np.ones((size, size), dtype=np.float32)
    k[size // 2, size // 2] = 1.0 - size * size
    if normalized:
        k = k / np.abs(k).sum()
    return k


def laplacian(x: torch.Tensor, kernel_size: int,
              normalized: bool = True) -> torch.Tensor:
    """Laplacian filter with reflect padding (kornia's ``laplacian``)."""
    p = kernel_size // 2
    return _depthwise(pad_nhwc(x, p, p, 'reflect'),
                      _laplacian_kernel(kernel_size, normalized))


# neighbour offsets (dy, dx) of the 8 directions -180, -135, ..., 135
_OFFSETS = ((0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0),
            (-1, 1))


def canny(x: torch.Tensor, low_threshold: float = 0.1,
          high_threshold: float = 0.2, kernel_size: int = 5,
          sigma: float = 1.0, hysteresis_iters: int = 16,
          eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """(the non-maximum-suppressed magnitude, the binary edges) of NHWC
    ``x`` (srtpu's ``canny``): a 5x5 gaussian blur, unnormalised Sobel,
    the angle rounded to one of 8 directions, a pixel kept where it is at
    least both neighbours along its direction (zeros outside), then
    ``hysteresis_iters`` steps that grow the strong edges into 3x3
    neighbouring weak ones."""
    blurred = gaussian_blur2d(x, (kernel_size, kernel_size), (sigma, sigma))
    gx, gy = spatial_gradient(blurred, normalized=False)
    magnitude = torch.sqrt(gx * gx + gy * gy + eps)
    ang = torch.round(torch.atan2(gy, gx) * (180.0 / math.pi) / 45.0) * 45.0
    h, w = magnitude.shape[1], magnitude.shape[2]
    mag_pad = pad_nhwc(magnitude, 1, 1, 'constant')

    def shifted(dy, dx):
        return mag_pad[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    nms = torch.zeros_like(magnitude, dtype=torch.bool)
    for i, (dy, dx) in enumerate(_OFFSETS):
        direction = -180.0 + 45.0 * i
        sel = (ang == direction) | (ang == direction + 360.0)
        is_max = (magnitude >= shifted(dy, dx)) & \
            (magnitude >= shifted(-dy, -dx))
        nms = nms | (sel & is_max)
    thin_mag = magnitude * nms

    strong = thin_mag > high_threshold
    weak = (thin_mag > low_threshold) & ~strong
    for _ in range(hysteresis_iters):
        grown = F.max_pool2d(strong.permute(0, 3, 1, 2).float(), 3, 1,
                             1).permute(0, 2, 3, 1) > 0
        strong = strong | (grown & weak)
    return thin_mag, strong.to(x.dtype)
