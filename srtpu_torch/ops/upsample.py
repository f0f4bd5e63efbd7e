"""K3: one sub-pixel upscale stage, 3x3 conv C -> r*r*C + bias with the
pixel shuffle folded into the store.

Replaces ``srtpu/ops/cs_conv.py:upsample_cs_fwd``; the kernel is
``csrc/upsample.cu``, whose head note says what bounds it on the H100
and how its design answers that. :func:`upsample_fwd` launches the
kernel for CUDA tensors and takes the plain version only for CPU
tensors.
"""

from __future__ import annotations

import torch

from . import _build
from .conv import conv3x3_plain
from .layout import b_pm, pixel_shuffle, w_pm_hwio


def upsample_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   r: int) -> torch.Tensor:
    """Plain version: bf16(conv + bias) in PixelShuffle channel order,
    then the shuffle (exact: a permutation)."""
    return pixel_shuffle(conv3x3_plain(x, w, b), r).contiguous()


def upsample_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 r: int) -> torch.Tensor:
    """x (B, H, W, C) bf16; w HWIO (3, 3, C, r*r*C) bf16 and b (r*r*C,) f32,
    both in PixelShuffle channel order -> (B, r*H, r*W, C) bf16. On CUDA:
    C = 64."""
    if x.device.type == 'cpu':
        return upsample_plain(x, w, b, r)
    if x.device.type != 'cuda':
        raise ValueError(f'upsample_fwd: no kernel for device {x.device}')
    bsz, h, wd, c = x.shape
    if c != 64 or r < 2:
        raise ValueError(f'upsample_fwd: no kernel for C={c}, r={r}')
    dev = x.device
    _build.expect(x, 'x', torch.bfloat16, (bsz, h, wd, c), dev)
    _build.expect(w, 'w', torch.bfloat16, (3, 3, c, r * r * c), dev)
    _build.expect(b, 'b', torch.float32, (r * r * c,), dev)
    w_pm = w_pm_hwio(w, r).contiguous()
    bias = b_pm(b, r).contiguous()
    out = torch.empty((bsz, r * h, r * wd, c), dtype=torch.bfloat16,
                      device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.srt_upsample_fwd(x.data_ptr(), w_pm.data_ptr(),
                                   bias.data_ptr(), out.data_ptr(), bsz, h,
                                   wd, c, r, _build.stream(dev))
    _build.check(err, 'srt_upsample_fwd')
    upsample_fwd.launches += 1
    return out


upsample_fwd.launches = 0
