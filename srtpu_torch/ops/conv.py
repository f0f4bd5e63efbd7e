"""K2: 3x3 SAME conv + bias (+ ReLU), NHWC bf16 -> bf16, f32 sums.

Replaces ``srtpu/ops/cs_conv.py:conv3x3_cs_fwd``; the kernel is
``csrc/conv.cu``, whose head note says what bounds it on the H100 and
how its design answers that. :func:`conv3x3_fwd` launches the kernel for
CUDA tensors and takes the plain version only for CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build


def conv_f32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
             ) -> torch.Tensor:
    """kxk SAME conv of NHWC ``x`` with HWIO ``w`` plus ``b``, in f32 with
    no rounding (the kernels' accumulator, before the bf16 store)."""
    y = F.conv2d(x.permute(0, 3, 1, 2).float(),
                 w.permute(3, 2, 0, 1).float(), padding=w.shape[0] // 2)
    return y.permute(0, 2, 3, 1) + b.float()


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  relu: bool = False) -> torch.Tensor:
    """Plain version of the kernel: f32 conv + bias (+ ReLU), one rounding
    to ``x.dtype``."""
    y = conv_f32(x, w, b)
    if relu:
        y = y.clamp_min(0.0)
    return y.to(x.dtype).contiguous()


def conv3x3_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                relu: bool = False) -> torch.Tensor:
    """x (B, H, W, Cin) bf16; w (3, 3, Cin, Cout) bf16; b (Cout,) f32 ->
    (B, H, W, Cout) bf16. On CUDA: Cin = 64 with Cout % 64 == 0, or
    Cin = 256 with Cout % 16 == 0 (the EDSR tail's shapes)."""
    if x.device.type == 'cpu':
        return conv3x3_plain(x, w, b, relu)
    if x.device.type != 'cuda':
        raise ValueError(f'conv3x3_fwd: no kernel for device {x.device}')
    bsz, h, wd, cin = x.shape
    cout = w.shape[-1]
    if not ((cin == 64 and cout % 64 == 0)
            or (cin == 256 and cout % 16 == 0)):
        raise ValueError(f'conv3x3_fwd: no kernel for {cin} -> {cout} '
                         f'channels')
    dev = x.device
    _build.expect(x, 'x', torch.bfloat16, (bsz, h, wd, cin), dev)
    _build.expect(w, 'w', torch.bfloat16, (3, 3, cin, cout), dev)
    _build.expect(b, 'b', torch.float32, (cout,), dev)
    out = torch.empty((bsz, h, wd, cout), dtype=torch.bfloat16, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.srt_conv3x3_fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                  out.data_ptr(), bsz, h, wd, cin, cout,
                                  int(relu), _build.stream(dev))
    _build.check(err, 'srt_conv3x3_fwd')
    conv3x3_fwd.launches += 1
    return out


conv3x3_fwd.launches = 0
