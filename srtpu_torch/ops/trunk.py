"""K1 forward: the EDSR resblock chain, one fused-block kernel per block.

Replaces ``srtpu/ops/cs_conv.py:trunk_fwd_mega``; the kernel is
``csrc/trunk.cu``, whose head note says what bounds it on the H100, how
its design answers that, and why the loop over blocks runs here on the
host. :func:`trunk_fwd` launches the kernel for CUDA tensors and takes
the plain version only for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _build
from .conv import conv3x3_plain, conv_f32


def trunk_plain(x: torch.Tensor, w1s: torch.Tensor, b1s: torch.Tensor,
                w2s: torch.Tensor, b2s: torch.Tensor,
                res_scale: float) -> torch.Tensor:
    """Plain version, rounding where the kernel does: h1 to x.dtype after
    bias + ReLU, the block output to x.dtype after ``h2 * res_scale + x``
    in f32."""
    for w1, b1, w2, b2 in zip(w1s, b1s, w2s, b2s):
        h1 = conv3x3_plain(x, w1, b1, relu=True)
        x = (conv_f32(h1, w2, b2) * res_scale + x.float()).to(x.dtype)
    return x.contiguous()


def trunk_fwd(x: torch.Tensor, w1s: torch.Tensor, b1s: torch.Tensor,
              w2s: torch.Tensor, b2s: torch.Tensor,
              res_scale: float) -> torch.Tensor:
    """x (B, H, W, C) bf16; w1s, w2s (L, 3, 3, C, C) bf16 HWIO stacks;
    b1s, b2s (L, C) f32 -> (B, H, W, C) bf16 after L resblocks. On CUDA:
    C = 64; one launch per block."""
    if x.device.type == 'cpu':
        return trunk_plain(x, w1s, b1s, w2s, b2s, res_scale)
    if x.device.type != 'cuda':
        raise ValueError(f'trunk_fwd: no kernel for device {x.device}')
    bsz, h, wd, c = x.shape
    if c != 64:
        raise ValueError(f'trunk_fwd: no kernel for C={c}')
    n_blocks = w1s.shape[0]
    dev = x.device
    _build.expect(x, 'x', torch.bfloat16, (bsz, h, wd, c), dev)
    for name, t in (('w1s', w1s), ('w2s', w2s)):
        _build.expect(t, name, torch.bfloat16, (n_blocks, 3, 3, c, c), dev)
    for name, t in (('b1s', b1s), ('b2s', b2s)):
        _build.expect(t, name, torch.float32, (n_blocks, c), dev)
    lib = _build.library()
    bufs = [torch.empty_like(x) for _ in range(min(n_blocks, 2))]
    src = x
    with torch.cuda.device(dev):
        s = _build.stream(dev)
        for i in range(n_blocks):
            dst = bufs[i % 2]   # ping-pong: a block never reads its output
            err = lib.srt_resblock_fwd(
                src.data_ptr(), w1s[i].data_ptr(), b1s[i].data_ptr(),
                w2s[i].data_ptr(), b2s[i].data_ptr(), float(res_scale),
                dst.data_ptr(), bsz, h, wd, c, s)
            _build.check(err, 'srt_resblock_fwd')
            trunk_fwd.launches += 1
            src = dst
    return src


trunk_fwd.launches = 0
