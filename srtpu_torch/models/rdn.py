"""RDN: residual dense network (srtpu/models/rdn.py).

SFE1 (a 3x3 conv 3 -> G0, cuDNN here as XLA in srtpu), SFE2, D residual
dense blocks (C dense 3x3 layers growing a concat, a 1x1 local fusion
and a skip per block, the D outputs concatenated), GFF1 (a 1x1 conv D G0
-> G0), GFF2 plus SFE1's output, then srtpu's XLA tail: the sub-pixel
stages at G * r^2 channels (``UpscaleBlock(scale, G)`` on the G0
channels) and a final 3x3 conv (cuDNN here). No mean shift. The
flagship is RDN-B x4: D = 16 blocks of C = 8 layers at G = G0 = 64, bf16
compute on f32 parameters.

srtpu runs two paths (rdn.py:77-88, :127-152). Its kernel route,
``use_pallas='cs'`` where ``cs_ok`` holds (:func:`cs_ok`), runs here as
SFE2 and GFF2 on K2, the trunk on K6 (``ops.rdn_trunk``) and GFF1 as one
matmul. srtpu picks that trunk with a module global
(``cs_conv._RDN_FWD``: 'grid', its default, or 'calls', the per-block
``rdn_trunk_cs2``); both take the same parameters and compute the same
forward, and K6 already runs each block's backward as its own calls, so
the port keeps no such switch (ROADMAP.md F3). Its per-block op
``ops.rdn.rdn_trunk_calls`` ports 'calls' with that form's one extra
rounding of each block's cotangent. srtpu also falls back to XLA convs
whenever the TPU's VMEM plan fails (``cs_plan_s(..., 1024, 1088)``:
every predict size above about 32x32 LR). That limit is VMEM, not math:
the same stored parameters give the same function, and on the card K6
runs at every size.

Every other case takes srtpu's per-block XLA path (``_RDB``,
rdn.py:28-45), in stock ops with srtpu's roundings
(:meth:`RDN.forward_blocks`): ``use_pallas`` False or True, and the
configs ``cs_ok`` refuses on 'cs' (config A, whose G = 32 differs from
G0; a G0 that is not a 16-multiple, or past 64 not a 64-multiple). Both
paths keep one state dict, which srtpu's two trees load into.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops import conv3x3, rdn_trunk
from .common import Conv2d, UpscaleBlock, _conv, route_of, uniform_param

RDN_CONFIGS = {
    'A': (20, 6, 32),
    'B': (16, 8, 64),
}


def cs_ok(n_layers: int, growth: int, growth0: int) -> bool:
    """srtpu's gate of the CS trunk (rdn.py:71-74): uniform growth, a
    16-multiple width, and every dense input width up to 64 or a
    64-multiple."""
    return (growth == growth0 and growth0 % 16 == 0
            and all(growth0 * (i + 1) <= 64 or growth0 * (i + 1) % 64 == 0
                    for i in range(n_layers + 1)))


def runs_per_block(use_pallas, rdn_config: str, growth0: int) -> bool:
    """Whether srtpu's per-block path runs (rdn.py:77-88): every route off
    'cs', and 'cs' at a config :func:`cs_ok` turns away."""
    _, c, g = RDN_CONFIGS[rdn_config]
    return use_pallas != 'cs' or not cs_ok(c, g, growth0)


class RDN(nn.Module):
    """NHWC f32 images in [0, 1] -> NHWC SR images in ``dtype`` (the input's
    dtype when None). Parameters (srtpu's init bounds, rdn.py:115-132):
    sfe1 (Conv2d), sfe2_weight (3, 3, G0, G0) and sfe2_bias;
    dense{i}_weight (D, 3, 3, G0 + i G, G) and dense{i}_bias (D, G);
    lff_weight (D, c_tot, G0) and lff_bias (D, G0), c_tot = G0 + C G;
    gff1_weight (D G0, G0) and gff1_bias; gff2_weight (3, 3, G0, G0) and
    gff2_bias; upscale (UpscaleBlock) and final (Conv2d). ``device``
    places them; ``generator`` (a CPU ``torch.Generator``) draws them.
    ``use_pallas``: srtpu's; ``per_block`` says which path runs (see the
    module note)."""

    # Scales the card runs: the tail is cuDNN, so every RDN scale.
    CARD_SCALES = (2, 3, 4)

    def __init__(self, scale_factor: int = 4, channels: int = 3,
                 rdn_config: str = 'B', growth0: int = 64,
                 use_pallas: bool | str = 'cs',
                 dtype: torch.dtype | None = None, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        if use_pallas not in (False, True, 'cs'):
            raise ValueError(f"use_pallas must be False, True or 'cs', got "
                             f'{use_pallas!r}')
        if scale_factor not in self.CARD_SCALES:
            raise ValueError('RDN scale must be 2, 3 or 4.')
        d, c, g = RDN_CONFIGS[rdn_config]
        self.per_block = runs_per_block(use_pallas, rdn_config, growth0)
        self.scale_factor = scale_factor
        self.use_pallas = use_pallas
        self.channels = channels
        self.dtype = dtype
        self.n_blocks, self.n_layers = d, c
        g0 = growth0
        c_tot = g0 + c * g

        def u(name, shape, bound):
            self.register_parameter(name, uniform_param(shape, bound, device,
                                                        generator))

        self.sfe1 = Conv2d(channels, g0, 3, device=device,
                           generator=generator)
        u('sfe2_weight', (3, 3, g0, g0), 1 / math.sqrt(9 * g0))
        u('sfe2_bias', (g0,), 1 / math.sqrt(9 * g0))
        for i in range(c):
            cin = g0 + i * g
            u(f'dense{i}_weight', (d, 3, 3, cin, g), 1 / math.sqrt(9 * cin))
            u(f'dense{i}_bias', (d, g), 1 / math.sqrt(9 * cin))
        u('lff_weight', (d, c_tot, g0), 1 / math.sqrt(c_tot))
        u('lff_bias', (d, g0), 1 / math.sqrt(c_tot))
        u('gff1_weight', (d * g0, g0), 1 / math.sqrt(d * g0))
        u('gff1_bias', (g0,), 1 / math.sqrt(d * g0))
        u('gff2_weight', (3, 3, g0, g0), 1 / math.sqrt(9 * g0))
        u('gff2_bias', (g0,), 1 / math.sqrt(9 * g0))
        self.upscale = UpscaleBlock(scale_factor, g, in_feats=g0,
                                    device=device, generator=generator)
        self.final = Conv2d(g, channels, 3, device=device,
                            generator=generator)

    @classmethod
    def reaches_kernel(cls, scale: int, kw: dict) -> bool:
        """Whether the path ``kw`` picks runs a kernel of the port: the
        CS trunk, unless :func:`runs_per_block`."""
        return not runs_per_block(*(route_of(cls, kw, name) for name in (
            'use_pallas', 'rdn_config', 'growth0')))

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """``plain=True`` runs every kernel's plain PyTorch version instead
        (the reference the kernels are held against on the card); the
        per-block path has none and ignores it."""
        dtype = self.dtype or x.dtype
        if self.per_block:
            return self.forward_blocks(x, dtype)
        # cuDNN may hand SFE1's output back in NCHW memory (a permuted
        # view); the kernels read dense NHWC
        f1 = self.sfe1(x, dtype).contiguous()
        y = conv3x3(f1, self.sfe2_weight, self.sfe2_bias, plain)
        ws = [getattr(self, f'dense{i}_weight') for i in range(self.n_layers)]
        bs = [getattr(self, f'dense{i}_bias') for i in range(self.n_layers)]
        cat = rdn_trunk(y, ws, bs, self.lff_weight, self.lff_bias, plain)
        # GFF1 in the compute dtype, then its bias (srtpu's einsum + add)
        y = torch.matmul(cat, self.gff1_weight.to(dtype)) \
            + self.gff1_bias.to(dtype)
        y = conv3x3(y.contiguous(), self.gff2_weight, self.gff2_bias,
                    plain) + f1
        return self.final(self.upscale(y, dtype), dtype)

    def forward_blocks(self, x: torch.Tensor, dtype) -> torch.Tensor:
        """srtpu's per-block path (rdn.py:77-88 and ``_RDB``): every conv
        srtpu's ``Conv2d`` (the conv rounds to ``dtype``, then its bias
        in ``dtype``), the 1x1 fusions and GFF1 as 1x1 convs; each dense
        layer's ReLU output joins the block's concat, each block adds its
        input. Stock ops, no kernel of the port."""
        f1 = self.sfe1(x, dtype)
        y = _conv(f1, self.sfe2_weight, self.sfe2_bias, dtype)
        layers = [(getattr(self, f'dense{i}_weight'),
                   getattr(self, f'dense{i}_bias'))
                  for i in range(self.n_layers)]
        outs = []
        for blk in range(self.n_blocks):
            feats = y
            for w, b in layers:
                out = torch.relu(_conv(feats, w[blk], b[blk], dtype))
                feats = torch.cat([feats, out], -1)
            y = _conv(feats, self.lff_weight[blk][None, None],
                      self.lff_bias[blk], dtype) + y
            outs.append(y)
        y = _conv(torch.cat(outs, -1), self.gff1_weight[None, None],
                  self.gff1_bias, dtype)
        y = _conv(y, self.gff2_weight, self.gff2_bias, dtype) + f1
        return self.final(self.upscale(y, dtype), dtype)
