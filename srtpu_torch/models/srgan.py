"""SRGAN: a reflection-padded SRResNet generator with a tanh output, and a
strided conv discriminator (srtpu/models/srgan.py). The flagship
configuration is SRGAN x4: ngf = ndf = 64, 16 blocks, bf16 compute on f32
parameters, trained adversarially (:mod:`srtpu_torch.train.gan`).

The generator's trunk (16 BN blocks, the closing conv + BN, the skip)
follows srtpu's ``use_pallas`` in train mode: ``'cs'`` runs K4r (K4 with
REFLECT boundaries, :class:`~srtpu_torch.models.common.BNTrunk` with
``reflect=True``), as srtpu's Pallas trunk; srtpu's default, ``False``
(and ``True``, which srtpu's generator treats alike), runs srtpu's XLA
blocks in stock ops (:func:`~.common.xla_trunk`: reflect-padded convs,
flax's batch norm, PReLU, with srtpu's roundings). In eval mode both run
reflect-padded stock convs on the running statistics, as srtpu runs eval
on XLA. Both of srtpu's trees load into the one stacked trunk. The 9x9
head and output convs, the upscaler and the discriminator are stock
PyTorch (cuDNN on the card), as srtpu leaves them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import (BNTrunk, Conv2d, PReLU, UpscaleBlock, batch_norm,
                     route_of, xla_trunk)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """flax ``nn.leaky_relu`` in x's dtype: the slope is rounded to x's
    dtype before the product, as JAX's weak-typed scalar is. The rounded
    slope is a host scalar (a device one would cost a copy and a stream
    synchronisation per call). PyTorch multiplies in f32, where a bf16
    x times a bf16 slope is exact, and rounds once: JAX's bf16 product."""
    return F.leaky_relu(x, float(torch.tensor(slope, dtype=x.dtype)))


class BatchNorm(nn.Module):
    """flax 0.12 ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` on NHWC, not
    ``nn.BatchNorm2d`` (:func:`batch_norm`). Eval mode reads the running
    statistics (buffers ``mean``, ``var``)."""

    def __init__(self, n: int, *, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(n, device=device))
        self.bias = nn.Parameter(torch.zeros(n, device=device))
        self.register_buffer('mean', torch.zeros(n, device=device))
        self.register_buffer('var', torch.ones(n, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm(x, self.scale, self.bias, self.mean, self.var,
                          self.training)


class SRGANGenerator(nn.Module):
    """srtpu ``SRGANGenerator``: reflect pad 4 + 9x9 head conv 3 -> ngf,
    PReLU; the reflect BN trunk (n_blocks blocks, the closing conv + BN,
    the global skip); the PReLU sub-pixel upscaler; reflect pad 4 + 9x9
    output conv ngf -> channels; (tanh + 1) / 2. NHWC in, NHWC out in
    ``dtype`` (the input's when None). ``use_pallas``: srtpu's; in train
    mode 'cs' runs K4r, any other value :func:`xla_trunk`."""

    def __init__(self, scale_factor: int = 4, channels: int = 3,
                 ngf: int = 64, n_blocks: int = 16,
                 dtype: torch.dtype | None = None, *, device=None,
                 generator: torch.Generator, use_pallas=False):
        super().__init__()
        self.dtype, self.use_pallas = dtype, use_pallas
        kw = dict(device=device, generator=generator)
        self.head = Conv2d(channels, ngf, 9, padding='reflect', **kw)
        self.head_act = PReLU(device=device)
        self.trunk = BNTrunk(ngf, n_blocks, reflect=True, **kw)
        self.upscale = UpscaleBlock(scale_factor, ngf, act='prelu', **kw)
        self.out = Conv2d(ngf, channels, 9, padding='reflect', **kw)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        dtype = self.dtype or x.dtype
        x = self.head_act(self.head(x, dtype))
        if self.training and self.use_pallas != 'cs':
            x = xla_trunk(self.trunk, x, dtype)
        else:
            x = self.trunk(x, dtype, plain)
        x = self.out(self.upscale(x, dtype), dtype)
        return (torch.tanh(x) + 1.0) / 2.0


class SRGANDiscriminator(nn.Module):
    """srtpu ``SRGANDiscriminator``: a 3x3 conv 3 -> ndf and leaky_relu(0.2),
    then seven blocks of 3x3 conv -> leaky_relu(0.2) -> :class:`BatchNorm`
    (widths ndf, 2 ndf, 2 ndf, 4 ndf, 4 ndf, 8 ndf, 8 ndf; strides 2, 1,
    2, 1, 2, 1, 2), a global mean, a 1x1 conv 8 ndf -> 1024, leaky_relu,
    a 1x1 conv -> 1 and a sigmoid: (B, 1, 1, 1) in ``dtype``."""

    PLAN = ((1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (8, 1), (8, 2))

    def __init__(self, ndf: int = 64, channels: int = 3,
                 dtype: torch.dtype | None = None, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        kw = dict(device=device, generator=generator)
        convs, cin = [Conv2d(channels, ndf, 3, **kw)], ndf
        for mult, stride in self.PLAN:
            convs.append(Conv2d(cin, ndf * mult, 3, stride=stride, **kw))
            cin = ndf * mult
        convs += [Conv2d(cin, 1024, 1, **kw), Conv2d(1024, 1, 1, **kw)]
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(BatchNorm(ndf * mult, device=device)
                                 for mult, _ in self.PLAN)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or x.dtype
        x = leaky_relu(self.convs[0](x, dtype))
        for conv, bn in zip(self.convs[1:-2], self.bns):
            x = bn(leaky_relu(conv(x, dtype)))
        x = x.float().mean((1, 2), keepdim=True).to(x.dtype)
        x = leaky_relu(self.convs[-2](x, dtype))
        return torch.sigmoid(self.convs[-1](x, dtype))


class SRGAN(nn.Module):
    """srtpu ``SRGAN``: holds ``generator`` (:class:`SRGANGenerator`) and
    ``discriminator`` (:class:`SRGANDiscriminator`); its forward is the
    generator's, so predict treats it as any SR model, and
    ``Trainer.fit`` trains it adversarially. The constructor's
    ``generator`` is the CPU ``torch.Generator`` that draws the weights
    (the generator's first, then the discriminator's). ``use_pallas``
    (srtpu's False, True or 'cs') picks the generator's trunk in train
    mode (see the module note)."""

    # eval-mode batch norm is per pixel (running statistics)
    GLOBAL_POOLING = False
    # the upscaler is stock, so every scale runs on the card
    CARD_SCALES = (2, 3, 4, 8)

    def __init__(self, scale_factor: int = 4, channels: int = 3,
                 ngf: int = 64, ndf: int = 64, n_blocks: int = 16,
                 use_pallas=False, dtype: torch.dtype | None = None, *,
                 device=None, generator: torch.Generator):
        super().__init__()
        self.scale_factor = scale_factor
        self.channels = channels
        self.use_pallas = use_pallas
        self.dtype = dtype
        kw = dict(device=device, generator=generator)
        self.generator = SRGANGenerator(scale_factor, channels, ngf,
                                        n_blocks, dtype, use_pallas=use_pallas,
                                        **kw)
        self.discriminator = SRGANDiscriminator(ndf, channels, dtype, **kw)

    @classmethod
    def reaches_kernel(cls, scale: int, kw: dict) -> bool:
        """Whether the route ``kw`` picks runs a kernel of the port: 'cs'
        alone (K4r in train mode)."""
        return route_of(cls, kw) == 'cs'

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        return self.generator(x, plain)
