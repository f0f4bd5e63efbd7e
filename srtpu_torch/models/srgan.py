"""SRGAN: a reflection-padded SRResNet generator with a tanh output, and a
strided conv discriminator (srtpu/models/srgan.py). The flagship
configuration is SRGAN x4: ngf = ndf = 64, 16 blocks, bf16 compute on f32
parameters, trained adversarially (:mod:`srtpu_torch.train.gan`).

One route on the card, whatever ``use_pallas`` says: in train mode the
generator's 16 BN blocks and closing conv + BN run K4r (K4 with REFLECT
boundaries, :class:`~srtpu_torch.models.common.BNTrunk` with
``reflect=True``); in eval mode they run reflect-padded stock convs on
the running statistics, as srtpu runs eval on XLA. srtpu's default,
``use_pallas=False``, runs its trunk on XLA; ``'cs'`` reaches its Pallas
K4r. ``use_pallas`` stays a key the CLI and the converter accept: both of
srtpu's trees load into the one stacked trunk. The 9x9 head and output
convs, the upscaler and the discriminator are stock PyTorch (cuDNN on
the card), as srtpu leaves them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import BNTrunk, Conv2d, PReLU, UpscaleBlock


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """flax ``nn.leaky_relu`` in x's dtype: the slope is rounded to x's
    dtype before the product, as JAX's weak-typed scalar is. The rounded
    slope is a host scalar (a device one would cost a copy and a stream
    synchronisation per call). PyTorch multiplies in f32, where a bf16
    x times a bf16 slope is exact, and rounds once: JAX's bf16 product."""
    return F.leaky_relu(x, float(torch.tensor(slope, dtype=x.dtype)))


class BatchNorm(nn.Module):
    """flax 0.12 ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` on NHWC, not
    ``nn.BatchNorm2d``: in train mode the mean and E[x^2] - mean^2
    (clamped at 0) of the batch in f32, and the running statistics move
    ra <- 0.9 ra + 0.1 batch with that biased variance; y = (x - mean) *
    (scale * rsqrt(var + 1e-5)) + bias in f32, rounded to x's dtype once.
    Eval mode reads the running statistics (buffers ``mean``, ``var``)."""

    MOMENTUM, EPS = 0.9, 1e-5

    def __init__(self, n: int, *, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(n, device=device))
        self.bias = nn.Parameter(torch.zeros(n, device=device))
        self.register_buffer('mean', torch.zeros(n, device=device))
        self.register_buffer('var', torch.ones(n, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean = xf.mean(dims)
            var = ((xf * xf).mean(dims) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.MOMENTUM
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        y = (xf - mean) * (self.scale * torch.rsqrt(var + self.EPS))
        return (y + self.bias).to(x.dtype)


class SRGANGenerator(nn.Module):
    """srtpu ``SRGANGenerator``: reflect pad 4 + 9x9 head conv 3 -> ngf,
    PReLU; the reflect BN trunk (n_blocks blocks, the closing conv + BN,
    the global skip); the PReLU sub-pixel upscaler; reflect pad 4 + 9x9
    output conv ngf -> channels; (tanh + 1) / 2. NHWC in, NHWC out in
    ``dtype`` (the input's when None)."""

    def __init__(self, scale_factor: int = 4, channels: int = 3,
                 ngf: int = 64, n_blocks: int = 16,
                 dtype: torch.dtype | None = None, *, device=None,
                 generator: torch.Generator):
        super().__init__()
        self.dtype = dtype
        kw = dict(device=device, generator=generator)
        self.head = Conv2d(channels, ngf, 9, padding='reflect', **kw)
        self.head_act = PReLU(device=device)
        self.trunk = BNTrunk(ngf, n_blocks, reflect=True, **kw)
        self.upscale = UpscaleBlock(scale_factor, ngf, act='prelu', **kw)
        self.out = Conv2d(ngf, channels, 9, padding='reflect', **kw)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        dtype = self.dtype or x.dtype
        x = self.head_act(self.head(x, dtype))
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
    (srtpu's False, True or 'cs') selects nothing here (see the module
    note)."""

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
                                        n_blocks, dtype, **kw)
        self.discriminator = SRGANDiscriminator(ndf, channels, dtype, **kw)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        return self.generator(x, plain)
