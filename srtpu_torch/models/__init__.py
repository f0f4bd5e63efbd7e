"""Model registry of the port (srtpu/models/__init__.py): every srtpu
family, EDSR, RCAN, SRResNet, RDN, DDBPN, WDSR, SRGAN and SRCNN."""

from __future__ import annotations

import inspect

from torch import nn

from .common import (BNTrunk, Conv2d, PReLU, Trunk, UpscaleBlock,
                     UpscaleTail, mean_shift, pixel_shuffle)
from .ddbpn import DDBPN
from .edsr import EDSR
from .rcan import RCAN
from .rdn import RDN
from .srcnn import SRCNN
from .srgan import SRGAN, SRGANDiscriminator, SRGANGenerator
from .srresnet import SRResNet
from .wdsr import WDSR

MODEL_REGISTRY: dict[str, type[nn.Module]] = {'DDBPN': DDBPN, 'EDSR': EDSR,
                                              'RCAN': RCAN, 'RDN': RDN,
                                              'SRCNN': SRCNN,
                                              'SRGAN': SRGAN,
                                              'SRResNet': SRResNet,
                                              'WDSR': WDSR}


def model_class(name: str) -> type[nn.Module]:
    """The registered class of ``name`` (any case)."""
    key = {k.lower(): k for k in MODEL_REGISTRY}.get(name.lower())
    if key is None:
        raise ValueError(f'Unknown model {name!r}. Available: '
                         f'{", ".join(sorted(MODEL_REGISTRY))}')
    return MODEL_REGISTRY[key]


def create_model(name: str, **kwargs) -> nn.Module:
    """Instantiate a registered model, dropping kwargs it doesn't declare
    (as srtpu's create_model does, so one config can drive any model)."""
    cls = model_class(name)
    accepted = inspect.signature(cls).parameters
    return cls(**{k: v for k, v in kwargs.items() if k in accepted})


__all__ = ['BNTrunk', 'DDBPN', 'EDSR', 'MODEL_REGISTRY',
           'PReLU', 'RCAN', 'RDN', 'SRCNN', 'SRGAN', 'SRGANDiscriminator',
           'SRGANGenerator', 'SRResNet', 'Conv2d', 'Trunk',
           'UpscaleBlock', 'UpscaleTail', 'WDSR', 'create_model',
           'mean_shift', 'model_class', 'pixel_shuffle']
