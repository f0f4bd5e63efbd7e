"""The port's kernels on the EDSR predict path, each beside its plain
PyTorch version: K1 ``trunk_fwd``, K2 ``conv3x3_fwd``, K3
``upsample_fwd``. Kernels build on first use (``_build``)."""

from .conv import conv3x3_fwd, conv3x3_plain
from .trunk import trunk_fwd, trunk_plain
from .upsample import upsample_fwd, upsample_plain

__all__ = ['conv3x3_fwd', 'conv3x3_plain', 'trunk_fwd',
           'trunk_plain', 'upsample_fwd', 'upsample_plain']
