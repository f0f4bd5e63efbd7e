"""The port's kernels, each beside its plain PyTorch version: K1
``trunk_fwd`` / ``trunk_bwd``, K2 ``conv3x3_fwd`` / ``conv3x3_bwd``, K3
``upsample_fwd`` / ``upsample_bwd``, K5 ``rcab_fwd`` / ``rcab_bwd`` and
the shared weight-grad kernel ``conv_wgrad``; ``trunk``, ``conv3x3``,
``upsample`` and ``resgroup`` are the differentiable ops. Kernels build
on first use (``_build``)."""

from .conv import (Conv3x3Fn, conv3x3, conv3x3_bwd, conv3x3_bwd_plain,
                   conv3x3_fwd, conv3x3_plain)
from .rcab import (ResGroupFn, rcab_bwd, rcab_bwd_plain, rcab_fwd,
                   rcab_fwd_plain, resgroup, resgroup_bwd, resgroup_bwd_plain,
                   resgroup_fwd, resgroup_plain)
from .trunk import (TrunkFn, trunk, trunk_bwd, trunk_bwd_plain, trunk_fwd,
                    trunk_plain)
from .upsample import (UpsampleFn, upsample, upsample_bwd, upsample_bwd_plain,
                       upsample_fwd, upsample_plain)
from .wgrad import conv_wgrad, conv_wgrad_plain

__all__ = ['Conv3x3Fn', 'ResGroupFn', 'TrunkFn', 'UpsampleFn', 'conv3x3',
           'conv3x3_bwd', 'conv3x3_bwd_plain', 'conv3x3_fwd', 'conv3x3_plain',
           'conv_wgrad', 'conv_wgrad_plain', 'rcab_bwd', 'rcab_bwd_plain',
           'rcab_fwd', 'rcab_fwd_plain', 'resgroup', 'resgroup_bwd',
           'resgroup_bwd_plain', 'resgroup_fwd', 'resgroup_plain', 'trunk',
           'trunk_bwd', 'trunk_bwd_plain', 'trunk_fwd', 'trunk_plain',
           'upsample', 'upsample_bwd', 'upsample_bwd_plain', 'upsample_fwd',
           'upsample_plain']
