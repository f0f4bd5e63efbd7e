"""The port's kernels, each beside its plain PyTorch version: K1
``trunk_fwd`` / ``trunk_bwd``, K2 ``conv3x3_fwd`` / ``conv3x3_bwd`` (3x3
and 5x5, counted apart), K3 ``upsample_fwd`` / ``upsample_bwd``, K4 ``f1_conv_stats`` ... ``b3_call`` (SRResNet's BN
block), K5 ``rcab_fwd`` / ``rcab_bwd``, K6 ``rdn_fwd`` / ``rdb_bwd_chain`` /
``rdb_bwd_dw`` (RDN's dense blocks), K7 ``wdsr_fwd`` / ``wdsr_bwd``
(WDSR-B's block, in :mod:`.wdsr`) and the shared weight-grad kernel
``conv_wgrad``; ``trunk``, ``conv3x3``, ``upsample``, ``bn_resblock``,
``bn_close``, ``resgroup``, ``rdn_trunk`` and ``wdsr.wdsr_block`` are the
differentiable ops. Kernels build on first use (``_build``)."""

from .bn_block import (BNCloseFn, BNResBlockFn, b1_plain, b1_sums, b2_call,
                       b2_plain, b3_call, b3_plain, bn_close, bn_close_ref,
                       bn_resblock, bn_resblock_ref, f1_conv_stats, f1_plain,
                       f2_norm_act_conv_stats, f2_plain, f3_norm_skip,
                       f3_plain)
from .conv import (Conv3x3Fn, conv3x3, conv3x3_bwd, conv3x3_bwd_plain,
                   conv3x3_fwd, conv3x3_plain)
from .rcab import (ResGroupFn, rcab_bwd, rcab_bwd_plain, rcab_fwd,
                   rcab_fwd_plain, resgroup, resgroup_bwd, resgroup_bwd_plain,
                   resgroup_fwd, resgroup_plain)
from .rdn import (RDNTrunkFn, rdb_bwd_chain, rdb_bwd_chain_plain, rdb_bwd_dw,
                  rdb_bwd_dw_plain, rdn_fwd, rdn_fwd_plain, rdn_trunk)
from .trunk import (TrunkFn, trunk, trunk_bwd, trunk_bwd_plain, trunk_fwd,
                    trunk_plain)
from .upsample import (UpsampleFn, upsample, upsample_bwd, upsample_bwd_plain,
                       upsample_fwd, upsample_plain)
from .wgrad import conv_wgrad, conv_wgrad_plain

__all__ = ['BNCloseFn', 'BNResBlockFn', 'Conv3x3Fn', 'RDNTrunkFn',
           'ResGroupFn', 'TrunkFn',
           'UpsampleFn', 'b1_plain', 'b1_sums', 'b2_call', 'b2_plain',
           'b3_call', 'b3_plain', 'bn_close', 'bn_close_ref', 'bn_resblock',
           'bn_resblock_ref', 'conv3x3', 'conv3x3_bwd', 'conv3x3_bwd_plain',
           'conv3x3_fwd', 'conv3x3_plain', 'conv_wgrad', 'conv_wgrad_plain',
           'f1_conv_stats', 'f1_plain', 'f2_norm_act_conv_stats', 'f2_plain',
           'f3_norm_skip', 'f3_plain', 'rcab_bwd', 'rcab_bwd_plain',
           'rcab_fwd', 'rcab_fwd_plain', 'rdb_bwd_chain',
           'rdb_bwd_chain_plain', 'rdb_bwd_dw', 'rdb_bwd_dw_plain', 'rdn_fwd',
           'rdn_fwd_plain',
           'rdn_trunk', 'resgroup', 'resgroup_bwd',
           'resgroup_bwd_plain', 'resgroup_fwd', 'resgroup_plain', 'trunk',
           'trunk_bwd', 'trunk_bwd_plain', 'trunk_fwd', 'trunk_plain',
           'upsample', 'upsample_bwd', 'upsample_bwd_plain', 'upsample_fwd',
           'upsample_plain']
