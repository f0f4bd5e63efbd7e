"""The port's kernels, each beside its plain PyTorch version: K1
``trunk_fwd`` / ``trunk_bwd`` (EDSR's trunk: one host call each way,
its convs on K2's engine, the counterpart of srtpu's mega trunk and of its per-block ``trunk_cs`` and
``resblock_cs`` alike), K2 ``conv3x3_fwd`` / ``conv3x3_bwd`` (3x3 and
5x5, counted apart), K3 ``upsample_fwd`` / ``upsample_bwd``, K4
``f1_conv_stats`` ... ``b3_call`` (SRResNet's BN block), K5 ``rcab_fwd``
/ ``rcab_bwd`` (one RCAB; ``rcab.group_fwd`` / ``group_chain`` a
residual group's RCABs in one call), K6 ``rdn_fwd`` / ``rdb_bwd_chain`` / ``rdb_bwd_dw``
(RDN's dense blocks, all D or one per call), K7 ``wdsr_fwd`` /
``wdsr_bwd`` (WDSR-B's block, in :mod:`.wdsr`; ``wdsr_trunk_fwd`` /
``wdsr_trunk_bwd`` its trunk in one host call each way), K8 (srtpu's
``use_pallas=True`` forms): K8a ``resblock_trunk_fwd`` (EDSR's blocks,
one host call; ``resblock_fused_fwd`` one block) with K9d ``resblock_bwd_fused`` (its fused backward), K8b
``ca_layer_fwd`` (RCAN's attention gate), K8c ``wdsr_block_fused_fwd``
(WDSR-B's block, in :mod:`.wdsr_block`), and the shared weight-grad
kernel ``conv_wgrad``. The differentiable ops: ``trunk``,
``resblock_cs`` (``trunk`` at L = 1 on HWIO weights), ``conv3x3``,
``upsample``, ``bn_resblock``, ``bn_close``, ``resgroup``, ``rdn_trunk``
and, in :mod:`.rdn`, ``rdn_trunk_calls`` (srtpu's per-block 'calls'
trunk on K6) and ``rdn_trunk_layers`` (srtpu's round-2 trunk, one K2
launch per dense layer), ``wdsr.wdsr_trunk`` (and ``wdsr.wdsr_block``,
one block of it), ``resblock_fused_trunk`` (EDSR's True-route trunk) and
``resblock_fused`` (one block of it), ``resblock_fused_v3`` (K8a forward, K9d backward), ``ca_gate`` and
``wdsr_block.wdsr_block_fused``. ``trunk.trunk_xla`` is srtpu's XLA
trunk past 96 features (stock ops), ``rcab.resgroup_xla`` its RCAN
residual group there. Kernels build on first use
(``_build``). Importing this package registers the forward kernels as
``srtpu::`` operators (:mod:`._library`), which the forward wrappers
call."""

from .bn_block import (BNCloseFn, BNResBlockFn, b1_plain, b1_sums, b2_call,
                       b2_plain, b3_call, b3_plain, bn_close, bn_close_ref,
                       bn_resblock, bn_resblock_ref, f1_conv_stats, f1_plain,
                       f2_norm_act_conv_stats, f2_plain, f3_norm_skip,
                       f3_plain)
from .ca_layer import CALayerFn, ca_gate, ca_layer_fwd, ca_layer_plain
from .conv import (Conv3x3Fn, conv3x3, conv3x3_bwd, conv3x3_bwd_plain,
                   conv3x3_fwd, conv3x3_plain)
from .rcab import (ResGroupFn, rcab_bwd, rcab_bwd_plain, rcab_fwd,
                   rcab_fwd_plain, resgroup, resgroup_bwd, resgroup_bwd_plain,
                   resgroup_fwd, resgroup_plain, resgroup_xla)
from .resblock import (FusedResBlockFn, FusedResBlockV3Fn, FusedTrunkFn,
                       resblock_bwd_fused, resblock_bwd_fused_plain,
                       resblock_fused, resblock_fused_bwd,
                       resblock_fused_fwd, resblock_fused_plain,
                       resblock_fused_trunk, resblock_fused_v3,
                       resblock_trunk_fwd, resblock_trunk_plain)
from .rdn import (RDNCallsFn, RDNLayersFn, RDNTrunkFn, rdb_bwd_chain,
                  rdb_bwd_chain_plain, rdb_bwd_dw, rdb_bwd_dw_plain, rdn_fwd,
                  rdn_fwd_plain, rdn_trunk, rdn_trunk_calls,
                  rdn_trunk_layers)
from .trunk import (TrunkFn, resblock_cs, trunk, trunk_bwd, trunk_bwd_plain,
                    trunk_fwd, trunk_plain, trunk_xla)
from .upsample import (UpsampleFn, upsample, upsample_bwd, upsample_bwd_plain,
                       upsample_fwd, upsample_plain)
from .wgrad import conv_wgrad, conv_wgrad_plain
from . import _library  # noqa: E402,F401  registers the srtpu:: operators

__all__ = ['BNCloseFn', 'BNResBlockFn', 'CALayerFn', 'Conv3x3Fn',
           'FusedResBlockFn', 'FusedResBlockV3Fn', 'FusedTrunkFn',
           'RDNCallsFn',
           'RDNLayersFn', 'RDNTrunkFn', 'ResGroupFn', 'TrunkFn',
           'rdn_trunk_calls', 'rdn_trunk_layers', 'resblock_bwd_fused',
           'resblock_bwd_fused_plain', 'resblock_cs', 'resblock_fused_v3',
           'resgroup_xla', 'trunk_xla',
           'UpsampleFn', 'b1_plain', 'b1_sums', 'b2_call', 'b2_plain',
           'b3_call', 'b3_plain', 'bn_close', 'bn_close_ref', 'bn_resblock',
           'bn_resblock_ref', 'ca_gate', 'ca_layer_fwd', 'ca_layer_plain',
           'conv3x3', 'conv3x3_bwd', 'conv3x3_bwd_plain',
           'conv3x3_fwd', 'conv3x3_plain', 'conv_wgrad', 'conv_wgrad_plain',
           'f1_conv_stats', 'f1_plain', 'f2_norm_act_conv_stats', 'f2_plain',
           'f3_norm_skip', 'f3_plain', 'rcab_bwd', 'rcab_bwd_plain',
           'rcab_fwd', 'rcab_fwd_plain', 'rdb_bwd_chain',
           'rdb_bwd_chain_plain', 'rdb_bwd_dw', 'rdb_bwd_dw_plain', 'rdn_fwd',
           'rdn_fwd_plain',
           'rdn_trunk', 'resblock_fused', 'resblock_fused_bwd',
           'resblock_fused_fwd', 'resblock_fused_plain',
           'resblock_fused_trunk', 'resblock_trunk_fwd',
           'resblock_trunk_plain', 'resgroup',
           'resgroup_bwd',
           'resgroup_bwd_plain', 'resgroup_fwd', 'resgroup_plain', 'trunk',
           'trunk_bwd', 'trunk_bwd_plain', 'trunk_fwd', 'trunk_plain',
           'upsample', 'upsample_bwd', 'upsample_bwd_plain', 'upsample_fwd',
           'upsample_plain']
