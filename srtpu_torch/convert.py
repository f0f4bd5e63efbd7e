"""JAX EDSR, RCAN, SRResNet, RDN, DDBPN, WDSR, SRGAN and SRCNN parameters
-> an srtpu_torch state dict.

Reads every EDSR tree srtpu stores:

* the default ``use_pallas='cs'`` tree: ``Conv2d_0``, ``CSTrunk_0/{w1, b1,
  w2, b2, close_kernel, close_bias}`` with block weights stacked in the
  CS arrangement (L, 3C, 3C), and ``CSUpscaleTail_0/{up{i}_kernel,
  up{i}_bias, final_kernel, final_bias}`` with phase-major CS upscale
  weights (r*r, 3C, 3C), phase-major biases (r*r, C) and a CS final
  kernel (3*ch, 3*C);
* the ``use_pallas=False`` tree: ``Conv2d_0`` (head),
  ``ResBlock_{i}/Conv2d_{0,1}``, ``Conv2d_1`` (close),
  ``UpscaleBlock_0/Conv2d_{j}`` and ``Conv2d_2`` (final), all HWIO;
* the ``use_pallas=True`` tree: the same, with ``FusedResBlock_{i}/{kernel1,
  bias1, kernel2, bias2}`` in place of the ``ResBlock``s;

and every RCAN tree:

* ``use_pallas='cs'``: ``Conv2d_0`` (head), ``CSResidualGroup_{i}/{w1,
  b1, w2, b2, wd, bd, wu, bu, wc, bc}`` with CS-stacked w1, w2 (L, 3C,
  3C) and a CS wc (3C, 3C), ``trunk_close_kernel`` (CS) and
  ``trunk_close_bias``, ``UpscaleBlock_0/Conv2d_{j}`` and ``Conv2d_1``
  (final);
* ``use_pallas=False``: ``Conv2d_0`` (head), ``ResidualGroup_{i}/
  RCAB_{j}/{Conv2d_0, Conv2d_1, CALayer_0/{Conv2d_0, Conv2d_1}}`` (the
  attention's 1x1 kernels give wd and wu) and ``ResidualGroup_{i}/
  Conv2d_0`` (group close), ``Conv2d_1`` (trunk close),
  ``UpscaleBlock_0/Conv2d_{j}`` and ``Conv2d_2`` (final);
* ``use_pallas=True``: the same, with the fused gate's ``CALayer_0/{w1,
  b1, w2, b2}`` (wd, bd, wu, bu as they are) in each RCAB;

each into the one state dict every route of the model runs.

and either SRResNet tree, which also needs its ``batch_stats`` collection
(the running statistics of batch norm):

* ``use_pallas='cs'``: ``BasicBlock_0/{Conv2d_0, PReLU_0}`` (the 9x9 head
  and its slope), ``CSBNTrunk_0/{w1, b1, bn1_scale, bn1_bias, alpha, w2,
  b2, bn2_scale, bn2_bias, close_w, close_b, close_bn_scale,
  close_bn_bias}`` (w1, w2 (L, 3C, 3C) and close_w (1, 3C, 3C) in the CS
  arrangement; the close vectors (1, C)), ``CSUpscaleTail_0/{up{i}_kernel,
  up{i}_bias, up{i}_alpha, final_kernel, final_bias}`` (a CS 9x9 final
  kernel (9*ch, 9*C)) and ``batch_stats/CSBNTrunk_0/{mean1, var1, mean2,
  var2, mean_close, var_close}``;
* ``use_pallas=False``: ``BasicBlock_0/{Conv2d_0, PReLU_0}``,
  ``ResBlock_{i}/{Conv2d_0, BatchNorm_0, PReLU_0, Conv2d_1,
  BatchNorm_1}``, ``BasicBlock_1/{Conv2d_0, BatchNorm_0}`` (the close),
  ``UpscaleBlock_0/{Conv2d_{j}, PReLU_{j}}``, ``Conv2d_0`` (the 9x9 final
  conv) and ``batch_stats/{ResBlock_{i}/BatchNorm_{0,1}, BasicBlock_1/
  BatchNorm_0}/{mean, var}``.

and either RDN tree (its 'cs' tree at the configs srtpu's ``cs_ok`` takes,
its False tree at every config, config A's G = 32 with G0 = 64 too):

* ``use_pallas='cs'``: ``Conv2d_0`` (SFE1), ``sfe2_kernel`` (CS),
  ``sfe2_bias``, ``dense{i}_kernel`` (D, 3G, 3 (i + 1) G0) CS stacks and
  ``dense{i}_bias`` (D, G), ``lff_kernel`` (D, G0, c_tot) and
  ``lff_bias``, ``gff1_kernel`` (G0, D G0) and ``gff1_bias``,
  ``gff2_kernel`` (CS) and ``gff2_bias``, then the tail ``Conv2d_1``,
  ``Conv2d_2`` (and ``Conv2d_3`` at x4), the last being the final conv;
* ``use_pallas=False``: ``Conv2d_0`` (SFE1), ``Conv2d_1`` (SFE2),
  ``_RDB_{l}/Conv2d_{i}`` (the dense layers, HWIO) and
  ``_RDB_{l}/Conv2d_{C}`` (the 1x1 fusion), ``Conv2d_2`` (GFF1, 1x1),
  ``Conv2d_3`` (GFF2) and the tail from ``Conv2d_4``
  (tests/test_ops_cs.py:472-493 maps one tree onto the other).

and either DDBPN tree:

* ``use_pallas='cs'``: ``Conv2d_0`` (the 3x3 head), ``Conv2d_1`` (the 1x1
  head), ``head_alpha{0,1}``, ``CSDenseProjection_{i}/{bneck_kernel,
  bneck_bias, bneck_alpha, a0_*, b0_*, a1_*}`` with CS-arranged coarse
  projection kernels (up (3 r*r*nr, 3 nr), down (3 nr, 3 r*r*nr)),
  ``out_kernel`` (depth, 3 CO, 3 r*r*nr) (CS, one phase-dense conv per HR
  block) and ``out_bias``;
* ``use_pallas=False`` (or True): ``Conv2d_{0,1}`` and ``PReLU_{0,1}``
  (the head), ``DenseProjection_{i}/{Conv2d_0, PReLU_0}`` (the
  bottleneck, where present) and ``_ProjectionConv_{j}/{ConvTranspose2d_0
  | Conv2d_0}`` with its ``PReLU``, and ``Conv2d_2`` (the output conv):
  by default onto the 'cs' model, the fine k x k kernels rearranged by
  ``ops.ddbpn``'s ``w_up_pm`` / ``w_down_pd`` and the output conv by
  ``layout.w_phase_dense`` per block (srtpu/ops/ddbpn_cs.py:145-185 maps
  one tree onto the other); with ``use_pallas`` False one to one onto the
  model of its own route (``FineProjection``'s fine kernels and the fine
  output conv).

and every WDSR tree:

* block B, ``use_pallas=False``: ``WNConv2d_0`` (the 5x5 skip),
  ``WNConv2d_1`` (the head), ``_BlockB_{i}/WNConv2d_{0,1,2}`` (expand,
  linear, conv) and the last ``WNConv2d_k`` (the tail), each ``{v, g,
  bias}``;
* block B, ``use_pallas='cs'`` or ``True``: the same skip, head and tail,
  and ``_BlockB_{i}/{expand,linear,conv}_{v,g,b}`` (the 1x1 ``v``s stored
  as (1, 1, cin, cout));
* block A: ``_BlockA_{i}/WNConv2d_{0,1}``;

all to one state dict (``WNConv2d``'s ``v``, ``g``, ``bias`` per conv),
which runs on either of the port's routes.

and either SRGAN tree (``params`` and ``batch_stats`` each hold
``generator`` and ``discriminator``, as srtpu's combined G+D view):

* the generator, ``use_pallas=False``: ``Conv2d_0`` (the 9x9 head),
  ``PReLU_0``, ``_SRGANBlock_{i}/{Conv2d_0, BatchNorm_0, PReLU_0,
  Conv2d_1, BatchNorm_1}``, ``Conv2d_1`` + ``BatchNorm_0`` (the close),
  ``UpscaleBlock_0/{Conv2d_{j}, PReLU_{j}}`` and ``Conv2d_2`` (the 9x9
  output), with ``batch_stats/generator/{_SRGANBlock_{i}/BatchNorm_{0,1},
  BatchNorm_0}/{mean, var}``;
* the generator, ``use_pallas='cs'``: ``Conv2d_0``, ``PReLU_0``,
  ``CSBNTrunk_0`` (as SRResNet's) in place of the blocks and the close,
  ``UpscaleBlock_0`` and ``Conv2d_1`` (the output), with
  ``batch_stats/generator/CSBNTrunk_0``;
* the discriminator: ``Conv2d_0`` .. ``Conv2d_9`` and ``BatchNorm_0`` ..
  ``BatchNorm_6`` with their ``batch_stats``;

both into the port's one stacked trunk; and SRCNN's tree, exactly
``Conv2d_0`` (9x9), ``Conv2d_1`` (1x1) and ``Conv2d_2`` (5x5), HWIO, into
``conv1`` .. ``conv3``.

A tree is nested dicts of numpy arrays, with or without the top-level
``params`` key (an SRResNet tree with it, beside ``batch_stats``). Any
JAX host can write one as a flat ``.npz`` (``np.savez(path,
**{'params/CSTrunk_0/w1': ..., 'batch_stats/...': ..., ...})``);
:func:`load_npz` reads it back.

:func:`params_from_jax`'s ``use_pallas`` is the route of the model the
state dict is for; it matters for DDBPN alone, whose routes keep two
trees (the other families' routes share one state dict).
:func:`state_from_jax` carries a whole srtpu training state across (its
``step``, ``params``, ``batch_stats`` and ``opt_state``, the tree srtpu's
``CheckpointManager`` keeps) into a port checkpoint that ``Trainer.fit``
resumes (``--ckpt_path``). The ``.npz`` is written on a JAX host, each
leaf of srtpu's state tree under its '/'-joined path (dict keys,
NamedTuple field names, tuple indices: ``opt_state/0/mu/model/...``);
README.md has the snippet.

Command lines::

    python -m srtpu_torch.convert in.npz out.pt
    python -m srtpu_torch.convert --state state.npz OUT_DIR \\
        [--hparams RUN/checkpoints/hparams.json]

The second writes ``OUT_DIR/last/state.pt`` and ``OUT_DIR/hparams.json``
(by default the ``hparams.json`` beside the ``.npz``); ``fit
--ckpt_path OUT_DIR`` resumes from it, ``validate --checkpoint OUT_DIR``
scores it.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from .ops.ddbpn import _PROJ_PARAMS, w_down_pd, w_up_pm
from .ops.layout import w_hwio_from_cs, w_phase_dense, w_ps_hwio
from .train.state import LOSS_PREFIX


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def _conv(sd: dict, name: str, node: dict) -> None:
    sd[f'{name}.weight'] = _t(node['kernel'])
    sd[f'{name}.bias'] = _t(node['bias'])


def _seq(node: dict, prefix: str) -> list:
    """node[prefix + '0'], node[prefix + '1'], ... while present."""
    out = []
    while f'{prefix}{len(out)}' in node:
        out.append(node[f'{prefix}{len(out)}'])
    return out


def _rcan_from_jax(p: dict) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    _conv(sd, 'head', p['Conv2d_0'])
    n = sd['head.weight'].shape[-1]
    for j, conv in enumerate(_seq(p['UpscaleBlock_0'], 'Conv2d_')):
        _conv(sd, f'upscale.convs.{j}', conv)
    if 'CSResidualGroup_0' in p:
        for i, grp in enumerate(_seq(p, 'CSResidualGroup_')):
            pre = f'groups.{i}.'
            for k in ('b1', 'b2', 'wd', 'bd', 'wu', 'bu', 'bc'):
                sd[pre + k] = _t(grp[k])
            for k in ('w1', 'w2'):
                sd[pre + k] = w_hwio_from_cs(_t(grp[k]), n, n).contiguous()
            sd[pre + 'wc'] = w_hwio_from_cs(_t(grp['wc'])[None], n, n)[0] \
                .contiguous()
        sd['trunk_close_weight'] = w_hwio_from_cs(
            _t(p['trunk_close_kernel'])[None], n, n)[0].contiguous()
        sd['trunk_close_bias'] = _t(p['trunk_close_bias'])
        _conv(sd, 'final', p['Conv2d_1'])
        return sd
    for i, grp in enumerate(_seq(p, 'ResidualGroup_')):
        pre = f'groups.{i}.'
        blocks = _seq(grp, 'RCAB_')
        for k, conv, leaf in (('w1', 'Conv2d_0', 'kernel'),
                              ('b1', 'Conv2d_0', 'bias'),
                              ('w2', 'Conv2d_1', 'kernel'),
                              ('b2', 'Conv2d_1', 'bias')):
            sd[pre + k] = torch.stack([_t(b[conv][leaf]) for b in blocks])
        ca = [b['CALayer_0'] for b in blocks]
        for w, b, j in (('wd', 'bd', 0), ('wu', 'bu', 1)):
            if 'w1' in ca[0]:           # the fused gate's own (I, O)
                sd[pre + w] = torch.stack([_t(a[f'w{j + 1}']) for a in ca])
                sd[pre + b] = torch.stack([_t(a[f'b{j + 1}']) for a in ca])
                continue
            # 1x1 kernels (1, 1, I, O) -> (I, O)
            sd[pre + w] = torch.stack([_t(a[f'Conv2d_{j}']['kernel'])[0, 0]
                                       for a in ca])
            sd[pre + b] = torch.stack([_t(a[f'Conv2d_{j}']['bias'])
                                       for a in ca])
        sd[pre + 'wc'] = _t(grp['Conv2d_0']['kernel'])
        sd[pre + 'bc'] = _t(grp['Conv2d_0']['bias'])
    sd['trunk_close_weight'] = _t(p['Conv2d_1']['kernel'])
    sd['trunk_close_bias'] = _t(p['Conv2d_1']['bias'])
    _conv(sd, 'final', p['Conv2d_2'])
    return sd


def _cs_tail(sd: dict, tail: dict, n: int) -> None:
    """``CSUpscaleTail_0`` -> ``tail.*``: phase-major CS upscale weights
    (r*r, 3C, 3C) and biases (r*r, C) to PixelShuffle order, the slopes
    (SRResNet's), and the CS final kernel (k*ch, k*C) to HWIO."""
    i = 0
    while f'up{i}_kernel' in tail:
        w = _t(tail[f'up{i}_kernel'])
        r = int(round(w.shape[0] ** 0.5))
        sd[f'tail.up{i}_weight'] = w_ps_hwio(w, n, r).contiguous()
        # phase-major (r*r, C) -> PixelShuffle order c*r*r + a*r + b
        sd[f'tail.up{i}_bias'] = _t(tail[f'up{i}_bias']).t().reshape(-1)
        if f'up{i}_alpha' in tail:
            sd[f'tail.up{i}_alpha'] = _t(tail[f'up{i}_alpha'])
        i += 1
    wf = _t(tail['final_kernel'])
    fk = wf.shape[1] // n
    sd['tail.final_weight'] = w_hwio_from_cs(wf[None], n, wf.shape[0] // fk,
                                             fk)[0].contiguous()
    sd['tail.final_bias'] = _t(tail['final_bias'])


def _cs_bn_trunk(sd: dict, pre: str, tr: dict, st: dict, n: int) -> None:
    """``CSBNTrunk_0`` and its batch_stats -> ``{pre}*`` (BNTrunk)."""
    for k in ('b1', 'bn1_scale', 'bn1_bias', 'alpha', 'b2', 'bn2_scale',
              'bn2_bias'):
        sd[pre + k] = _t(tr[k])
    for k in ('w1', 'w2'):
        sd[pre + k] = w_hwio_from_cs(_t(tr[k]), n, n).contiguous()
    sd[pre + 'close_w'] = w_hwio_from_cs(_t(tr['close_w']), n, n)[0] \
        .contiguous()
    for k in ('close_b', 'close_bn_scale', 'close_bn_bias'):
        sd[pre + k] = _t(tr[k])[0]
    for k in ('mean1', 'var1', 'mean2', 'var2'):
        sd[pre + k] = _t(st[k])
    for k in ('mean_close', 'var_close'):
        sd[pre + k] = _t(st[k])[0]


def _bn_blocks(sd: dict, pre: str, blocks: list, bstats: list, close: dict,
               close_bn: dict, close_st: dict) -> None:
    """Per-block BN resblocks (each ``{Conv2d_0, BatchNorm_0, PReLU_0,
    Conv2d_1, BatchNorm_1}``, their stats) and the close's conv, BN and
    stats -> ``{pre}*`` (BNTrunk, stacked)."""
    for j in (1, 2):            # the block's conv j is its Conv2d_{j - 1}
        convs = [blk[f'Conv2d_{j - 1}'] for blk in blocks]
        sd[f'{pre}w{j}'] = torch.stack([_t(c['kernel']) for c in convs])
        sd[f'{pre}b{j}'] = torch.stack([_t(c['bias']) for c in convs])
        for name, leaf, tree in ((f'bn{j}_scale', 'scale', blocks),
                                 (f'bn{j}_bias', 'bias', blocks),
                                 (f'mean{j}', 'mean', bstats),
                                 (f'var{j}', 'var', bstats)):
            sd[pre + name] = torch.stack(
                [_t(b[f'BatchNorm_{j - 1}'][leaf]) for b in tree])
    sd[pre + 'alpha'] = torch.stack([_t(b['PReLU_0']['alpha'])
                                     for b in blocks])
    sd[pre + 'close_w'] = _t(close['kernel'])
    sd[pre + 'close_b'] = _t(close['bias'])
    sd[pre + 'close_bn_scale'] = _t(close_bn['scale'])
    sd[pre + 'close_bn_bias'] = _t(close_bn['bias'])
    sd[pre + 'mean_close'] = _t(close_st['mean'])
    sd[pre + 'var_close'] = _t(close_st['var'])


def _srresnet_from_jax(p: dict, stats: dict) -> dict[str, torch.Tensor]:
    if not stats:
        raise ValueError('an SRResNet tree needs its batch_stats collection '
                         '(the running statistics of batch norm)')
    sd: dict[str, torch.Tensor] = {}
    _conv(sd, 'head', p['BasicBlock_0']['Conv2d_0'])
    sd['head_act.alpha'] = _t(p['BasicBlock_0']['PReLU_0']['alpha'])
    n = sd['head.weight'].shape[-1]
    if 'CSBNTrunk_0' in p:
        _cs_bn_trunk(sd, 'trunk.', p['CSBNTrunk_0'], stats['CSBNTrunk_0'], n)
        _cs_tail(sd, p['CSUpscaleTail_0'], n)
        return sd
    blocks = _seq(p, 'ResBlock_')
    close = p['BasicBlock_1']
    _bn_blocks(sd, 'trunk.', blocks,
               [stats[f'ResBlock_{i}'] for i in range(len(blocks))],
               close['Conv2d_0'], close['BatchNorm_0'],
               stats['BasicBlock_1']['BatchNorm_0'])
    up = p['UpscaleBlock_0']
    for i, conv in enumerate(_seq(up, 'Conv2d_')):
        sd[f'tail.up{i}_weight'] = _t(conv['kernel'])
        sd[f'tail.up{i}_bias'] = _t(conv['bias'])
        sd[f'tail.up{i}_alpha'] = _t(up[f'PReLU_{i}']['alpha'])
    sd['tail.final_weight'] = _t(p['Conv2d_0']['kernel'])
    sd['tail.final_bias'] = _t(p['Conv2d_0']['bias'])
    return sd


def _srgan_from_jax(p: dict, stats: dict) -> dict[str, torch.Tensor]:
    if not stats:
        raise ValueError('an SRGAN tree needs its batch_stats collection '
                         '(the running statistics of batch norm)')
    gp, gst = p['generator'], stats['generator']
    sd: dict[str, torch.Tensor] = {}
    _conv(sd, 'generator.head', gp['Conv2d_0'])
    sd['generator.head_act.alpha'] = _t(gp['PReLU_0']['alpha'])
    n = sd['generator.head.weight'].shape[-1]
    if 'CSBNTrunk_0' in gp:
        _cs_bn_trunk(sd, 'generator.trunk.', gp['CSBNTrunk_0'],
                     gst['CSBNTrunk_0'], n)
        out = gp['Conv2d_1']
    else:
        blocks = _seq(gp, '_SRGANBlock_')
        _bn_blocks(sd, 'generator.trunk.', blocks,
                   [gst[f'_SRGANBlock_{i}'] for i in range(len(blocks))],
                   gp['Conv2d_1'], gp['BatchNorm_0'], gst['BatchNorm_0'])
        out = gp['Conv2d_2']
    up = gp['UpscaleBlock_0']
    for j, conv in enumerate(_seq(up, 'Conv2d_')):
        _conv(sd, f'generator.upscale.convs.{j}', conv)
        sd[f'generator.upscale.acts.{j}.alpha'] = _t(up[f'PReLU_{j}']['alpha'])
    _conv(sd, 'generator.out', out)
    dp, dst = p['discriminator'], stats['discriminator']
    for i, conv in enumerate(_seq(dp, 'Conv2d_')):
        _conv(sd, f'discriminator.convs.{i}', conv)
    for i, bn in enumerate(_seq(dp, 'BatchNorm_')):
        pre = f'discriminator.bns.{i}.'
        sd[pre + 'scale'], sd[pre + 'bias'] = _t(bn['scale']), _t(bn['bias'])
        st = dst[f'BatchNorm_{i}']
        sd[pre + 'mean'], sd[pre + 'var'] = _t(st['mean']), _t(st['var'])
    return sd


def _rdn_tail(sd: dict, convs: list) -> None:
    """The tail's convs in order: the upscale stages, then the final."""
    for j, conv in enumerate(convs[:-1]):
        _conv(sd, f'upscale.convs.{j}', conv)
    _conv(sd, 'final', convs[-1])


def _rdn_from_jax(p: dict) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    _conv(sd, 'sfe1', p['Conv2d_0'])
    g0 = sd['sfe1.weight'].shape[-1]
    if 'sfe2_kernel' in p:
        for k in ('sfe2', 'gff2'):
            sd[f'{k}_weight'] = w_hwio_from_cs(_t(p[f'{k}_kernel'])[None], g0,
                                               g0)[0].contiguous()
            sd[f'{k}_bias'] = _t(p[f'{k}_bias'])
        i = 0
        while f'dense{i}_kernel' in p:
            w = _t(p[f'dense{i}_kernel'])
            sd[f'dense{i}_weight'] = w_hwio_from_cs(
                w, w.shape[2] // 3, w.shape[1] // 3).contiguous()
            sd[f'dense{i}_bias'] = _t(p[f'dense{i}_bias'])
            i += 1
        sd['lff_weight'] = _t(p['lff_kernel']).transpose(1, 2).contiguous()
        sd['lff_bias'] = _t(p['lff_bias'])
        sd['gff1_weight'] = _t(p['gff1_kernel']).t().contiguous()
        sd['gff1_bias'] = _t(p['gff1_bias'])
        _rdn_tail(sd, _seq(p, 'Conv2d_')[1:])
        return sd
    blocks = _seq(p, '_RDB_')
    layers = [_seq(blk, 'Conv2d_') for blk in blocks]
    n = len(layers[0]) - 1            # dense layers; the last is the fusion
    for i in range(n):
        sd[f'dense{i}_weight'] = torch.stack([_t(ly[i]['kernel'])
                                              for ly in layers])
        sd[f'dense{i}_bias'] = torch.stack([_t(ly[i]['bias'])
                                            for ly in layers])
    sd['lff_weight'] = torch.stack([_t(ly[n]['kernel'])[0, 0]
                                    for ly in layers])
    sd['lff_bias'] = torch.stack([_t(ly[n]['bias']) for ly in layers])
    convs = _seq(p, 'Conv2d_')
    for k, conv in (('sfe2', convs[1]), ('gff2', convs[3])):
        sd[f'{k}_weight'], sd[f'{k}_bias'] = _t(conv['kernel']), \
            _t(conv['bias'])
    sd['gff1_weight'] = _t(convs[2]['kernel'])[0, 0]
    sd['gff1_bias'] = _t(convs[2]['bias'])
    _rdn_tail(sd, convs[4:])
    return sd


def _cs_hwio(w) -> torch.Tensor:
    """A CS-arranged 3x3 kernel (..., 3 C', 3 C) -> HWIO (..., 3, 3, C,
    C')."""
    w = _t(w)
    lead = w.shape[:-2]
    w = w.reshape(-1, *w.shape[-2:])
    out = w_hwio_from_cs(w, w.shape[-1] // 3, w.shape[-2] // 3)
    return out.reshape(*lead, *out.shape[1:]).contiguous()


def _ddbpn_from_jax(p: dict, use_pallas) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    for i in (0, 1):
        _conv(sd, f'head{i}', p[f'Conv2d_{i}'])
    nr = sd['head1.weight'].shape[-1]
    if 'CSDenseProjection_0' in p:
        if use_pallas != 'cs':
            raise ValueError(
                "a DDBPN 'cs' tree holds coarse phase-major kernels; the "
                'fine kernels of use_pallas=False cannot be taken from it')
        for i in (0, 1):
            sd[f'head_alpha{i}'] = _t(p[f'head_alpha{i}'])
        for i, unit in enumerate(_seq(p, 'CSDenseProjection_')):
            for k, v in unit.items():
                # the projection kernels are CS-arranged; the bottleneck's
                # (c_tot, nr) is the port's as it is
                cs = k.endswith('_kernel') and k != 'bneck_kernel'
                sd[f'units.{i}.{k.replace("_kernel", "_weight")}'] = \
                    _cs_hwio(v) if cs else _t(v)
        sd['out_weight'] = _cs_hwio(p['out_kernel'])
        sd['out_bias'] = _t(p['out_bias'])
        return sd
    # the False tree: one to one onto the model of its own route, or
    # rearranged onto the 'cs' model's coarse kernels
    fine = use_pallas != 'cs'
    for i in (0, 1):
        sd[f'head_alpha{i}'] = _t(p[f'PReLU_{i}']['alpha'])
    units = _seq(p, 'DenseProjection_')
    # the scale from the projection kernel's size (k = 6, 8, 12)
    k_proj = next(iter(units[0]['_ProjectionConv_0'].values()))['kernel']
    r = {k: s for s, (k, _, _) in _PROJ_PARAMS.items()}[k_proj.shape[0]]
    for i, unit in enumerate(units):
        pre = f'units.{i}.'
        off = 0
        if 'Conv2d_0' in unit:              # the 1x1 bottleneck
            w = _t(unit['Conv2d_0']['kernel'])
            sd[pre + 'bneck_weight'] = w if fine else w[0, 0]
            sd[pre + 'bneck_bias'] = _t(unit['Conv2d_0']['bias'])
            sd[pre + 'bneck_alpha'] = _t(unit['PReLU_0']['alpha'])
            off = 1
        for j, name in enumerate(('a0', 'b0', 'a1')):
            pc = unit[f'_ProjectionConv_{j}']
            leaf = pc.get('ConvTranspose2d_0', pc.get('Conv2d_0'))
            w = _t(leaf['kernel'])
            sd[f'{pre}{name}_weight'] = w if fine else (
                w_up_pm(w, r) if 'ConvTranspose2d_0' in pc
                else w_down_pd(w, r))
            sd[f'{pre}{name}_bias'] = _t(leaf['bias'])
            sd[f'{pre}{name}_alpha'] = _t(unit[f'PReLU_{off + j}']['alpha'])
    wf = _t(p['Conv2d_2']['kernel'])               # (3, 3, depth * nr, ch)
    sd['out_weight'] = wf if fine else torch.stack([
        w_phase_dense(wf[:, :, t * nr:(t + 1) * nr], r)
        for t in range(wf.shape[2] // nr)])
    sd['out_bias'] = _t(p['Conv2d_2']['bias'])
    return sd


def tree_route(tree: dict):
    """The ``use_pallas`` an srtpu tree was trained on, as far as its
    layout shows it: 'cs' for the trees of a kernel route (CS-arranged
    leaves), False for the per-module XLA trees (srtpu's True trees are
    the same)."""
    p = tree.get('params', tree)
    cs = ('CSTrunk_0', 'CSResidualGroup_0', 'CSBNTrunk_0', 'sfe2_kernel',
          'CSDenseProjection_0')
    gen = p.get('generator', {})
    return 'cs' if any(k in p or k in gen for k in cs) else False


def _wn(sd: dict, name: str, node: dict, prefix: str = '') -> None:
    """A weight-normed conv's ``{v, g, bias}`` (or, with ``prefix``,
    ``{prefix}_v``, ``{prefix}_g``, ``{prefix}_b``) -> ``name.*``."""
    leaves = ('v', 'g', 'bias') if not prefix else tuple(
        f'{prefix}_{k}' for k in ('v', 'g', 'b'))
    for k, leaf in zip(('v', 'g', 'bias'), leaves):
        sd[f'{name}.{k}'] = _t(node[leaf])


def _wdsr_from_jax(p: dict) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    convs = _seq(p, 'WNConv2d_')
    for name, node in (('skip', convs[0]), ('head', convs[1]),
                       ('tail', convs[-1])):
        _wn(sd, name, node)
    for i, blk in enumerate(_seq(p, '_BlockA_')):
        for j in (0, 1):
            _wn(sd, f'blocks.{i}.conv{j}', blk[f'WNConv2d_{j}'])
    for i, blk in enumerate(_seq(p, '_BlockB_')):
        for j, name in enumerate(('expand', 'linear', 'conv')):
            if 'expand_v' in blk:
                _wn(sd, f'blocks.{i}.{name}', blk, name)
            else:
                _wn(sd, f'blocks.{i}.{name}', blk[f'WNConv2d_{j}'])
    return sd


def params_from_jax(tree: dict, use_pallas='cs'
                    ) -> dict[str, torch.Tensor]:
    """State dict of :class:`srtpu_torch.models.EDSR`, ``RCAN``,
    ``SRResNet``, ``RDN``, ``DDBPN``, ``WDSR``, ``SRGAN`` or ``SRCNN``
    from a JAX tree
    of that model (an SRResNet or SRGAN tree with its ``batch_stats``),
    dispatched on the tree's keys, for the model of route ``use_pallas``
    (DDBPN's False and True routes keep a tree of their own; see the
    module note)."""
    p = tree.get('params', tree)
    if 'generator' in p:
        return _srgan_from_jax(p, tree.get('batch_stats', {}))
    if 'WNConv2d_0' in p:
        return _wdsr_from_jax(p)
    if 'sfe2_kernel' in p or '_RDB_0' in p:
        return _rdn_from_jax(p)
    if 'CSDenseProjection_0' in p or 'DenseProjection_0' in p:
        return _ddbpn_from_jax(p, use_pallas)
    if 'CSResidualGroup_0' in p or 'ResidualGroup_0' in p:
        return _rcan_from_jax(p)
    if 'BasicBlock_0' in p:
        return _srresnet_from_jax(p, tree.get('batch_stats', {}))
    if set(p) == {'Conv2d_0', 'Conv2d_1', 'Conv2d_2'}:    # SRCNN: 9-1-5
        sd: dict[str, torch.Tensor] = {}
        for i in range(3):
            _conv(sd, f'conv{i + 1}', p[f'Conv2d_{i}'])
        return sd
    head = p['Conv2d_0']
    sd = {'head.weight': _t(head['kernel']), 'head.bias': _t(head['bias'])}
    n = sd['head.weight'].shape[-1]
    if 'CSTrunk_0' in p:
        tr = p['CSTrunk_0']
        sd['trunk.w1'] = w_hwio_from_cs(_t(tr['w1']), n, n).contiguous()
        sd['trunk.b1'] = _t(tr['b1'])
        sd['trunk.w2'] = w_hwio_from_cs(_t(tr['w2']), n, n).contiguous()
        sd['trunk.b2'] = _t(tr['b2'])
        sd['trunk.close_weight'] = _t(tr['close_kernel'])
        sd['trunk.close_bias'] = _t(tr['close_bias'])
        _cs_tail(sd, p['CSUpscaleTail_0'], n)
        return sd
    if 'FusedResBlock_0' in p:
        blocks = [(b['kernel1'], b['bias1'], b['kernel2'], b['bias2'])
                  for b in _seq(p, 'FusedResBlock_')]
    else:                       # the block's conv j is its Conv2d_{j - 1}
        blocks = [(b['Conv2d_0']['kernel'], b['Conv2d_0']['bias'],
                   b['Conv2d_1']['kernel'], b['Conv2d_1']['bias'])
                  for b in _seq(p, 'ResBlock_')]
    for k, leaves in zip(('w1', 'b1', 'w2', 'b2'), zip(*blocks)):
        sd[f'trunk.{k}'] = torch.stack([_t(a) for a in leaves])
    sd['trunk.close_weight'] = _t(p['Conv2d_1']['kernel'])
    sd['trunk.close_bias'] = _t(p['Conv2d_1']['bias'])
    up = p['UpscaleBlock_0']
    for i in range(len(up)):
        sd[f'tail.up{i}_weight'] = _t(up[f'Conv2d_{i}']['kernel'])
        sd[f'tail.up{i}_bias'] = _t(up[f'Conv2d_{i}']['bias'])
    sd['tail.final_weight'] = _t(p['Conv2d_2']['kernel'])
    sd['tail.final_bias'] = _t(p['Conv2d_2']['bias'])
    return sd


def load_npz(path) -> dict:
    """Nested tree from a flat ``.npz`` whose keys are '/'-joined paths."""
    tree: dict = {}
    with np.load(path) as f:
        for key in f.files:
            *parents, leaf = key.split('/')
            node = tree
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = f[key]
    return tree


def _leaves(tree, path=()):
    """(path, leaf) of a nested dict tree, in key order."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _like(tree, fn) -> dict:
    """``tree`` with each leaf ``a`` replaced by ``fn(a)``."""
    return {k: _like(v, fn) if isinstance(v, dict) else fn(np.asarray(v))
            for k, v in tree.items()}


def _parameter_keys(params: dict, stats: dict, use_pallas='cs'
                    ) -> list[str]:
    """The state-dict keys :func:`params_from_jax` fills from ``params``
    (the others come from ``batch_stats``: batch norm's buffers)."""
    nan = params_from_jax({'params': _like(params, np.zeros_like),
                           'batch_stats': _like(stats, lambda a: np.full(
                               a.shape, np.nan, np.float32))}, use_pallas)
    return [k for k, v in nan.items() if not torch.isnan(v).any()]


def check_relayout(params: dict, stats: dict, use_pallas='cs') -> None:
    """Raise unless :func:`params_from_jax` moves every element of
    ``params`` to exactly one place and makes no other value (the CS
    stacking, the phase-major tail and every other rearrangement),
    which a per-leaf map of Adam's moments needs. Two probes give each
    element its index as (index // 4096 + 1, index % 4096 + 1), both
    exact in f32; the mapped pairs must be every index once."""
    total = sum(leaf.size for _, leaf in _leaves(params))
    order = {path: n for n, (path, _) in enumerate(_leaves(params))}
    starts = np.cumsum([0] + [leaf.size for _, leaf in _leaves(params)])

    def probe(fn):
        def leaf_of(path, a):
            idx = starts[order[path]] + np.arange(a.size).reshape(a.shape)
            return fn(idx).astype(np.float32)

        def walk(tree, path=()):
            return {k: walk(v, path + (k,)) if isinstance(v, dict)
                    else leaf_of(path + (k,), np.asarray(v))
                    for k, v in tree.items()}
        return params_from_jax({'params': walk(params),
                                'batch_stats': stats}, use_pallas)

    out_hi = probe(lambda i: i // 4096 + 1)
    out_lo = probe(lambda i: i % 4096 + 1)
    got = {k: ((out_hi[k].double() - 1) * 4096
               + out_lo[k].double() - 1).reshape(-1).numpy()
           for k in _parameter_keys(params, stats, use_pallas)}
    flat = np.sort(np.concatenate(list(got.values())))
    if flat.shape != (total,) or not np.array_equal(flat, np.arange(total)):
        bad = [k for k, v in got.items()
               if np.any(v < 0) or np.any(v >= total)][:3]
        raise ValueError(
            "this tree's conversion is not a pure relayout (it pads, sums "
            f'or repeats elements; e.g. {bad or list(got)[:3]}), so the '
            "optimizer's moments cannot be carried across per element")


def _central_default(shape) -> tuple | None:
    """srtpu's centralisation of a port parameter that came from an HWIO
    kernel (4-D) or from a stack of them, HWIO or CS-arranged (5-D):
    per output channel over the taps and the input channels."""
    if len(shape) == 5:
        return tuple(shape), (1, 2, 3)
    if len(shape) == 4:
        return tuple(shape), (0, 1, 2)
    return None


def centralize_plan(model) -> dict[str, tuple | None]:
    """RangerVA's gradient centralisation (srtpu ``optim._centralize``)
    on ``model``'s parameters: ``{name: (view, axes) or None}``, the
    means srtpu takes on its tree of the same model and route, mapped
    onto the port's layout by the maps above. srtpu centralises its 4-D
    kernels over axes (0, 1, 2) whatever their layout (HWIO per output,
    DDBPN's HWOI transposed convs per input channel) and its 3-D leaves
    whose last two sides are multiples of 3 (its CS stacks, and also
    RCAN's 'cs' attention weights and RDN's fusion kernels at such
    widths), and leaves its 2-D CS-arranged kernels as they are: the
    'cs' tails' final convs, RCAN's group and trunk closes, RDN's SFE2,
    GFF1 and GFF2, DDBPN's projections. Off those routes srtpu's trees
    are per-module HWIO (HWOI) kernels: RDN's per-block path (config A
    on 'cs' too) centralises its 1x1 fusions and GFF1 per output, and
    DDBPN's fine projections, bottlenecks and output conv are the port's
    4-D kernels as they are."""
    from .optim import srtpu_centralize_rule
    kind = type(model).__name__
    route = getattr(model, 'use_pallas', 'cs')
    plan = {name: _central_default(p.shape)
            for name, p in model.named_parameters()}
    two_d = set()
    if kind in ('EDSR', 'SRResNet') and route == 'cs':
        two_d = {'tail.final_weight'}
    elif kind == 'RCAN':
        for name, p in model.named_parameters():
            leaf = name.rsplit('.', 1)[-1]
            if route == 'cs' and leaf == 'wc':
                two_d.add(name)
            elif leaf in ('wd', 'wu'):
                # 'cs': srtpu's (L, C, C / r) stacks as they are; False:
                # its 1x1 kernels, per output over c_in; True: 2-D
                plan[name] = (srtpu_centralize_rule(p.shape)
                              if route == 'cs' else
                              (tuple(p.shape), (1,)) if route is False
                              else None)
        if route == 'cs':
            two_d.add('trunk_close_weight')
    elif kind == 'RDN':
        d, c_tot, g0 = model.lff_weight.shape
        if model.per_block:
            # srtpu's False tree: the fusions and GFF1 are 1x1 HWIO
            # kernels, per output over their inputs; SFE2, GFF2 4-D
            plan['lff_weight'] = (d, c_tot, g0), (1,)
            plan['gff1_weight'] = tuple(model.gff1_weight.shape), (0,)
        else:
            two_d = {'sfe2_weight', 'gff1_weight', 'gff2_weight'}
            # srtpu's (D, G0, c_tot), the port's its transpose
            plan['lff_weight'] = (((d, c_tot, 3, g0 // 3), (1, 2))
                                  if g0 % 3 == 0 and c_tot % 3 == 0
                                  else None)
    elif kind == 'DDBPN' and route == 'cs':
        two_d = {name for name in plan
                 if name.endswith(('a0_weight', 'a1_weight', 'b0_weight'))}
    for name in two_d:
        plan[name] = None
    return plan


def _find_optimizer(node: dict):
    """(kind, its state node, the MultiSteps node or None) of srtpu's
    ``opt_state``: each of srtpu's optimizers (ADAM, SGD's trace,
    RMSprop's ``nu`` and trace, the Ranger family's lookahead around
    RAdam's or QHAdam's moments, RangerVA's RAdam second in its chain
    after the centralisation) bare or under the clip / weight-decay
    chain, either inside ``MultiSteps``."""
    multi = None
    if 'inner_opt_state' in node:
        multi, node = node, node['inner_opt_state']
    while set(node) == {'1'} or set(node) == {'0'} and not (
            {'mu', 'nu', 'count', 'trace'} & set(node['0'])):
        node = node['1'] if '1' in node else node['0']
    inner = node.get('0', {})
    if {'inner', 'slow', 'count'} <= set(node):
        chain = node['inner']
        if {'count', 'm', 'v'} <= set(chain.get('0', {})):
            return 'RangerQH', node, multi
        if {'count', 'mu', 'nu'} <= set(chain.get('0', {})):
            return 'Ranger', node, multi
        if {'count', 'mu', 'nu'} <= set(chain.get('1', {})):
            return 'RangerVA', node, multi
    elif {'mu', 'nu', 'count'} <= set(inner):
        return 'ADAM', inner, multi
    elif set(inner) == {'trace'}:
        return 'SGD', inner, multi
    elif set(inner) == {'nu'} and set(node.get('2', {})) == {'trace'}:
        return 'RMSprop', node, multi
    raise ValueError(
        f'unknown srtpu optimizer state structure (keys {sorted(node)}); '
        'state_from_jax takes ADAM, SGD, RMSprop, Ranger, RangerVA and '
        'RangerQH, bare, under the clip chain or inside MultiSteps')


OPT_TYPES = {'ADAM': 'Adam', 'SGD': 'SGD', 'RMSprop': 'RMSprop',
             'Ranger': 'Ranger', 'RangerVA': 'RangerVA',
             'RangerQH': 'RangerQH'}


def _opt_state(kind: str, node: dict, mapped, keys: list[str]):
    """(each parameter's state as the port's optimizer ``kind`` keeps
    it, Adam's count or None) from srtpu's state ``node``."""
    if kind == 'ADAM':
        mu, nu = mapped(node['mu']), mapped(node['nu'])
        count = int(np.asarray(node['count']))
        return {k: {'step': torch.tensor(float(count)), 'exp_avg': mu[k],
                    'exp_avg_sq': nu[k]} for k in keys}, count
    if kind == 'SGD':
        trace = mapped(node['trace'])
        return {k: {'momentum_buffer': trace[k]} for k in keys}, None
    if kind == 'RMSprop':
        nu, trace = mapped(node['0']['nu']), mapped(node['2']['trace'])
        return {k: {'nu': nu[k], 'trace': trace[k]} for k in keys}, None
    # the lookahead's count and its inner chain's move together
    inner = node['inner']['1' if kind == 'RangerVA' else '0']
    count = torch.tensor(float(int(np.asarray(node['count']))))
    slow = mapped(node['slow'])
    names = ('m', 'v') if kind == 'RangerQH' else ('mu', 'nu')
    moments = {n: mapped(inner[n]) for n in names}
    return {k: {'count': count.clone(), 'slow': slow[k],
                **{n: moments[n][k] for n in names}} for k in keys}, None


def _opt_from_jax(opt_state: dict, mapped, keys: list[str]) -> dict:
    """One port optimizer tree (:func:`~srtpu_torch.train.state
    .state_to_tree`'s ``opt_state`` entry) from srtpu's ``opt_state`` of
    the parameters ``keys``: its moments, traces and slow weights
    (MultiSteps' ``acc_grads`` too) through ``mapped`` (a moment tree ->
    its tensors by key), each count as each parameter's (Adam's
    ``step``, also the schedule's position)."""
    kind, node, multi = _find_optimizer(opt_state)
    state, count = _opt_state(kind, node, mapped, keys)
    opt = {'type': OPT_TYPES[kind], 'params': keys, 'state': state,
           'mini_step': 0, 'acc_grads': None}
    if multi is not None:
        opt['mini_step'] = int(np.asarray(multi['mini_step']))
        if 'acc_grads' in multi:
            opt['acc_grads'] = mapped(multi['acc_grads'])
    if count is not None:   # a StepLR's position (the GAN's schedules)
        opt['schedule'] = {'last_epoch': count, '_step_count': count + 1}
    return opt


def _gan_state_from_jax(tree: dict) -> dict:
    """srtpu's SRGAN checkpoint (its combined view: ``params`` and
    ``batch_stats`` under ``generator`` and ``discriminator``,
    ``opt_state`` under ``g`` and ``d``, srtpu/train/gan.py:33-72) as the
    port's: the model as :func:`params_from_jax` maps it, each optimizer
    over its module's parameters, their moments mapped with the other
    module's leaves at zero."""
    params, stats = tree['params'], tree.get('batch_stats', {})
    model = params_from_jax({'params': params, 'batch_stats': stats})
    check_relayout(params, stats)
    keys = _parameter_keys(params, stats)
    opts = {}
    for key, part in (('g', 'generator'), ('d', 'discriminator')):
        own = [k for k in keys if k.startswith(part + '.')]

        def mapped(moment: dict, part=part, own=own):
            full = {n: _like(sub, np.zeros_like) for n, sub in params.items()}
            full[part] = moment
            sd = params_from_jax({'params': full, 'batch_stats': stats})
            return {k: sd[k] for k in own}
        opts[key] = _opt_from_jax(tree['opt_state'][key], mapped, own)
    return {'step': int(np.asarray(tree['step'])), 'model': model,
            'opt_state': opts}


def state_from_jax(tree: dict) -> dict:
    """A port checkpoint (:func:`srtpu_torch.train.state.state_to_tree`'s
    format) from an srtpu training state tree (``step``, ``params``,
    ``batch_stats``, ``opt_state``; a flattened ``.npz`` read by
    :func:`load_npz`). The parameters and batch statistics map as
    :func:`params_from_jax` for the model of the tree's own route
    (:func:`tree_route`); every per-parameter tree of the optimizer's
    state (Adam's ``mu`` and ``nu``, SGD's and RMSprop's ``trace``,
    RMSprop's ``nu``, the Ranger family's moments and slow weights,
    MultiSteps' ``acc_grads``) through the same per-leaf map, which must
    be a pure relayout (:func:`check_relayout`); each count becomes each
    parameter's (Adam's ``step``, the Ranger family's ``count``). srtpu's
    ``loss_params`` (the adaptive loss's latents, ``{i}_{name}`` ->
    {latent: array}) become the checkpoint's ``loss_params`` as they are,
    and the ``'loss'`` half of each such tree their optimizer state.
    srtpu's SRGAN state (G and D, optimizers ``g`` and ``d``) becomes the
    port's SRGAN checkpoint (:func:`_gan_state_from_jax`)."""
    params = tree['params']
    stats = tree.get('batch_stats', {})
    if 'generator' in params:
        return _gan_state_from_jax(tree)
    route = tree_route(params)
    model = params_from_jax({'params': params, 'batch_stats': stats}, route)
    opt_state = tree.get('opt_state', {})
    _find_optimizer(opt_state)      # an unknown structure raises first
    check_relayout(params, stats, route)
    keys = _parameter_keys(params, stats, route)

    def loss_leaves(loss: dict) -> dict[str, torch.Tensor]:
        return {f'{key}.{name}': torch.from_numpy(np.asarray(v, np.float32))
                for key, sub in sorted(loss.items())
                for name, v in sorted(sub.items())}
    loss_params = loss_leaves(tree.get('loss_params', {}))

    def mapped(moment: dict) -> dict[str, torch.Tensor]:
        sd = params_from_jax({'params': moment.get('model', moment),
                              'batch_stats': stats}, route)
        out = {k: sd[k] for k in keys}
        out.update({LOSS_PREFIX + k: v for k, v in loss_leaves(
            moment.get('loss', {}) if 'model' in moment else {}).items()})
        return out

    opt = _opt_from_jax(opt_state, mapped,
                        keys + [LOSS_PREFIX + k for k in loss_params])
    opt.pop('schedule', None)       # the single-model fit has none
    return {'step': int(np.asarray(tree['step'])), 'model': model,
            'loss_params': loss_params, 'opt_state': {'model': opt}}


def write_state(npz, out_dir, hparams=None) -> Path:
    """``out_dir/last/state.pt`` from an srtpu state ``.npz`` and
    ``out_dir/hparams.json`` from ``hparams`` (default: the
    ``hparams.json`` beside the ``.npz``). Returns ``out_dir``."""
    hp_path = Path(hparams) if hparams else Path(npz).parent / 'hparams.json'
    if not hp_path.is_file():
        raise FileNotFoundError(
            f'{hp_path}: the run\'s hparams.json (srtpu writes it into its '
            'checkpoints directory) is needed to rebuild the model; pass '
            '--hparams')
    out = Path(out_dir)
    (out / 'last').mkdir(parents=True, exist_ok=True)
    torch.save(state_from_jax(load_npz(npz)), out / 'last' / 'state.pt')
    (out / 'hparams.json').write_text(
        json.dumps(json.loads(hp_path.read_text()), indent=2))
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    usage = ('usage: python -m srtpu_torch.convert in.npz out.pt\n'
             '       python -m srtpu_torch.convert --state in.npz OUT_DIR '
             '[--hparams FILE]')
    if argv[:1] == ['--state']:
        rest = argv[1:]
        hp = None
        if '--hparams' in rest:
            i = rest.index('--hparams')
            hp = rest[i + 1] if i + 1 < len(rest) else None
            rest = rest[:i] + rest[i + 2:]
            if hp is None:
                print(usage, file=sys.stderr)
                return 2
        if len(rest) != 2:
            print(usage, file=sys.stderr)
            return 2
        write_state(rest[0], rest[1], hp)
        return 0
    if len(argv) != 2:
        print(usage, file=sys.stderr)
        return 2
    torch.save(params_from_jax(load_npz(argv[0])), argv[1])
    return 0


if __name__ == '__main__':
    sys.exit(main())
