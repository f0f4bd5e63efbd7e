"""JAX EDSR parameters -> an srtpu_torch state dict.

Reads either EDSR tree srtpu stores:

* the default ``use_pallas='cs'`` tree: ``Conv2d_0``, ``CSTrunk_0/{w1, b1,
  w2, b2, close_kernel, close_bias}`` with block weights stacked in the
  CS arrangement (L, 3C, 3C), and ``CSUpscaleTail_0/{up{i}_kernel,
  up{i}_bias, final_kernel, final_bias}`` with phase-major CS upscale
  weights (r*r, 3C, 3C), phase-major biases (r*r, C) and a CS final
  kernel (3*ch, 3*C);
* the ``use_pallas=False`` tree: ``Conv2d_0`` (head),
  ``ResBlock_{i}/Conv2d_{0,1}``, ``Conv2d_1`` (close),
  ``UpscaleBlock_0/Conv2d_{j}`` and ``Conv2d_2`` (final), all HWIO.

A tree is nested dicts of numpy arrays, with or without the top-level
``params`` key. Any JAX host can write one as a flat ``.npz``
(``np.savez(path, **{'params/CSTrunk_0/w1': ..., ...})``); :func:`load_npz`
reads it back. Command line::

    python -m srtpu_torch.convert in.npz out.pt
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .ops.layout import w_hwio_from_cs, w_ps_hwio


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """State dict of :class:`srtpu_torch.models.EDSR` from a JAX EDSR tree."""
    p = tree.get('params', tree)
    head = p['Conv2d_0']
    sd = {'head.weight': _t(head['kernel']), 'head.bias': _t(head['bias'])}
    n = sd['head.weight'].shape[-1]
    if 'CSTrunk_0' in p:
        tr, tail = p['CSTrunk_0'], p['CSUpscaleTail_0']
        sd['trunk.w1'] = w_hwio_from_cs(_t(tr['w1']), n, n).contiguous()
        sd['trunk.b1'] = _t(tr['b1'])
        sd['trunk.w2'] = w_hwio_from_cs(_t(tr['w2']), n, n).contiguous()
        sd['trunk.b2'] = _t(tr['b2'])
        sd['trunk.close_weight'] = _t(tr['close_kernel'])
        sd['trunk.close_bias'] = _t(tr['close_bias'])
        i = 0
        while f'up{i}_kernel' in tail:
            w = _t(tail[f'up{i}_kernel'])
            r = int(round(w.shape[0] ** 0.5))
            sd[f'tail.up{i}_weight'] = w_ps_hwio(w, n, r).contiguous()
            # phase-major (r*r, C) -> PixelShuffle order c*r*r + a*r + b
            sd[f'tail.up{i}_bias'] = _t(tail[f'up{i}_bias']).t().reshape(-1)
            i += 1
        wf = _t(tail['final_kernel'])
        ch = wf.shape[0] // 3
        sd['tail.final_weight'] = w_hwio_from_cs(wf[None], n, ch)[0] \
            .contiguous()
        sd['tail.final_bias'] = _t(tail['final_bias'])
        return sd
    blocks = []
    while f'ResBlock_{len(blocks)}' in p:
        blocks.append(p[f'ResBlock_{len(blocks)}'])
    for j in (1, 2):            # the block's conv j is its Conv2d_{j - 1}
        convs = [blk[f'Conv2d_{j - 1}'] for blk in blocks]
        sd[f'trunk.w{j}'] = torch.stack([_t(c['kernel']) for c in convs])
        sd[f'trunk.b{j}'] = torch.stack([_t(c['bias']) for c in convs])
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


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print('usage: python -m srtpu_torch.convert in.npz out.pt',
              file=sys.stderr)
        return 2
    torch.save(params_from_jax(load_npz(argv[0])), argv[1])
    return 0


if __name__ == '__main__':
    sys.exit(main())
