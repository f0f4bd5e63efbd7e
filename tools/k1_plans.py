"""Time K1 (EDSR's resblock trunk) and the engine it runs on, on the card.

For the srtpu_torch of this checkout, or with ``--tree DIR`` of another
(the parent commit unpacked with ``git archive`` into a git-ignored
directory):

- K1 at chip_smoke.py's ``K1_TIMED`` cases (16 blocks at the training
  shape, batch 16, LR 32x32, and at 1 x 128 x 128, res_scale 1.0; 86
  blocks and one block at the training shape, res_scale 0.1): the
  forward saving and not, the backward (dx chain and its two weight-grad
  launches) and those two weight-grad launches alone, each as device
  time alone (one CUDA graph of the calls) and host time a call; where
  the tree has ``trunk_chain``, the dx chain alone; the chain is also
  the backward less its weight grads, as on trees without it;
- the classes of the engine K1 runs on and of the kernels sharing it,
  device time alone at the training shape: K2's forward and dx and W's
  (``tree_timing.engine_times``), K5's and K6's
  (``tree_timing.epilogue_times``).

To compare two trees on one card, run both in one call, in turns
(parent, this, this, parent). Needs a CUDA card::

    python3 tools/k1_plans.py [--tree DIR]
"""

from __future__ import annotations

import argparse
import importlib

import torch

from tree_timing import engine_times, epilogue_times, load_chip_smoke

ARGS = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ARGS.add_argument('--tree', help="time this checkout's srtpu_torch")
chip_smoke = load_chip_smoke(ARGS.parse_args().tree)
k1 = importlib.import_module('srtpu_torch.ops.trunk')
from srtpu_torch.ops.wgrad import conv_wgrad  # noqa: E402


def k1_times(device, smi: str) -> None:
    cs = chip_smoke
    bf, f32 = torch.bfloat16, torch.float32
    cb = (9 * cs.C) ** -0.5
    for nb, rs, bsz, h, w in cs.K1_TIMED:
        gen = torch.Generator().manual_seed(nb * 1009 + bsz * 31 + h)
        args = (cs._uniform(gen, (bsz, h, w, cs.C), 1.0, device, bf),
                cs._uniform(gen, (nb, 3, 3, cs.C, cs.C), cb, device, bf),
                cs._uniform(gen, (nb, cs.C), cb, device, f32),
                cs._uniform(gen, (nb, 3, 3, cs.C, cs.C), cb, device, bf),
                cs._uniform(gen, (nb, cs.C), cb, device, f32), rs)
        g = cs._uniform(gen, (bsz, h, w, cs.C), 1.0, device, bf)
        _, xs, h1s = k1.trunk_fwd(*args, save=True)
        bargs = (xs, h1s, g, args[1], args[3], rs)
        fns = {'fwd (saving)': lambda: k1.trunk_fwd(*args, save=True),
               'fwd (predict)': lambda: k1.trunk_fwd(*args),
               'bwd (chain + 2 weight grads)': lambda: k1.trunk_bwd(*bargs),
               # the two weight-grad launches at their shapes and scale
               'weight grads alone': lambda: (
                   conv_wgrad(h1s, xs, gscale=rs), conv_wgrad(xs, h1s))}
        if hasattr(k1, 'trunk_chain'):
            fns['dx chain'] = lambda: k1.trunk_chain(h1s, g, args[1],
                                                     args[3], rs)
        calls = 5 if nb > 1 else 20
        dev = {}
        for name, fn in fns.items():
            dev[name] = cs.graph_ms(fn, calls, 3)
            print(f'K1 L={nb} res_scale {rs} {bsz}x{h}x{w} {name}: device '
                  f'{dev[name]:.4f} ms ({dev[name] / nb:.5f} a block), host '
                  f'{cs.host_ms(fn):.4f} ms a call  [{smi}]', flush=True)
        chain = dev['bwd (chain + 2 weight grads)'] - dev['weight grads alone']
        print(f'K1 L={nb} res_scale {rs} {bsz}x{h}x{w} dx chain as bwd less '
              f'its weight grads: device {chain:.4f} ms ({chain / nb:.5f} a '
              f'block)  [{smi}]', flush=True)
        del args, g, xs, h1s, bargs, fns
        torch.cuda.empty_cache()


def main() -> None:
    device, smi = chip_smoke.card()
    print(f'srtpu_torch from {k1.__file__}')
    k1_times(device, smi)
    engine_times(chip_smoke, device, smi)
    epilogue_times(chip_smoke, device, smi)


if __name__ == '__main__':
    main()
