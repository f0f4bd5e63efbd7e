"""Time K5 (RCAN's RCAB) and the engines it runs on, on the card.

For the srtpu_torch of this checkout, or with ``--tree DIR`` of another
(the parent commit unpacked with ``git archive`` into a git-ignored
directory):

- K5 at RCAN-10x16's width (64 features, reduction 16) at the training
  shape (batch 16, LR 32x32) and at 1 x 128 x 128: one RCAB's forward
  (saving, and without, as predict runs it) and backward (with its two
  weight-grad launches), and a 16-RCAB residual group with its close conv
  each way, each as device time alone (one CUDA graph of the calls),
  CUDA-event time of back-to-back calls and host time a call; for one
  RCAB also each kernel's device time a call (torch.profiler);
- the classes of the two engines K5 runs on, device time alone at the
  training shape (``tree_timing.engine_times``: K2's forward and dx, W).

To compare two trees on one card, run both in one call, in turns
(parent, this, this, parent). Needs a CUDA card::

    python3 tools/k5_plans.py [--tree DIR]
"""

from __future__ import annotations

import argparse

import torch

from tree_timing import engine_times, kernels_ms, load_chip_smoke

ARGS = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ARGS.add_argument('--tree', help="time this checkout's srtpu_torch")
chip_smoke = load_chip_smoke(ARGS.parse_args().tree)
from srtpu_torch.ops import rcab  # noqa: E402


def k5_times(device, smi: str) -> None:
    """One RCAB and a 16-RCAB group each way at two shapes."""
    cs = chip_smoke
    for bsz, h, w in cs.K5_SHAPES[:2]:
        gen = torch.Generator().manual_seed(bsz * 7919 + h * 101 + w)
        prm = cs.rcab_params(gen, device)
        x = cs._uniform(gen, (bsz, h, w, cs.C), 1.0, device, torch.bfloat16)
        g = cs._uniform(gen, (bsz, h, w, cs.C), 1.0, device, torch.bfloat16)
        _, h1, r2 = rcab.rcab_fwd(x, *prm, save=True)
        bargs = (x, h1, r2, g, prm[0], prm[2], *prm[4:])
        cb = (9 * cs.C) ** -0.5
        gprm = (*cs.rcab_params(gen, device, (cs.RCABS,)),
                cs._uniform(gen, (3, 3, cs.C, cs.C), cb, device,
                            torch.bfloat16),
                cs._uniform(gen, (cs.C,), cb, device, torch.float32))
        _, xs, h1s, r2s = rcab.resgroup_fwd(x, *gprm, save=True)
        gargs = (xs, h1s, r2s, g, gprm[0], gprm[2], *gprm[4:8], gprm[8])
        tag = f'{bsz}x{h}x{w}'
        one = {'RCAB fwd (saving)': lambda: rcab.rcab_fwd(x, *prm,
                                                           save=True),
               'RCAB fwd (predict)': lambda: rcab.rcab_fwd(x, *prm),
               'RCAB bwd (with its 2 weight grads)':
                   lambda: rcab.rcab_bwd(*bargs)}
        group = {f'group of {cs.RCABS} fwd (saving)':
                     lambda: rcab.resgroup_fwd(x, *gprm, save=True),
                 f'group of {cs.RCABS} fwd (predict)':
                     lambda: rcab.resgroup_fwd(x, *gprm),
                 f'group of {cs.RCABS} bwd': lambda: rcab.resgroup_bwd(
                     *gargs)}
        for name, fn in {**one, **group}.items():
            n = 20 if name in one else 5
            dev = cs.graph_ms(fn, n, 5 if name in one else 3)
            ev = cs.median_ms(fn, n, 5 if name in one else 3)
            host = cs.host_ms(fn)
            print(f'K5 {name} {tag}: device {dev:.4f} ms, CUDA events '
                  f'{ev:.4f} ms, host {host:.4f} ms a call  [{smi}]',
                  flush=True)
            if name in one:
                for k, ms in sorted(kernels_ms(chip_smoke, fn).items(),
                                    key=lambda kv: -kv[1]):
                    print(f'    {ms:.4f} ms  {k[:100]}')


def main() -> None:
    device, smi = chip_smoke.card()
    print(f'srtpu_torch from {rcab.__file__}')
    k5_times(device, smi)
    engine_times(chip_smoke, device, smi)


if __name__ == '__main__':
    main()
