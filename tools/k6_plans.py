"""Time K6 (RDN's dense-block trunk) and the engines it runs on, on the card.

For the srtpu_torch of this checkout, or with ``--tree DIR`` of another
(the parent commit unpacked with ``git archive`` into a git-ignored
directory):

- K6 at RDN-B's width (16 blocks of 8 dense layers, G0 = 64) at the
  training shape (batch 16, LR 32x32) and at 1 x 128 x 128: the forward
  over the 16 blocks (saving), one block's chain and its pair weight
  grads, each as device time alone (one CUDA graph of the calls),
  CUDA-event time of back-to-back calls and host time a call, beside
  cuDNN's calls for the same work (``chip_smoke.rdn_reference``);
- the classes of the two engines K6 extends, device time alone at the
  training shape: K2's forward and dx at phase 2k's shapes, at phase
  2f's (DDBPN, the x3 tails) and at K9c's eight dense layers; W at
  chip_smoke's W cases (phase 2l).

To compare two trees on one card, run both in one call, in turns
(parent, this, this, parent). Needs a CUDA card::

    python3 tools/k6_plans.py [--tree DIR]
"""

from __future__ import annotations

import argparse

import torch

from tree_timing import engine_times, load_chip_smoke

ARGS = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ARGS.add_argument('--tree', help="time this checkout's srtpu_torch")
chip_smoke = load_chip_smoke(ARGS.parse_args().tree)
from srtpu_torch.ops import rdn  # noqa: E402


def k6_times(device, smi: str) -> None:
    """K6's three functions and cuDNN's calls for the same work."""
    cs = chip_smoke
    for bsz, h, w in ((cs.TRAIN_BATCH, cs.TRAIN_PATCH // cs.SCALE,
                       cs.TRAIN_PATCH // cs.SCALE), (1, 128, 128)):
        gen = torch.Generator().manual_seed(bsz * 7883 + h * 107 + w)
        args = cs.rdn_case(gen, device, bsz, h, w)
        _, bufs = rdn.rdn_fwd(*args, save=True)
        g = cs._uniform(gen, (bsz, h, w, cs.RDN_G0), 1.0, device,
                        torch.bfloat16)
        ct = cs._uniform(gen, (bsz, h, w, cs.RDN_D * cs.RDN_G0), 1.0,
                         device, torch.bfloat16)
        wtpk = cs.w_t(args[1]).contiguous()
        wft = args[3].transpose(1, 2).contiguous()
        l = cs.RDN_D - 1
        bargs = (bufs, l, g, ct, wtpk, wft)
        dout = rdn.rdb_bwd_chain(*bargs)[1]
        fwd_ref, bwd_ref, dw_ref = cs.rdn_reference(
            bufs[l], args[1][l], args[2][l], args[3][l], args[4][l], g)
        fns = {'fwd (16 blocks, saving)': lambda: rdn.rdn_fwd(*args,
                                                                save=True),
               'fwd (16 blocks, predict: one buffer)':
                   lambda: rdn.rdn_fwd(*args),
               'chain (one block)': lambda: rdn.rdb_bwd_chain(*bargs),
               'pair weight grads (one block)':
                   lambda: rdn.rdb_bwd_dw(bufs, l, dout),
               'cuDNN reference fwd (16 x 8 convs + 1x1)':
                   lambda: [f() for _ in range(cs.RDN_D) for f in fwd_ref],
               'cuDNN reference bwd (one block: 8 convs + 1x1)':
                   lambda: [f() for f in bwd_ref],
               'cuDNN reference dW (one block: 8 conv2d_weight)':
                   lambda: [f() for f in dw_ref]}
        tag = f'{bsz}x{h}x{w}'
        cs._rdn_times(tag, fns, smi)
        del args, bufs, g, ct, wtpk, wft, dout, fwd_ref, bwd_ref, dw_ref
        torch.cuda.empty_cache()


def main() -> None:
    device, smi = chip_smoke.card()
    print(f'srtpu_torch from {rdn.__file__}')
    k6_times(device, smi)
    engine_times(chip_smoke, device, smi)


if __name__ == '__main__':
    main()
