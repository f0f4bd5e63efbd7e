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
import importlib.util
import sys
from pathlib import Path

import torch

ARGS = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ARGS.add_argument('--tree', help="time this checkout's srtpu_torch")
TREE = ARGS.parse_args().tree
ROOT = Path(__file__).resolve().parents[1]
# TREE's srtpu_torch first; chip_smoke always this checkout's
sys.path.insert(0, str(Path(TREE).resolve() if TREE else ROOT))
_spec = importlib.util.spec_from_file_location('chip_smoke',
                                               ROOT / 'chip_smoke.py')
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
from srtpu_torch.ops import conv, rdn, wgrad  # noqa: E402


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


def engine_times(device, smi: str) -> None:
    """Device times of K2's and W's classes at the training shape."""
    cs = chip_smoke
    bsz, lr = cs.TRAIN_BATCH, cs.TRAIN_PATCH // cs.SCALE
    shapes = ([s for v in cs.K2_TRAIN_FWD.values() for s in v]
              + [(k, ci, co, 1) for ci, co, k in cs.K2G_SHAPES]
              + [(3, cs.RDN_G0 * i, cs.RDN_G0, 1) for i in range(1, 9)])
    total = [0.0, 0.0]
    for k, cin, cout, m in shapes:
        hh = lr * m
        gen = torch.Generator().manual_seed(k * 100003 + cin * 101 + cout)
        x = cs._uniform(gen, (bsz, hh, hh, cin), 1.0, device, torch.bfloat16)
        wt = cs._uniform(gen, (k, k, cin, cout), (k * k * cin) ** -0.5,
                         device, torch.bfloat16)
        b = cs._uniform(gen, (cout,), 0.1, device, torch.float32)
        gg = cs._uniform(gen, (bsz, hh, hh, cout), 1.0, device,
                         torch.bfloat16)
        fwd = cs.graph_ms(lambda: conv.conv3x3_fwd(x, wt, b))
        dx = cs.graph_ms(lambda: conv.conv3x3_dx(gg, wt))
        total[0] += fwd
        total[1] += dx
        print(f'K2 {k}x{k} {cin}->{cout} {bsz}x{hh}x{hh}: device fwd '
              f'{fwd:.4f} ms, dx {dx:.4f} ms  [{smi}]', flush=True)
    print(f'K2 classes summed: device fwd {total[0]:.4f} ms, dx '
          f'{total[1]:.4f} ms  [{smi}]')
    w_total = 0.0
    for label, k, cin, cout, r, rf, gs, jobs, x, g in cs.w_cases(
            device, bsz, lr, lr):
        ms = cs.graph_ms(lambda: wgrad.conv_wgrad(x, g, gs, r, k, rf))
        w_total += ms
        print(f'W {label}: device {ms:.4f} ms  [{smi}]', flush=True)
    print(f'W classes summed: device {w_total:.4f} ms  [{smi}]')


def main() -> None:
    device, smi = chip_smoke.card()
    print(f'srtpu_torch from {rdn.__file__}')
    k6_times(device, smi)
    engine_times(device, smi)


if __name__ == '__main__':
    main()
