"""Time K9d (the fused EDSR resblock backward) on the card.

For the srtpu_torch of this checkout, or with ``--tree DIR`` of another
(the parent commit unpacked with ``git archive`` into a git-ignored
directory), at 64 channels:

- first, the classes of K2's and W's engines and of the kernels sharing
  K2's engine, K5's and K6's (``tree_timing.engine_times``,
  ``epilogue_times``), and K1's, K4's, K7's and K8a's 16-block trunks
  (``trunk_times``), which a new epilogue must leave level;
- K9d (``resblock_bwd_fused``) at the training shape (batch 16, LR
  32x32), res_scale 1.0 and 0.1, from the h1 K8a's forward saves: the
  device time of a call alone (one CUDA graph of the calls), its
  CUDA-event time back to back and its host time a call; each kernel's
  device time in a call (``torch.profiler``);
- beside it, cuDNN's calls for the same work: the True route's stock f32
  backward (``resblock_fused_bwd``) and the bf16 form of its two
  ``aten.convolution_backward`` calls (``chip_smoke.k9d_reference``: gs
  and dh1 rounded, so a reference, not the same function);

each with the card's name and power limit. To compare two trees on one
card, run both in one call, in turns (parent, this, this, parent).
Needs a CUDA card::

    python3 tools/k9d_plans.py [--tree DIR]
"""

from __future__ import annotations

import argparse
import importlib

import torch

from tree_timing import (engine_times, epilogue_times, kernels_ms,
                         load_chip_smoke, trunk_times)

ARGS = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ARGS.add_argument('--tree', help="time this checkout's srtpu_torch")
chip_smoke = load_chip_smoke(ARGS.parse_args().tree)
k8a = importlib.import_module('srtpu_torch.ops.resblock')

SHAPE = (16, 32, 32)     # EDSR True's training shape: batch 16, LR 32x32


def k9d_times(device, smi: str) -> None:
    cs = chip_smoke
    bsz, h, w = SHAPE
    bf = torch.bfloat16
    for rs in cs.K9D_SCALES:
        gen = torch.Generator().manual_seed(9049 + int(rs * 10))
        a = cs.k8_cases(gen, device, bsz, h, w)['K8a'][2][:5]
        _, h1 = k8a.resblock_fused_fwd(*a, rs, save_h1=True)
        args = (a[0], h1, cs._uniform(gen, (bsz, h, w, cs.C), 1.0, device,
                                      bf), a[1], a[3], rs)
        tag = f'K9d {bsz}x{h}x{w} res_scale {rs}'

        def call():
            return k8a.resblock_bwd_fused(*args)
        dev = cs.graph_ms(call, 10, 3)
        event = cs.median_ms(call)
        host = cs.host_ms(call)
        print(f'{tag}: device {dev:.4f} ms, CUDA events {event:.4f} ms, '
              f'host {host:.4f} ms a call  [{smi}]', flush=True)
        parts = kernels_ms(cs, call)
        print(f'{tag} device ms by kernel (torch.profiler): ' + '; '.join(
            f'{k[:70]} {v:.4f}' for k, v in sorted(
                parts.items(), key=lambda kv: -kv[1])), flush=True)
        stock = lambda: k8a.resblock_fused_bwd(*args)  # noqa: E731
        ref = cs.k9d_reference(*args)
        for name, fn in (('stock f32 backward (resblock_fused_bwd)', stock),
                         ('bf16 cuDNN (two convolution_backward)', ref)):
            print(f'{tag} reference, {name}: device '
                  f'{cs.graph_ms(fn, 10, 3):.4f} ms, CUDA events '
                  f'{cs.median_ms(fn, 10, 3):.4f} ms  [{smi}]', flush=True)
        del a, h1, args
        torch.cuda.empty_cache()


def main() -> None:
    device, smi = chip_smoke.card()
    print(f'srtpu_torch from {k8a.__file__}')
    # the engines' classes and the other trunks first (timed after a
    # memory-heavy trunk they read 1-3% slow, their code unchanged)
    engine_times(chip_smoke, device, smi)
    epilogue_times(chip_smoke, device, smi)
    trunk_times(chip_smoke, device, smi)
    k9d_times(device, smi)


if __name__ == '__main__':
    main()
