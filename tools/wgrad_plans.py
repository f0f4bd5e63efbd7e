"""Time the weight-grad engine's split of the pixels on the card.

For each of chip_smoke's W classes (``chip_smoke.W_CASES``) at the
training shape (batch 16, LR 32x32 times the class's multiple), the
device time alone (one CUDA graph of 20 calls: without the wrapper's
host time, which chip_smoke's back-to-back calls include) of the split
``ops.wgrad.wgrad_parts`` picks and of every split (cluster,
clusters) of up to ``wgrad.MAX_WAVES`` waves with clusters among 1, 2, 3,
4, 6, 8, 12, 16, 24, 32, 48, 64 and as many as one wave holds, and of
``torch.nn.grad.conv2d_weight`` (cuDNN's heuristics) where one call
computes the same function. Prints each class's pick, its fastest split
and the library's time, then every split's time, and the sums over the
classes: the
measurements the plan model's constants (``wgrad.TILE_US``,
``wgrad.SLOT_BYTES_PER_US``) are fitted to. With ``--tree DIR``, the
srtpu_torch of another checkout (the parent commit unpacked with ``git
archive``) at its own split only, its device and CUDA-event times: the
classes' times before. Needs a CUDA card::

    python3 tools/wgrad_plans.py [--tree DIR]
"""

from __future__ import annotations

import argparse

import torch

from tree_timing import load_chip_smoke

ARGS = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ARGS.add_argument('--tree', help='time this checkout\'s srtpu_torch, at '
                  'its own split')
TREE = ARGS.parse_args().tree
chip_smoke = load_chip_smoke(TREE)
from srtpu_torch.ops import wgrad  # noqa: E402

COUNTS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64)
graph_ms = chip_smoke.graph_ms


def splits(tiles: int, base: int):
    """Every (cluster, clusters) of up to MAX_WAVES waves."""
    for cluster, at_once in wgrad.CLUSTERS_AT_ONCE.items():
        for clusters in sorted(set(COUNTS) | {at_once // base} - {0}):
            waves = -(-base * clusters // at_once)
            if cluster * clusters <= tiles and waves <= wgrad.MAX_WAVES:
                yield cluster, clusters


def times_of_tree(device, smi: str) -> None:
    """Each class on TREE's srtpu_torch at its own split: device and
    CUDA-event ms."""
    print(f'srtpu_torch from {wgrad.__file__}')
    bsz, lr = chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_PATCH // chip_smoke.SCALE
    for label, k, cin, cout, r, rf, gs, jobs, x, g in chip_smoke.w_cases(
            device, bsz, lr, lr):
        run = lambda: wgrad.conv_wgrad(x, g, gs, r, k, rf)
        print(f'{label}: device {graph_ms(run):.4f} ms, CUDA events '
              f'{chip_smoke.median_ms(run):.4f} ms  [{smi}]', flush=True)


def main() -> None:
    device, smi = chip_smoke.card()
    if TREE:
        times_of_tree(device, smi)
        return
    parts = wgrad.wgrad_parts
    bsz, lr = chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_PATCH // chip_smoke.SCALE
    total_pick = total_best = 0.0
    try:
        for label, k, cin, cout, r, rf, gs, jobs, x, g in chip_smoke.w_cases(
                device, bsz, lr, lr):
            h, w = x.shape[-3], x.shape[-2]
            pick = parts(bsz, h, w, cin, cout, r, k, jobs)
            tiles = bsz * -(-h // wgrad.TH) * -(-w // wgrad.TW)
            base = jobs * wgrad.geometry(cin, cout, r, k)['blocks']
            times = {}
            for split in {pick, *splits(tiles, base)}:
                wgrad.wgrad_parts = lambda *a, s=split, **kw: s
                times[split] = graph_ms(
                    lambda: wgrad.conv_wgrad(x, g, gs, r, k, rf))
            best = min(times, key=times.get)
            total_pick += times[pick]
            total_best += times[best]
            lib = ''
            if r == 1 and not rf:
                lead = (lambda t: t) if jobs > 1 else (lambda t: t[None])
                lib_dev = graph_ms(chip_smoke.lib_wgrad(lead(x), lead(g), k))
                lib = f', conv2d_weight {lib_dev:.4f} ms'
            print(f'{label}: pick {pick} {times[pick]:.4f} ms, fastest '
                  f'{best} {times[best]:.4f} ms, {len(times)} splits{lib}  '
                  f'[{smi}]', flush=True)
            print('  every split: ' + ' '.join(
                f'{c},{n}:{t:.4f}' for (c, n), t in sorted(times.items())))
            del x, g
            torch.cuda.empty_cache()
    finally:
        wgrad.wgrad_parts = parts
    print(f'sum over the classes: picks {total_pick:.4f} ms, fastest '
          f'{total_best:.4f} ms  [{smi}]')


if __name__ == '__main__':
    main()
