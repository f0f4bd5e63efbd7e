"""Interleaved A/B of ``python -m srtpu_torch fit`` between two source
trees on one card: the steady-state rate of EDSR-baseline x4 at the bench
recipe, fed by each tree's training loader.

    python tools/ab_fit_feed.py TREE_A TREE_B [--ks 1,4] [--rounds 1]
                                [--images 800] [--epochs 3]

The training set is chip_smoke.py phase 31's: ``--images`` HR images of
256x256 and their box-filtered LR at 64x64 (``LR/X4``), uint8 ``.npy``
drawn from seed 0, written once into a temporary directory. Each (tree,
k) is a ``fit`` process of its own that imports srtpu_torch from that
tree (its kernels build into that tree's ``build/``): batch 16, patch
128, x4, bf16, L1, Adam at lr 1e-4, ``--epochs`` epochs at
``--steps_per_execution k``, on the card, with each tree's loader at its
defaults. The rate is the mean of the per-epoch ``items/s`` that
``run.log`` reports for every epoch after the first (the first fills the
RAM cache and, at k > 1, captures the graph); a step is 16 items. Each
round runs A, B, B, A. The last lines are a table of every run and the
medians per tree and k, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

BATCH = 16
EPOCH_LINE = re.compile(r'epoch (\d+)/(\d+) .* ([0-9.]+) items/s$')


def make_data(root: Path, images: int) -> Path:
    rng = np.random.default_rng(0)
    hr_dir = root / 'Train' / 'HR'
    lr_dir = root / 'Train' / 'LR' / 'X4'
    hr_dir.mkdir(parents=True)
    lr_dir.mkdir(parents=True)
    for i in range(images):
        hr = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
        lr = hr.reshape(64, 4, 64, 4, 3).mean((1, 3))
        np.save(hr_dir / f'{i:03d}.npy', hr)
        np.save(lr_dir / f'{i:03d}.npy', (lr + 0.5).astype(np.uint8))
    return root


def run_fit(tree: Path, data: Path, out: Path, k: int, epochs: int) -> list:
    """One fit in a process of its own: its epochs' items/s."""
    argv = [sys.executable, '-m', 'srtpu_torch', 'fit', '--datasets_dir',
            str(data), '--train_datasets', 'Train', '--batch_size',
            str(BATCH), '--patch_size', '128', '--scale_factor', '4',
            '--n_feats', '64', '--n_resblocks', '16', '--losses', 'l1',
            '--optimizer', 'ADAM', '--optimizer_params', 'lr=1e-4',
            '--max_epochs', str(epochs), '--num_sanity_val_steps', '0',
            '--precision', 'bf16', '--device', 'cuda', '--seed', '0',
            '--steps_per_execution', str(k), '--default_root_dir', str(out)]
    subprocess.run(argv, cwd=tree, check=True, stdout=subprocess.DEVNULL,
                   stderr=subprocess.DEVNULL, timeout=1200)
    rates = []
    for line in (out / 'run.log').read_text().splitlines():
        m = EPOCH_LINE.search(line)
        if m:
            rates.append(float(m.group(3)))
    if len(rates) != epochs:
        raise RuntimeError(f'{out / "run.log"}: {len(rates)} epoch lines, '
                           f'expected {epochs}')
    return rates


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('tree_a', type=Path)
    ap.add_argument('tree_b', type=Path)
    ap.add_argument('--ks', default='1,4')
    ap.add_argument('--rounds', type=int, default=1)
    ap.add_argument('--images', type=int, default=800)
    ap.add_argument('--epochs', type=int, default=3)
    args = ap.parse_args()
    if args.epochs < 2:
        raise SystemExit('--epochs must be at least 2 (the first is warm-up)')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    trees = {'A': args.tree_a.resolve(), 'B': args.tree_b.resolve()}
    ks = [int(k) for k in args.ks.split(',')]
    runs = []
    with tempfile.TemporaryDirectory(prefix='srtpu_ab_feed_') as tmp:
        tmp = Path(tmp)
        data = make_data(tmp / 'datasets', args.images)
        n = 0
        for _ in range(args.rounds):
            for label in 'ABBA':
                for k in ks:
                    rates = run_fit(trees[label], data, tmp / f'run{n}', k,
                                    args.epochs)
                    n += 1
                    steady = statistics.mean(rates[1:])
                    runs.append((label, k, steady, rates))
                    print(f'{label} k {k}: epochs 2-{args.epochs} '
                          f'{steady:.1f} patches/s, '
                          f'{BATCH * 1e3 / steady:.3f} ms a step; epoch '
                          f'items/s {rates}', flush=True)
    print(f'A = {trees["A"]}, B = {trees["B"]}; {args.images} images, '
          f'{args.epochs} epochs; [{smi}]')
    for k in ks:
        for label in 'AB':
            vals = [r[2] for r in runs if r[0] == label and r[1] == k]
            med = statistics.median(vals)
            print(f'median {label} k {k}: {med:.1f} patches/s, '
                  f'{BATCH * 1e3 / med:.3f} ms a step over {len(vals)} runs')


if __name__ == '__main__':
    main()
