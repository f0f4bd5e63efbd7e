"""Interleaved A/B of srtpu_torch between two source trees on one card:
train-step and predict times of the models chip_smoke.py runs.

    python tools/ab_torch_step.py TREE_A TREE_B [--models EDSR,DDBPN]
                                  [--losses 'l1;lpips'] [--rounds 2]

``--models`` names keys of MODELS: a model, EDSR86 (EDSR x4 at 64
features, 86 resblocks, res_scale 0.1), WDSR_STOCK (WDSR-B at 128
features, 16 blocks, on its default stock route, no kernel in the
trunk), SRGAN_CS (SRGAN x4 at srtpu's sizes on its kernel route 'cs':
the adversarial step, D then G with the VGG19 relu5_4 term, K4r in the
generator's trunk), RCAN_TRUE (RCAN-10x16 on srtpu's use_pallas=True
route: K8b per RCAB, the rest stock) or EDSR_TRUE (EDSR-baseline on that
route: K8a's trunk op forward, the rest stock).

TREE_A and TREE_B are checkouts of this repository (for example the
parent commit unpacked with ``git archive`` into a git-ignored directory,
and ``.``). Each (tree, model) runs in a process of its own that imports
srtpu_torch from that tree (its kernels build into that tree's
``build/``), draws the model from seed 0 at chip_smoke.py's
configuration, and times, with CUDA events, the train step (batch 16, LR
32x32, x4, bf16, Adam at lr 1e-4; 5 steps a window, the median of 3
windows) and one predict forward of an LR 128x128 image (the median of
5), on random inputs; it prints one JSON line. The step's loss is each
DSL of ``--losses`` (``;`` between them; default ``l1``) in turn, a
process for each; a DSL with a trainable loss needs a tree whose
``TrainState`` has ``create``. Each round runs A, B, B, A, so a drift of
the card or its host falls on both trees alike. The last lines are a
table of every run and the medians per tree, model and DSL, with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# chip_smoke.py's model flags (srtpu's bench rows)
MODELS = {
    'EDSR': [],
    'RCAN': ['--n_resgroups', '10', '--n_resblocks', '16', '--reduction',
             '16'],
    'SRResNet': [],
    'RDN': ['--rdn_config', 'B', '--growth0', '64'],
    'DDBPN': ['--n0', '128', '--nr', '32', '--depth', '6'],
    'WDSR': ['--n_feats', '128', '--n_resblocks', '16', '--use_pallas',
             'cs'],
    # chip_smoke's phase 22: EDSR x4 at 64 features and 86 resblocks
    'EDSR86': ['--n_resblocks', '86', '--res_scale', '0.1'],
    # WDSR-B's stock route (use_pallas False, srtpu's default)
    'WDSR_STOCK': ['--n_feats', '128', '--n_resblocks', '16'],
    # chip_smoke's phase 18: SRGAN x4 on srtpu's kernel route
    'SRGAN_CS': ['--ngf', '64', '--ndf', '64', '--n_blocks', '16',
                 '--use_pallas', 'cs'],
    # chip_smoke's phase 20: RCAN-10x16 on srtpu's use_pallas=True route
    'RCAN_TRUE': ['--n_resgroups', '10', '--n_resblocks', '16',
                  '--reduction', '16', '--use_pallas', 'true'],
    # chip_smoke's phase 19: EDSR-baseline on the use_pallas=True route
    'EDSR_TRUE': ['--use_pallas', 'true'],
}
# a configuration's model, where it differs
MODEL_OF = {'EDSR86': 'EDSR', 'WDSR_STOCK': 'WDSR', 'SRGAN_CS': 'SRGAN',
            'RCAN_TRUE': 'RCAN', 'EDSR_TRUE': 'EDSR'}


def median_ms(fn, calls: int, windows: int) -> float:
    import numpy as np
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def worker(tree: str, model: str, losses: str = 'l1') -> None:
    """Time one model on the DSL ``losses`` from ``tree`` and print one
    JSON line."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch
    from srtpu_torch import cli
    from srtpu_torch.losses import parse_losses
    from srtpu_torch.optim import build_optimizer
    from srtpu_torch.train import TrainState, make_train_step

    device = torch.device('cuda', 0)
    argv = ['fit', '--model', MODEL_OF.get(model, model), '--scale_factor',
            '4', '--precision', 'bf16', '--device', 'cuda', '--seed', '0',
            '--train_datasets', 'Train', *MODELS[model]]
    net = cli.build_model(cli.build_parser().parse_args(argv), device)
    gen = torch.Generator().manual_seed(0)
    lr = torch.rand((16, 32, 32, 3), generator=gen).to(device)
    hr = torch.rand((16, 128, 128, 3), generator=gen).to(device)
    if MODEL_OF.get(model, model) == 'SRGAN':
        # the adversarial step (D then G, VGG19 relu5_4), as fit runs it
        from srtpu_torch.losses import VGGLoss
        from srtpu_torch.train import create_gan_state, make_gan_train_step
        net.train()
        step = make_gan_train_step(vgg_loss=VGGLoss(device=device))
        state = create_gan_state(net, 1e-4)
    else:
        composite = parse_losses(losses)
        step = make_train_step(composite)
        if hasattr(TrainState, 'create'):
            state = TrainState.create(net, composite, 'ADAM', ['lr=1e-4'])
        else:
            state = TrainState(net, build_optimizer('ADAM', ['lr=1e-4'],
                                                    net.parameters()))
    step_ms = median_ms(lambda: step(state, lr, hr), 5, 3)
    net.eval()
    image = torch.rand((1, 128, 128, 3), generator=gen).to(device)
    with torch.no_grad():
        predict_ms = median_ms(lambda: net(image), 1, 5)
    import srtpu_torch
    print(json.dumps({'tree': tree, 'model': model, 'losses': losses,
                      'step_ms': step_ms,
                      'predict_ms': predict_ms,
                      'package': str(Path(srtpu_torch.__file__).parent)}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('trees', nargs='*')
    ap.add_argument('--models', default='EDSR,DDBPN')
    ap.add_argument('--losses', default='l1')
    ap.add_argument('--rounds', type=int, default=2)
    ap.add_argument('--worker', nargs=3, metavar=('TREE', 'MODEL', 'LOSSES'))
    args = ap.parse_args()
    if args.worker:
        worker(*args.worker)
        return
    if len(args.trees) != 2:
        ap.error('give two trees')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    a, b = args.trees
    rows = []
    cases = [(m, dsl) for m in args.models.split(',')
             for dsl in args.losses.split(';')]
    for model, dsl in cases:
        for _ in range(args.rounds):
            for tree in (a, b, b, a):
                proc = subprocess.run(
                    [sys.executable, __file__, '--worker', tree, model, dsl],
                    capture_output=True, text=True)
                if proc.returncode:
                    raise SystemExit(f'{tree} {model} {dsl}: '
                                     f'{proc.stderr[-4000:]}')
                row = json.loads(proc.stdout.strip().splitlines()[-1])
                print(json.dumps(row), flush=True)
                rows.append(row)
    import numpy as np
    print(f'card: {smi}')
    for model, dsl in cases:
        for tree in (a, b):
            got = [r for r in rows if r['model'] == model
                   and r['losses'] == dsl and r['tree'] == tree]
            print(f'{model} {dsl!r} {tree}: step ms '
                  + ' '.join(f'{r["step_ms"]:.3f}' for r in got)
                  + f' (median {np.median([r["step_ms"] for r in got]):.3f})'
                  '; predict LR 128x128 ms '
                  + ' '.join(f'{r["predict_ms"]:.3f}' for r in got)
                  + f' (median '
                  f'{np.median([r["predict_ms"] for r in got]):.3f})')


if __name__ == '__main__':
    main()
