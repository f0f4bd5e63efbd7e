"""Command line of the port (srtpu/cli.py): ``fit``, ``validate`` and
``predict``::

    python -m srtpu_torch fit --datasets_dir D --train_datasets T [U ...] \\
        --model EDSR --scale_factor 4 --n_feats 64 --n_resblocks 16 \\
        --batch_size 16 --patch_size 128 --losses l1 --optimizer ADAM \\
        --optimizer_params lr=1e-4 --max_epochs 20 --precision bf16 \\
        --device cuda --seed 42 --default_root_dir OUT

    python -m srtpu_torch predict --weights W.pt --model EDSR \\
        --scale_factor 4 --n_feats 64 --n_resblocks 16 \\
        --datasets_dir D --predict_datasets X [Y ...] \\
        --default_root_dir OUT --precision bf16 --device cuda

    python -m srtpu_torch validate --weights W.pt --model EDSR \\
        --datasets_dir D --eval_datasets V [U ...] \\
        --metrics PSNR SSIM MS-SSIM --device cuda

The flags are srtpu's config keys; the defaults follow
``srtpu/config.py``. A model's own flags (``--n_feats``,
``--n_resblocks`` and those below) are passed only when given, so a model
takes its own defaults for the rest, as srtpu's CLI builds a model from
its config's ``init_args`` alone. ``--use_pallas`` (``false``, ``true``
or ``cs``) picks srtpu's route for EDSR, RCAN and WDSR, on one set of
parameters: EDSR and RCAN default to ``cs`` (K1-K3 / K5 and K2);
``true`` runs srtpu's fused NHWC forms, K8a per EDSR block, K8b per
RCAN gate and K8c per WDSR-B block, their other convs stock; ``false``
runs every conv stock (cuDNN on the card). On CUDA a width a K8 kernel
does not take raises at the first forward, naming ROADMAP.md F4 (K8a 64
channels; K8b a multiple of 8; K8c a multiple of 16 up to 128).
``fit`` draws the model and the
loader's stream from ``--seed``, logs to ``<default_root_dir>/run.log``
and writes the final weights to ``<default_root_dir>/final_weights.pt``,
which ``predict --weights`` reads (as does ``python -m
srtpu_torch.convert``'s output).
``--model RCAN`` adds ``--n_resgroups`` (default 10) and
``--reduction`` (default 16), srtpu's RCAN keys; ``--model SRResNet``
takes ``--n_feats``, ``--n_resblocks`` and ``--scale_factor``; ``--model
RDN`` takes ``--rdn_config`` (default B: 16 blocks of 8 layers, growth
64) and ``--growth0`` (default 64), srtpu's RDN keys; ``--model DDBPN``
takes ``--n0`` (default 128), ``--nr`` (default 32) and ``--depth``
(default 6), the DDBPN fields of srtpu's config; ``--model WDSR`` takes
``--block_type`` (A or B, default B), ``--n_feats`` (default 128),
``--n_resblocks`` (default 16), ``--res_scale`` (default 1.0) and
``--use_pallas`` (``false``, the default: stock weight-normed convs,
cuDNN on the card; ``cs``: K7 runs each B block; ``true``: K8c runs each
B block), srtpu's WDSR keys; ``--model
SRGAN`` takes ``--ngf``, ``--ndf`` (default 64 each), ``--n_blocks``
(default 16) and ``--use_pallas`` (accepted for srtpu's trees; the
card's train mode runs K4r whatever it says), and ``fit`` trains it
adversarially (its ``--losses`` and ``--optimizer`` are ignored, the lr
of ``--optimizer_params`` taken, as srtpu's); a model ignores the flags
it does not declare. ``--model SRCNN`` takes ``--scale_factor`` alone.
``fit`` trains in train mode (SRResNet's batch norm on batch statistics, updating its
running ones) and ``predict`` and ``validate`` run eval mode;
``final_weights.pt`` holds the running statistics, so ``--weights``
reads what ``fit`` left. ``validate`` scores the eval datasets
(``<datasets_dir>/<name>/HR`` with ``LR/X{scale}``) with ``--metrics``
(srtpu's names; PSNR, SSIM and MS-SSIM are ported) and prints ``key:
value`` lines, sorted. ``--eval_tile`` (default 0: the direct
full-image forward; srtpu's TPU default is 80) and
``--eval_tile_overlap`` (8) route large images of a ``'cs'`` model
without global pooling through the tiled eval and predict steps;
``predict --predict_tile`` (0: off) and ``--predict_tile_overlap`` (32)
take srtpu's host tiles. ``fit`` runs no validation and writes no
checkpoints yet (ROADMAP.md queue 1, item 7). ``--device cuda``
without a card raises: there is no fallback to the CPU. On the card
``--precision 32`` raises (the kernels take bf16), and so does DDBPN x8,
which srtpu runs on XLA rather than its kernel path (ROADMAP.md §3, F4;
each model's ``CARD_SCALES``).
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

import torch

from .data import SRData
from .models import create_model, model_class
from .train import Trainer, TrainerConfig

_logger = logging.getLogger('srtpu_torch')


def _use_pallas(value: str):
    """srtpu's ``use_pallas`` from the flag: false, true or cs."""
    routes = {'false': False, 'true': True, 'cs': 'cs'}
    if value.lower() not in routes:
        raise argparse.ArgumentTypeError(
            f'--use_pallas takes false, true or cs, not {value!r}')
    return routes[value.lower()]


# the model's own keys (srtpu's init_args): a flag the caller does not
# give is not passed, so the model takes its own default, as srtpu builds
# a model from its config's init_args alone (srtpu/cli.py:194)
MODEL_FLAGS = {'n_feats': int, 'n_resblocks': int, 'n_resgroups': int,
               'reduction': int, 'rdn_config': str, 'growth0': int,
               'n0': int, 'nr': int, 'depth': int, 'block_type': str,
               'res_scale': float, 'use_pallas': _use_pallas, 'ngf': int,
               'ndf': int, 'n_blocks': int}


def _model_args(p: argparse.ArgumentParser, seed: int) -> None:
    p.add_argument('--model', default='EDSR')
    p.add_argument('--scale_factor', type=int, default=4)
    for name, kind in MODEL_FLAGS.items():
        p.add_argument(f'--{name}', type=kind, default=argparse.SUPPRESS)
    p.add_argument('--datasets_dir', default='datasets')
    p.add_argument('--default_root_dir', default='.')
    p.add_argument('--precision', choices=('bf16', '32'), default='bf16')
    p.add_argument('--device', default='cuda')
    p.add_argument('--seed', type=int, default=seed)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog='python -m srtpu_torch')
    sub = p.add_subparsers(dest='command', required=True)
    fit = sub.add_parser('fit', help='train a model on train datasets')
    _model_args(fit, seed=42)
    fit.add_argument('--train_datasets', nargs='+', required=True)
    fit.add_argument('--batch_size', type=int, default=16)
    fit.add_argument('--patch_size', type=int, default=128)
    fit.add_argument('--losses', default='l1')
    fit.add_argument('--optimizer', default='ADAM')
    fit.add_argument('--optimizer_params', nargs='*', default=[])
    fit.add_argument('--max_epochs', type=int, default=2000)
    fit.add_argument('--limit_train_batches', type=int, default=None)
    pr = sub.add_parser('predict', help='super-resolve predict datasets')
    _model_args(pr, seed=0)
    pr.add_argument('--weights', default=None,
                    help='torch state dict (.pt); default: init from --seed')
    pr.add_argument('--predict_datasets', nargs='+', required=True)
    pr.add_argument('--predict_tile', type=int, default=0)
    pr.add_argument('--predict_tile_overlap', type=int, default=32)
    _tile_args(pr)
    val = sub.add_parser('validate', help='score eval datasets')
    _model_args(val, seed=0)
    val.add_argument('--weights', default=None,
                     help='torch state dict (.pt); default: init from --seed')
    val.add_argument('--eval_datasets', nargs='+', required=True)
    val.add_argument('--metrics', nargs='+', default=['PSNR', 'SSIM'])
    _tile_args(val)
    return p


def _tile_args(p: argparse.ArgumentParser) -> None:
    p.add_argument('--eval_tile', type=int, default=0,
                   help="LR tile of the tiled steps; 0: direct forward")
    p.add_argument('--eval_tile_overlap', type=int, default=8)


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'--device {name}: CUDA is not available '
                           f'(pass --device cpu to run the plain versions)')
    return device


def build_model(args, device: torch.device) -> torch.nn.Module:
    """The model drawn from ``args.seed``, then loaded from
    ``args.weights`` when given."""
    scales = model_class(args.model).CARD_SCALES
    if device.type == 'cuda' and (args.precision != 'bf16'
                                  or args.scale_factor not in scales):
        raise ValueError(
            f'on CUDA the kernels take bf16 and {args.model} runs scales '
            f'{", ".join(map(str, scales))}: pass --precision bf16 and one '
            f'of those scales (or --device cpu); the others have no kernel '
            f'path yet (ROADMAP.md F4)')
    dtype = torch.bfloat16 if args.precision == 'bf16' else None
    given = {k: getattr(args, k) for k in MODEL_FLAGS if hasattr(args, k)}
    model = create_model(args.model, scale_factor=args.scale_factor,
                         dtype=dtype, device=device,
                         generator=torch.Generator().manual_seed(args.seed),
                         **given)
    weights = getattr(args, 'weights', None)
    if weights:
        state = torch.load(weights, map_location='cpu', weights_only=True)
        model.load_state_dict(state)
        _logger.info('loaded weights from %s', weights)
    else:
        _logger.info('no --weights: parameters initialised from seed %d',
                     args.seed)
    return model


def cmd_fit(args) -> int:
    device = resolve_device(args.device)
    model = build_model(args, device)
    root = Path(args.default_root_dir)
    root.mkdir(parents=True, exist_ok=True)
    log = logging.FileHandler(root / 'run.log')
    log.setFormatter(logging.Formatter('%(asctime)s %(name)s %(message)s'))
    _logger.addHandler(log)
    try:
        dm = SRData(datasets_dir=args.datasets_dir,
                    train_datasets=args.train_datasets,
                    batch_size=args.batch_size, patch_size=args.patch_size,
                    scale_factor=args.scale_factor, seed=args.seed)
        trainer = Trainer(TrainerConfig(
            default_root_dir=str(root), max_epochs=args.max_epochs,
            limit_train_batches=args.limit_train_batches))
        trainer.fit(model, dm, losses=args.losses,
                    optimizer_name=args.optimizer,
                    optimizer_params=args.optimizer_params)
        torch.save(model.state_dict(), root / 'final_weights.pt')
        _logger.info('fit done: %d steps; weights at %s', trainer.global_step,
                     root / 'final_weights.pt')
    finally:
        _logger.removeHandler(log)
        log.close()
    return 0


def cmd_predict(args) -> int:
    device = resolve_device(args.device)
    model = build_model(args, device).eval()
    dm = SRData(datasets_dir=args.datasets_dir,
                predict_datasets=args.predict_datasets,
                scale_factor=args.scale_factor)
    Trainer(TrainerConfig(
        default_root_dir=args.default_root_dir,
        predict_tile=args.predict_tile,
        predict_tile_overlap=args.predict_tile_overlap,
        eval_tile=args.eval_tile,
        eval_tile_overlap=args.eval_tile_overlap)).predict(model, dm)
    return 0


def cmd_validate(args) -> int:
    device = resolve_device(args.device)
    model = build_model(args, device).eval()
    dm = SRData(datasets_dir=args.datasets_dir,
                eval_datasets=args.eval_datasets,
                scale_factor=args.scale_factor)
    metrics = Trainer(TrainerConfig(
        default_root_dir=args.default_root_dir, metrics=tuple(args.metrics),
        eval_tile=args.eval_tile,
        eval_tile_overlap=args.eval_tile_overlap)).validate(model, dm)
    for k, v in sorted(metrics.items()):
        print(f'{k}: {v:.4f}')
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(format='%(asctime)s %(name)s %(message)s')
    _logger.setLevel(logging.INFO)
    return {'fit': cmd_fit, 'predict': cmd_predict,
            'validate': cmd_validate}[args.command](args)


if __name__ == '__main__':
    sys.exit(main())
