"""Command line of the port (srtpu/cli.py). Only ``predict`` so far::

    python -m srtpu_torch predict --weights W.pt --model EDSR \\
        --scale_factor 4 --n_feats 64 --n_resblocks 16 \\
        --datasets_dir D --predict_datasets X [Y ...] \\
        --default_root_dir OUT --precision bf16 --device cuda

``--weights`` is a state dict written by ``python -m srtpu_torch.convert``
(or ``torch.save(model.state_dict())``); without it the model is drawn
from ``--seed``. ``--device cuda`` without a card raises: there is no
fallback to the CPU.
"""

from __future__ import annotations

import argparse
import logging
import sys

import torch

from .data import SRData
from .models import create_model
from .train import Trainer, TrainerConfig

_logger = logging.getLogger('srtpu_torch')


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog='python -m srtpu_torch')
    sub = p.add_subparsers(dest='command', required=True)
    pr = sub.add_parser('predict', help='super-resolve predict datasets')
    pr.add_argument('--weights', default=None,
                    help='torch state dict (.pt); default: init from --seed')
    pr.add_argument('--model', default='EDSR')
    pr.add_argument('--scale_factor', type=int, default=4)
    pr.add_argument('--n_feats', type=int, default=64)
    pr.add_argument('--n_resblocks', type=int, default=16)
    pr.add_argument('--datasets_dir', default='datasets')
    pr.add_argument('--predict_datasets', nargs='+', required=True)
    pr.add_argument('--default_root_dir', default='.')
    pr.add_argument('--precision', choices=('bf16', '32'), default='bf16')
    pr.add_argument('--device', default='cuda')
    pr.add_argument('--seed', type=int, default=0)
    return p


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'--device {name}: CUDA is not available '
                           f'(pass --device cpu to run the plain versions)')
    return device


def build_model(args, device: torch.device) -> torch.nn.Module:
    """The model ``predict`` runs: drawn from ``args.seed``, then loaded
    from ``args.weights`` when given."""
    dtype = torch.bfloat16 if args.precision == 'bf16' else None
    model = create_model(args.model, scale_factor=args.scale_factor,
                         n_feats=args.n_feats, n_resblocks=args.n_resblocks,
                         dtype=dtype, device=device,
                         generator=torch.Generator().manual_seed(args.seed))
    if args.weights:
        state = torch.load(args.weights, map_location='cpu',
                           weights_only=True)
        model.load_state_dict(state)
        _logger.info('loaded weights from %s', args.weights)
    else:
        _logger.info('no --weights: parameters initialised from seed %d',
                     args.seed)
    return model.eval()


def cmd_predict(args) -> int:
    device = resolve_device(args.device)
    model = build_model(args, device)
    dm = SRData(datasets_dir=args.datasets_dir,
                predict_datasets=args.predict_datasets,
                scale_factor=args.scale_factor)
    Trainer(TrainerConfig(default_root_dir=args.default_root_dir)) \
        .predict(model, dm)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s %(name)s %(message)s')
    return {'predict': cmd_predict}[args.command](args)


if __name__ == '__main__':
    sys.exit(main())
