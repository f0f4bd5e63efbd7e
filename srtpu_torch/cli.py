"""Command line of the port (srtpu/cli.py): ``fit``, ``validate``,
``predict`` and ``export``::

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

    python -m srtpu_torch fit ... --eval_datasets V \\
        --check_val_every_n_epoch 1 --save_top_k 2 [--ckpt_path last]
    python -m srtpu_torch fit --config configs/train_default_sr.yml \\
        [key=value ...] --device cuda
    python -m srtpu_torch validate --checkpoint OUT/checkpoints
    python -m srtpu_torch predict --checkpoint OUT/checkpoints \\
        --predict_datasets X
    python -m srtpu_torch export --checkpoint OUT/checkpoints \\
        --out model.pt2 --size 128x128 [--tile 80] [--mlir graph.txt]

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
(srtpu's six: BRISQUE, scored again on each image's true shape, FLIP,
LPIPS, MS-SSIM, PSNR, SSIM) and prints ``key: value`` lines, sorted.
``fit --losses`` takes srtpu's DSL over its twelve losses (``"0.5 * l1
+ 0.5 * adaptive"``; the adaptive loss's parameters train and
checkpoint with the model). ``--eval_tile`` (default 0: the direct
full-image forward; srtpu's TPU default is 80) and
``--eval_tile_overlap`` (8) route large images of a ``'cs'`` model
without global pooling through the tiled eval and predict steps;
``predict --predict_tile`` (0: off) and ``--predict_tile_overlap`` (32)
take srtpu's host tiles. ``--device cuda``
without a card raises: there is no fallback to the CPU. On the card
``--precision 32`` raises where the route reaches a kernel (the kernels
take bf16; each model class's ``reaches_kernel`` says where: SRCNN,
the ``use_pallas=false`` routes of every family, SRResNet's, RDN's,
DDBPN's and SRGAN's ``true`` routes, RDN's configs its kernels do not
take and DDBPN x8 take f32), and so does a scale outside the model's
``CARD_SCALES`` (ROADMAP.md §3, F4). ``--precision`` takes srtpu's
spellings: ``bf16``,
``bfloat16`` and ``16`` (bf16 compute on f32 parameters) and ``32``.

``fit`` validates on ``--eval_datasets`` every
``--check_val_every_n_epoch`` epochs (capped at ``--max_epochs``, as
srtpu links it) and after the last, with a sanity pass of
``--num_sanity_val_steps`` images first, scores with ``--metrics``
(the val line shows ``--metrics_for_pbar``'s), keeps the
``--save_top_k`` best epochs on ``--monitor`` (default the first eval
dataset's first metric) and ``last`` in ``<default_root_dir>/checkpoints``
with ``hparams.json``, srtpu's snapshot from which ``validate
--checkpoint DIR`` and ``predict --checkpoint DIR`` rebuild the model
(``data.<key>=<value>`` arguments override its data keys); it writes
``metrics.jsonl``. ``--ckpt_path last`` (or a
checkpoints directory) resumes a run; a crash saves ``last`` first.
``--save_results`` / ``--save_results_from_epoch`` write val images,
``--limit_val_batches``, ``--overfit_batches``,
``--accumulate_grad_batches``, ``--gradient_clip_val`` /
``--gradient_clip_algorithm``, ``--augment``, ``--remat``,
``--deterministic`` (weights from seed 0, deterministic algorithms on
the card), ``--detect_anomaly``, ``--profiler_dir``,
``--log_weights_every_n_epochs`` and ``--steps_per_execution`` (k
train steps a dispatch: on the card one CUDA graph replay a window) are
srtpu's knobs (``Trainer``'s note); ``fit`` also writes TensorBoard events to
``<default_root_dir>/tensorboard_logs`` and srtpu's run assets
(``model_summary.txt``, ``source_snapshot.zip``, ``model_graph.txt``). With
``--config`` (srtpu's YAML; needs PyYAML) the config and its dotted
``key=value`` overrides set everything but ``--device``. A run that
ends runs ``$SRTPU_NOTIFY_CMD`` with a message, or POSTs it to
``$SRTPU_NOTIFY_URL``, where set (srtpu's ``_notify``).

``export`` (srtpu's) writes the serving forward of ``--checkpoint``'s
model (rebuilt from ``hparams.json``) as a ``torch.export`` artifact at
a static ``--batch`` x ``--size`` LR shape, clipped to [0, 1] in f32,
``--tile N`` the tile-batched forward; load it with
:func:`srtpu_torch.export.load`. An artifact exported on the card
launches the port's kernels (``srtpu::`` operators) and runs only on a
card; ``--platforms`` takes one device, ``cuda`` or ``cpu``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from pathlib import Path

import torch

from .config import model_dtype
from .data import SRData
from .models import create_model, model_class
from .train import Trainer, TrainerConfig
from .utils.logging import attach_run_log

_logger = logging.getLogger('srtpu_torch')


def _use_pallas(value: str):
    """srtpu's ``use_pallas`` from the flag: false, true or cs."""
    routes = {'false': False, 'true': True, 'cs': 'cs'}
    if value.lower() not in routes:
        raise argparse.ArgumentTypeError(
            f'--use_pallas takes false, true or cs, not {value!r}')
    return routes[value.lower()]


def _bool(value: str) -> bool:
    if value.lower() not in ('true', 'false', '1', '0'):
        raise argparse.ArgumentTypeError(f'expected true or false, not '
                                         f'{value!r}')
    return value.lower() in ('true', '1')


# the model's own keys (srtpu's init_args): a flag the caller does not
# give is not passed, so the model takes its own default, as srtpu builds
# a model from its config's init_args alone (srtpu/cli.py:194)
MODEL_FLAGS = {'n_feats': int, 'n_resblocks': int, 'n_resgroups': int,
               'reduction': int, 'rdn_config': str, 'growth0': int,
               'n0': int, 'nr': int, 'depth': int, 'block_type': str,
               'res_scale': float, 'use_pallas': _use_pallas, 'ngf': int,
               'ndf': int, 'n_blocks': int}
PRECISIONS = ('bf16', 'bfloat16', '16', '32')


def _model_args(p: argparse.ArgumentParser, seed: int) -> None:
    p.add_argument('--model', default='EDSR')
    p.add_argument('--scale_factor', type=int, default=4)
    for name, kind in MODEL_FLAGS.items():
        p.add_argument(f'--{name}', type=kind, default=argparse.SUPPRESS)
    p.add_argument('--datasets_dir', default=None,
                   help='default: datasets (or the checkpoint\'s)')
    p.add_argument('--default_root_dir', default='.')
    p.add_argument('--precision', choices=PRECISIONS, default='bf16')
    p.add_argument('--device', default='cuda')
    p.add_argument('--seed', type=int, default=seed)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog='python -m srtpu_torch')
    sub = p.add_subparsers(dest='command', required=True)
    fit = sub.add_parser('fit', help='train a model on train datasets')
    _model_args(fit, seed=42)
    fit.add_argument('--config', action='append', default=[],
                     help="srtpu's YAML config (repeatable; needs PyYAML)")
    fit.add_argument('overrides', nargs='*',
                     help='dotted key=value config overrides')
    fit.add_argument('--train_datasets', nargs='+', default=None)
    fit.add_argument('--eval_datasets', nargs='*', default=[])
    fit.add_argument('--batch_size', type=int, default=16)
    fit.add_argument('--patch_size', type=int, default=128)
    fit.add_argument('--augment', type=_bool, default=True)
    fit.add_argument('--losses', default='l1')
    fit.add_argument('--optimizer', default='ADAM')
    fit.add_argument('--optimizer_params', nargs='*', default=[])
    fit.add_argument('--metrics', nargs='+', default=['PSNR', 'SSIM'])
    fit.add_argument('--metrics_for_pbar', nargs='+',
                     default=['PSNR', 'SSIM'])
    fit.add_argument('--max_epochs', type=int, default=2000)
    fit.add_argument('--check_val_every_n_epoch', type=int, default=200)
    fit.add_argument('--num_sanity_val_steps', type=int, default=2)
    fit.add_argument('--monitor', default=None)
    fit.add_argument('--save_top_k', type=int, default=3)
    fit.add_argument('--ckpt_path', default=None,
                     help="'last' or a checkpoints directory to resume")
    fit.add_argument('--save_results', type=int, default=-1)
    fit.add_argument('--save_results_from_epoch', default='last',
                     choices=('all', 'last', 'half', 'quarter'))
    fit.add_argument('--limit_train_batches', type=int, default=None)
    fit.add_argument('--limit_val_batches', type=int, default=None)
    fit.add_argument('--overfit_batches', type=int, default=0)
    fit.add_argument('--accumulate_grad_batches', type=int, default=1)
    fit.add_argument('--gradient_clip_val', type=float, default=None)
    fit.add_argument('--gradient_clip_algorithm', default='norm')
    fit.add_argument('--remat', type=_bool, default=False,
                     help='recompute the forward in the backward')
    fit.add_argument('--deterministic', type=_bool, default=False,
                     help='weights from seed 0; deterministic algorithms '
                          'on the card')
    fit.add_argument('--detect_anomaly', type=_bool, default=False,
                     help='raise FloatingPointError at the first NaN')
    fit.add_argument('--profiler_dir', default=None,
                     help='write a torch.profiler trace of the training '
                          'epochs here')
    fit.add_argument('--log_weights_every_n_epochs', type=int, default=50)
    fit.add_argument('--steps_per_execution', type=int, default=1,
                     help='train steps a dispatch (on the card one CUDA '
                          'graph of k steps)')
    _tile_args(fit)
    pr = sub.add_parser('predict', help='super-resolve predict datasets')
    _model_args(pr, seed=0)
    _restore_args(pr)
    pr.add_argument('--predict_datasets', nargs='+', default=None)
    pr.add_argument('--predict_tile', type=int, default=0)
    pr.add_argument('--predict_tile_overlap', type=int, default=32)
    _tile_args(pr)
    val = sub.add_parser('validate', help='score eval datasets')
    _model_args(val, seed=0)
    _restore_args(val)
    val.add_argument('--eval_datasets', nargs='+', default=None)
    val.add_argument('--metrics', nargs='+', default=None,
                     help="default: the checkpoint's, else PSNR SSIM")
    _tile_args(val)
    exp = sub.add_parser('export', help='serialize the serving forward '
                         '(torch.export)')
    exp.add_argument('--checkpoint', required=True,
                     help='checkpoints directory written by fit')
    exp.add_argument('--out', required=True, help='output artifact path')
    exp.add_argument('--batch', type=int, default=1)
    exp.add_argument('--size', default='256x256',
                     help='LR input HxW (static serving shape)')
    exp.add_argument('--platforms', nargs='+', default=None,
                     help='one device the artifact is for: cuda or cpu (a '
                          "torch.export artifact holds one device's "
                          'operators; default: --device)')
    exp.add_argument('--mlir', default=None,
                     help="also write the exported graph's text here (its "
                          'srtpu:: operators and stock ops; srtpu writes '
                          'StableHLO)')
    exp.add_argument('--tile', type=int, default=0,
                     help='>0: trace the tile-batched forward (batches of '
                          '16 LR tiles of this side, train/tiled.py); 0: '
                          'the full-image forward')
    exp.add_argument('--tile-overlap', type=int, default=8,
                     help='LR px halo per tile edge for --tile')
    exp.add_argument('--device', default='cuda')
    exp.add_argument('overrides', nargs='*',
                     help='data.<key>=<value> overrides of the checkpoint')
    return p


def _restore_args(p: argparse.ArgumentParser) -> None:
    p.add_argument('--weights', default=None,
                   help='torch state dict (.pt); default: init from --seed')
    p.add_argument('--checkpoint', default=None,
                   help="checkpoints directory written by fit: the model "
                        "from its hparams.json, the best (or last) state")
    p.add_argument('overrides', nargs='*',
                   help='data.<key>=<value> overrides of the checkpoint')


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


def check_card(name: str, scale: int, precision, model_kw: dict) -> None:
    """What the card refuses, before any card is touched: a scale without
    a card path, and f32 where the route reaches a kernel (the kernels
    take bf16). The model class says which routes do at a scale
    (``reaches_kernel``): SRCNN's and srtpu's XLA routes take f32
    (ROADMAP.md F4)."""
    cls = model_class(name)
    f32 = model_dtype(precision) is None
    if scale not in cls.CARD_SCALES or (
            f32 and cls.reaches_kernel(scale, model_kw)):
        raise ValueError(
            f'on CUDA the kernels take bf16 and {name} runs scales '
            f'{", ".join(map(str, cls.CARD_SCALES))}: pass --precision bf16 '
            f'and one of those scales (or --device cpu); the others have no '
            f'kernel path yet (ROADMAP.md F4)')


def _make_model(name: str, scale: int, precision, seed: int, device,
                model_kw: dict) -> torch.nn.Module:
    if device.type == 'cuda':
        check_card(name, scale, precision, model_kw)
    return create_model(name, scale_factor=scale,
                        dtype=model_dtype(precision), device=device,
                        generator=torch.Generator().manual_seed(seed),
                        **model_kw)


def build_model(args, device: torch.device, seed: int | None = None
                ) -> torch.nn.Module:
    """The model drawn from ``seed`` (default ``args.seed``), then loaded
    from ``args.weights`` when given."""
    given = {k: getattr(args, k) for k in MODEL_FLAGS if hasattr(args, k)}
    seed = args.seed if seed is None else seed
    model = _make_model(args.model, args.scale_factor, args.precision,
                        seed, device, given)
    weights = getattr(args, 'weights', None)
    if weights:
        state = torch.load(weights, map_location='cpu', weights_only=True)
        model.load_state_dict(state)
        _logger.info('loaded weights from %s', weights)
    else:
        _logger.info('no --weights: parameters initialised from seed %d',
                     seed)
    return model


def _flag_config(args) -> tuple:
    """(model, SRData, TrainerConfig, fit kwargs with srtpu's hparams)
    from ``fit``'s flags."""
    if not args.train_datasets:
        raise ValueError('fit needs --train_datasets (or --config)')
    device = resolve_device(args.device)
    # srtpu's deterministic state comes from seed 0, its loader from seed
    model = build_model(args, device, seed=0 if args.deterministic
                        else args.seed)
    given = {k: getattr(args, k) for k in MODEL_FLAGS if hasattr(args, k)}
    data = dict(batch_size=args.batch_size, patch_size=args.patch_size,
                scale_factor=args.scale_factor, augment=args.augment,
                datasets_dir=args.datasets_dir or 'datasets',
                eval_bucket=32, train_datasets=list(args.train_datasets),
                eval_datasets=list(args.eval_datasets), predict_datasets=[])
    dm = SRData(seed=args.seed, **data)
    monitor = args.monitor
    if monitor is None and args.eval_datasets and args.metrics:
        monitor = f'{args.eval_datasets[0]}/{args.metrics[0]}'
    tcfg = TrainerConfig(
        default_root_dir=args.default_root_dir, max_epochs=args.max_epochs,
        check_val_every_n_epoch=min(args.check_val_every_n_epoch,
                                    args.max_epochs),
        metrics=tuple(args.metrics),
        metrics_for_pbar=tuple(args.metrics_for_pbar), monitor=monitor,
        save_top_k=args.save_top_k,
        num_sanity_val_steps=args.num_sanity_val_steps,
        ckpt_path=args.ckpt_path, save_results=args.save_results,
        save_results_from_epoch=args.save_results_from_epoch,
        limit_train_batches=args.limit_train_batches,
        limit_val_batches=args.limit_val_batches,
        overfit_batches=args.overfit_batches,
        accumulate_grad_batches=args.accumulate_grad_batches,
        gradient_clip_val=args.gradient_clip_val,
        gradient_clip_algorithm=args.gradient_clip_algorithm,
        eval_tile=args.eval_tile, eval_tile_overlap=args.eval_tile_overlap,
        remat=args.remat, deterministic=args.deterministic,
        detect_anomaly=args.detect_anomaly, profiler_dir=args.profiler_dir,
        log_weights_every_n_epochs=args.log_weights_every_n_epochs,
        steps_per_execution=args.steps_per_execution)
    hparams = {'model': args.model,
               'init_args': {'scale_factor': args.scale_factor,
                             'channels': 3, **given},
               'data': data, 'losses': args.losses,
               'optimizer': args.optimizer,
               'optimizer_params': list(args.optimizer_params),
               'precision': args.precision, 'seed': args.seed,
               'monitor': monitor, 'metrics': list(args.metrics),
               'metrics_for_pbar': list(args.metrics_for_pbar)}
    return model, dm, tcfg, {'losses': args.losses,
                             'optimizer_name': args.optimizer,
                             'optimizer_params': args.optimizer_params,
                             'hparams': hparams}


def _yaml_config(args) -> tuple:
    """The same from srtpu's YAML (``--config``, ``overrides``)."""
    from .config import build_all, link_arguments, load_config
    cfg = link_arguments(load_config(args.config, args.overrides))
    device = resolve_device(args.device)
    model_cfg = cfg['model']
    init = model_cfg.get('init_args', {})
    if device.type == 'cuda':
        check_card(model_cfg['class_path'], cfg['data']['scale_factor'],
                   init.get('precision', cfg['trainer'].get('precision')),
                   init)
    model, dm, tcfg, fit_kwargs = build_all(cfg, device=device)
    return model, dm, tcfg, fit_kwargs


def cmd_fit(args) -> int:
    if args.config:
        model, dm, tcfg, fit_kwargs = _yaml_config(args)
    else:
        if args.overrides:
            raise ValueError(f'key=value overrides need --config: '
                             f'{args.overrides}')
        model, dm, tcfg, fit_kwargs = _flag_config(args)
    if tcfg.deterministic:
        # before the process's first cuBLAS call (building the model
        # makes none), which reads it
        from .train.loop import CUBLAS_DETERMINISTIC
        os.environ.setdefault('CUBLAS_WORKSPACE_CONFIG',
                              CUBLAS_DETERMINISTIC)
    root = Path(tcfg.default_root_dir)
    log = attach_run_log(root)
    name = fit_kwargs['hparams']['model']
    t0 = time.time()
    trainer = Trainer(tcfg)
    try:
        trainer.fit(model, dm, **fit_kwargs)
        torch.save(model.state_dict(), root / 'final_weights.pt')
        _logger.info('fit done: %d steps; weights at %s; checkpoints at %s',
                     trainer.global_step, root / 'final_weights.pt',
                     root / 'checkpoints')
    except BaseException as e:
        # the Trainer has saved 'last' and written the traceback
        _notify(f'srtpu_torch fit {name} FAILED after '
                f'{time.time() - t0:.0f}s: {type(e).__name__}: {e}')
        raise
    finally:
        trainer.close()
        logging.getLogger().removeHandler(log)
        log.close()
    _notify(f'srtpu_torch fit {name} finished in {time.time() - t0:.0f}s')
    return 0


def _overrides(items) -> dict:
    """``data.<key>=<value>`` arguments -> ``{key: value}``, each value
    read as ``config``'s overrides read theirs."""
    from .config import _parse_scalar
    out = {}
    for item in items or []:
        if '=' not in item:
            raise ValueError(f'override must be key=value, got {item!r}')
        key, val = (x.strip() for x in item.split('=', 1))
        if not key.startswith('data.'):
            raise ValueError(f'only data.<key> overrides apply to a '
                             f'checkpoint, got {key!r}')
        out[key[5:]] = _parse_scalar(val)
    return out


def _restore(args, device) -> tuple[torch.nn.Module, dict, dict]:
    """(model, hparams, data) from ``args.checkpoint`` (srtpu
    ``_restore``): the model rebuilt from ``hparams.json`` alone, drawn
    from its seed, then the checkpoint's best state on its monitor (else
    its latest, else ``last``), through the state fit trains (so an
    SRGAN's combined G + D checkpoint restores as it was saved)."""
    from .checkpoint import CheckpointManager, load_hparams
    from .losses import parse_losses
    from .models import SRGAN
    from .train import TrainState, create_gan_state
    hp = load_hparams(args.checkpoint)
    data = {**hp.get('data', {}), **_overrides(args.overrides)}
    init = dict(hp.get('init_args', {}))
    scale = int(init.pop('scale_factor', data.get('scale_factor', 4)))
    model = _make_model(hp['model'], scale, hp.get('precision', 'bf16'),
                        int(hp.get('seed', 42)), device, init)
    if isinstance(model, SRGAN):
        state = create_gan_state(model)
    else:
        # with the run's loss parameters: the state it saved
        state = TrainState.create(
            model, parse_losses(hp.get('losses', 'l1')),
            hp.get('optimizer', 'ADAM'), hp.get('optimizer_params', []))
    CheckpointManager(args.checkpoint,
                      monitor=hp.get('monitor') or '').restore(state)
    _logger.info('restored %s (step %d) from %s', hp['model'], state.step,
                 args.checkpoint)
    return model, hp, dict(data, scale_factor=scale)


def _model_for(args, device) -> tuple[torch.nn.Module, dict, dict]:
    """(model in eval mode, hparams, data keys) for ``validate`` and
    ``predict``: from ``--checkpoint``, or from the flags (and
    ``--weights``)."""
    if args.checkpoint and args.weights:
        raise ValueError('pass --checkpoint or --weights, not both')
    if args.checkpoint:
        model, hp, data = _restore(args, device)
    else:
        if args.overrides:
            raise ValueError(f'key=value overrides need --checkpoint: '
                             f'{args.overrides}')
        model, hp, data = build_model(args, device), {}, {
            'scale_factor': args.scale_factor}
    if args.datasets_dir:
        data['datasets_dir'] = args.datasets_dir
    data.setdefault('datasets_dir', 'datasets')
    return model.eval(), hp, data


def cmd_predict(args) -> int:
    device = resolve_device(args.device)
    model, hp, data = _model_for(args, device)
    names = args.predict_datasets or data.get('predict_datasets')
    if not names:
        print('no predict_datasets configured', file=sys.stderr)
        return 2
    dm = SRData(datasets_dir=data['datasets_dir'], predict_datasets=names,
                scale_factor=data['scale_factor'],
                eval_bucket=data.get('eval_bucket', 32))
    trainer = Trainer(TrainerConfig(
        default_root_dir=args.default_root_dir,
        predict_tile=args.predict_tile,
        predict_tile_overlap=args.predict_tile_overlap,
        eval_tile=args.eval_tile, eval_tile_overlap=args.eval_tile_overlap))
    try:
        trainer.predict(model, dm)
    finally:
        trainer.close()
    return 0


def cmd_validate(args) -> int:
    device = resolve_device(args.device)
    model, hp, data = _model_for(args, device)
    names = args.eval_datasets or data.get('eval_datasets')
    if not names:
        print('no eval_datasets configured', file=sys.stderr)
        return 2
    dm = SRData(datasets_dir=data['datasets_dir'], eval_datasets=names,
                scale_factor=data['scale_factor'],
                eval_bucket=data.get('eval_bucket', 32))
    # the flags win; else the checkpoint's own metrics; else the defaults
    metrics = args.metrics or hp.get('metrics') or ['PSNR', 'SSIM']
    trainer = Trainer(TrainerConfig(
        default_root_dir=args.default_root_dir, metrics=tuple(metrics),
        eval_tile=args.eval_tile, eval_tile_overlap=args.eval_tile_overlap))
    try:
        result = trainer.validate(model, dm)
    finally:
        trainer.close()
    for k, v in sorted(result.items()):
        print(f'{k}: {v:.4f}')
    return 0


def export_device(args) -> str:
    """The device of ``export``'s artifact: ``--platforms``' one value
    (cuda or cpu), else ``--device``. A torch.export artifact holds one
    device's operators, so a list of platforms, or a TPU, raises."""
    if not args.platforms:
        return args.device
    if len(args.platforms) != 1:
        raise ValueError(
            f'--platforms {" ".join(args.platforms)}: a torch.export '
            f"artifact holds one device's operators (srtpu_torch's run on "
            f'cuda, their plain versions on cpu); export once per device')
    platform = args.platforms[0].lower()
    if platform not in ('cuda', 'cpu'):
        raise ValueError(f'--platforms {args.platforms[0]}: srtpu_torch '
                         f'exports for cuda (its kernels) or cpu (their '
                         f'plain versions); a TPU artifact is srtpu\'s')
    return platform


def cmd_export(args) -> int:
    """srtpu's ``cmd_export``: the model rebuilt from the checkpoint's
    ``hparams.json``, its serving forward exported
    (:func:`~srtpu_torch.export.export_serving`) and saved."""
    from .export import export_serving, graph_text, save
    device = resolve_device(export_device(args))
    model, hp, data = _restore(args, device)
    scale = int(data.get('scale_factor', 4))
    h, w = (int(v) for v in args.size.lower().split('x'))
    program = export_serving(model, args.batch, h, w, tile=args.tile,
                             overlap=args.tile_overlap)
    size = save(program, args.out)
    if args.mlir:
        Path(args.mlir).write_text(graph_text(program))
    print(f'exported {hp["model"]} x{scale}: LR {(args.batch, h, w, 3)} -> '
          f'SR {(args.batch, h * scale, w * scale, 3)}, platforms '
          f'[{device.type!r}], {size:,} bytes -> {args.out}'
          + (f' (+ graph text {args.mlir})' if args.mlir else ''))
    return 0


def _notify(message: str) -> None:
    """srtpu's run notification: runs ``$SRTPU_NOTIFY_CMD message`` and
    POSTs ``{"text": message}`` to ``$SRTPU_NOTIFY_URL``, each where set;
    a failure is logged, never raised."""
    import os
    import shlex
    import subprocess
    cmd = os.environ.get('SRTPU_NOTIFY_CMD')
    if cmd:
        try:
            subprocess.run(shlex.split(cmd) + [message], timeout=30,
                           check=False)
        except Exception:
            _logger.warning('notify command failed', exc_info=True)
    url = os.environ.get('SRTPU_NOTIFY_URL')
    if url:
        try:
            import urllib.request
            req = urllib.request.Request(
                url, data=json.dumps({'text': message}).encode(),
                headers={'Content-Type': 'application/json'})
            urllib.request.urlopen(req, timeout=30).read()
        except Exception:
            _logger.warning('notify POST failed', exc_info=True)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(format='%(asctime)s %(name)s %(message)s')
    _logger.setLevel(logging.INFO)
    return {'fit': cmd_fit, 'predict': cmd_predict,
            'validate': cmd_validate,
            'export': cmd_export}[args.command](args)


if __name__ == '__main__':
    sys.exit(main())
