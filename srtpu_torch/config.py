"""Config system (srtpu/config.py): a YAML tree with ``${a.b.c}``
interpolation, dotted ``key=value`` overrides and srtpu's linked
arguments, and :func:`build_all`, which turns a config into the port's
model, :class:`~srtpu_torch.data.SRData`,
:class:`~srtpu_torch.train.TrainerConfig` and ``fit`` arguments.
``DEFAULTS``, ``TRAINING_KEYS``, ``TRAINING_DEFAULTS``,
``load_config``, ``link_arguments`` and ``split_training_args`` are
srtpu's, so one config gives both packages the same dicts; ``build_all``'s
``hparams`` is the snapshot schema ``checkpoints/hparams.json`` keeps.

PyYAML is imported only to read a config file or an override; where
it does not import (the card's machine has none) ``fit --config``
raises, naming it, an override's value is read as JSON, else as a
string, and everything else runs without it.
"""

from __future__ import annotations

import copy
import json
import logging
import re
from pathlib import Path
from typing import Any

import torch

_logger = logging.getLogger(__name__)


def _yaml():
    try:
        import yaml
    except ImportError as e:
        raise ImportError('reading a config needs PyYAML (import yaml '
                          'failed); pass the flags instead') from e
    return yaml


_INTERP = re.compile(r'\$\{([^}]+)\}')

# reference defaults (configs/all.yml + srmodel.py:76-98 ctor defaults)
DEFAULTS: dict[str, Any] = {
    'seed_everything': True,
    'seed': 42,
    'log_level': 'warning',
    'file_log_level': 'info',
    'data': {
        'augment': True,
        'batch_size': 16,
        'datasets_dir': 'datasets',
        'eval_datasets': ['DIV2K', 'Set5', 'Set14', 'B100', 'Urban100'],
        'patch_size': 128,
        'predict_datasets': [],
        'scale_factor': 4,
        'train_datasets': ['DIV2K'],
        'eval_bucket': 32,
        'prefetch': 2,
        'cache_train_images': True,
        'num_workers': 0,
    },
    'model': {
        'class_path': 'EDSR',
        'init_args': {},
    },
    'trainer': {
        'max_epochs': 2000,
        'check_val_every_n_epoch': 200,
        'default_root_dir': None,
        'accumulate_grad_batches': 1,
        'precision': 'bf16',
        'num_sanity_val_steps': 2,
        'limit_train_batches': None,
        'limit_val_batches': None,
        'overfit_batches': 0,       # >0: train on the SAME N batches/epoch
        'fast_dev_run': False,
        'enable_checkpointing': True,
        'save_top_k': 3,
        'monitor': None,
        'profiler': None,
        'log_every_n_steps': 50,
        'devices': None,            # data-parallel chip count (None = all)
        'spatial_devices': 1,       # spatial-sharding axis size
        'num_nodes': 1,             # host processes (reference all.yml:118)
        'coordinator_address': None,  # host 0 address (or $SRTPU_COORDINATOR)
        'node_rank': None,          # this host's id (or $SRTPU_NODE_RANK)
        'ckpt_path': None,          # 'last' or a checkpoints dir to resume
        'gradient_clip_val': None,  # clip grads (reference all.yml knob)
        'gradient_clip_algorithm': 'norm',   # 'norm' | 'value'
        'detect_anomaly': False,
        'deterministic': False,
        'remat': False,             # gradient checkpointing (HBM saver)
        'predict_tile': 0,          # >0: tile huge predict images (LR px)
        'predict_tile_overlap': 32,
        'eval_tile': 80,            # tile-batched kernel-path eval/predict
        #                             on TPU for CS models (0 disables);
        #                             80/ov8 measured best (PERF.md r5)
        'eval_tile_overlap': 8,     # LR px halo per tile edge
        'steps_per_execution': 1,   # scan k train steps per host dispatch
    },
}

# model.init_args keys that are TRAINING knobs in the reference
# (srmodel.py:76-98) and route to the trainer/fit call here.
TRAINING_KEYS = {
    'losses', 'optimizer', 'optimizer_params', 'metrics',
    'metrics_for_pbar', 'log_loss_every_n_epochs',
    'log_weights_every_n_epochs', 'save_results',
    'save_results_from_epoch', 'precision', 'batch_size', 'patch_size',
    'eval_datasets', 'predict_datasets', 'max_epochs', 'default_root_dir',
    'devices', 'model_gpus', 'model_parallel',
}

TRAINING_DEFAULTS = {
    'losses': 'l1',
    'optimizer': 'ADAM',
    'optimizer_params': [],
    'metrics': ['PSNR', 'SSIM'],
    'metrics_for_pbar': ['PSNR', 'SSIM'],
    'log_loss_every_n_epochs': 5,
    'log_weights_every_n_epochs': 50,
    'save_results': -1,
    'save_results_from_epoch': 'last',
}


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _lookup(tree: dict, dotted: str):
    node: Any = tree
    for part in dotted.split('.'):
        if not isinstance(node, dict) or part not in node:
            raise KeyError(f'interpolation key not found: {dotted}')
        node = node[part]
    return node


def _interpolate(tree: dict, max_passes: int = 8) -> dict:
    """Resolve ${a.b.c} references against the root, to a fixed point."""

    def resolve(value, root):
        if isinstance(value, str):
            full = _INTERP.fullmatch(value.strip())
            if full:
                return _lookup(root, full.group(1))
            return _INTERP.sub(
                lambda m: str(_lookup(root, m.group(1))), value)
        if isinstance(value, dict):
            return {k: resolve(v, root) for k, v in value.items()}
        if isinstance(value, list):
            return [resolve(v, root) for v in value]
        return value

    def has_refs(value) -> bool:
        if isinstance(value, str):
            return bool(_INTERP.search(value))
        if isinstance(value, dict):
            return any(has_refs(v) for v in value.values())
        if isinstance(value, list):
            return any(has_refs(v) for v in value)
        return False

    out = tree
    for _ in range(max_passes):
        new = resolve(out, out)
        if new == out:
            if has_refs(new):
                raise ValueError(
                    'circular ${...} interpolation could not be resolved')
            return new
        out = new
    raise ValueError('interpolation did not converge (circular ${...}?)')


def _set_dotted(tree: dict, dotted: str, value: Any) -> None:
    parts = dotted.split('.')
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = _parse_scalar(value)


def _parse_scalar(value: str) -> Any:
    """An override's value: YAML where PyYAML imports, else JSON, else
    the string itself (so ``data.*`` overrides of a checkpoint need no
    PyYAML)."""
    if not isinstance(value, str):
        return value
    try:
        import yaml
    except ImportError:
        try:
            return json.loads(value)
        except ValueError:
            return value
    try:
        return yaml.safe_load(value)
    except yaml.YAMLError:
        return value


def load_config(paths: list[str | Path] | None = None,
                overrides: list[str] | None = None) -> dict:
    """Merge defaults <- config files <- key=value dotted overrides,
    then interpolate. The files need PyYAML (see :func:`_parse_scalar`
    for the override values)."""
    cfg = copy.deepcopy(DEFAULTS)
    for path in paths or []:
        loaded = _yaml().safe_load(Path(path).read_text()) or {}
        cfg = _deep_merge(cfg, loaded)
    for ov in overrides or []:
        if '=' not in ov:
            raise ValueError(f'override must be key=value, got {ov!r}')
        key, val = ov.split('=', 1)
        _set_dotted(cfg, key.strip(), val.strip())
    return _interpolate(cfg)


def link_arguments(cfg: dict) -> dict:
    """Apply the reference's declarative links (main.py:20-31)."""
    cfg = copy.deepcopy(cfg)
    data, model, trainer = cfg['data'], cfg['model'], cfg['trainer']
    init = model.setdefault('init_args', {})

    # data.* -> model.init_args.* (main.py:21-25)
    init.setdefault('scale_factor', data['scale_factor'])
    init.setdefault('channels', 3)

    # model.init_args.* -> data/trainer: reference experiment configs put
    # these knobs on the model ctor (srmodel.py:76-98); route each to the
    # section that owns it here. model.init_args wins over the section
    # value, matching the reference where the ctor was the only owner.
    for key in ('batch_size', 'patch_size', 'eval_datasets',
                'predict_datasets'):
        if key in init:
            data[key] = init[key]
    for key in ('max_epochs', 'default_root_dir', 'devices'):
        if key in init:
            trainer[key] = init[key]

    # trainer.default_root_dir default mirrors all.yml:80
    if trainer.get('default_root_dir') is None:
        trainer['default_root_dir'] = (
            f"experiments/{model['class_path']}_X{data['scale_factor']}"
            f"_e_{trainer['max_epochs']}_p_{data['patch_size']}")

    # check_val_every_n_epoch caps to max_epochs (sane behavior when users
    # shrink max_epochs below the val interval)
    trainer['check_val_every_n_epoch'] = min(
        trainer['check_val_every_n_epoch'], trainer['max_epochs'])
    return cfg


def split_training_args(init_args: dict) -> tuple[dict, dict]:
    """Split model.init_args into (model fields, training knobs)."""
    train_kw = dict(TRAINING_DEFAULTS)
    model_kw = {}
    for k, v in init_args.items():
        if k in TRAINING_KEYS:
            train_kw[k] = v
        else:
            model_kw[k] = v
    return model_kw, train_kw


def model_dtype(precision) -> torch.dtype | None:
    """srtpu's spellings: bf16, bfloat16 and 16 give bf16 compute on f32
    parameters; 32 (or anything else, as srtpu) f32."""
    return torch.bfloat16 if str(precision) in ('bf16', 'bfloat16', '16') \
        else None


def build_all(cfg: dict, device=None):
    """cfg -> (model, datamodule, trainer_config, fit_kwargs), as srtpu's
    ``build_all``: the model on ``device`` drawn from ``seed`` (from 0
    under ``trainer.deterministic``, as srtpu draws its state), the
    loader's stream from the same seed, and its knobs (``data.prefetch``,
    ``cache_train_images``, ``num_workers``). Keys the port does not read
    (``trainer.devices`` and the multi-host keys) are kept in the hparams
    and have no effect; nor has ``trainer.eval_tile``, whose default 80
    is srtpu's TPU lane budget, which srtpu applies only on a TPU: the
    port's val passes take the direct forward (``--eval_tile`` on the
    command line routes them)."""
    from .data import SRData
    from .models import create_model
    from .train import TrainerConfig

    cfg = link_arguments(cfg)
    data, model_cfg, trainer = cfg['data'], cfg['model'], cfg['trainer']
    model_kw, train_kw = split_training_args(model_cfg.get('init_args', {}))
    # model.init_args.precision (srtpu: the model owns it) wins
    precision = str(train_kw.get('precision',
                                 trainer.get('precision', 'bf16')))
    seed = cfg.get('seed', 42)
    # srtpu's deterministic state comes from seed 0, its loader from seed
    init_seed = 0 if trainer.get('deterministic', False) else seed
    model = create_model(model_cfg['class_path'],
                         dtype=model_dtype(precision), device=device,
                         generator=torch.Generator().manual_seed(init_seed),
                         **model_kw)
    dm = SRData(
        augment=data['augment'], batch_size=data['batch_size'],
        datasets_dir=data['datasets_dir'],
        eval_datasets=data['eval_datasets'],
        patch_size=data['patch_size'],
        predict_datasets=data['predict_datasets'],
        scale_factor=data['scale_factor'],
        train_datasets=data['train_datasets'],
        eval_bucket=data.get('eval_bucket', 32), seed=seed,
        prefetch=data.get('prefetch', 2),
        cache_train_images=data.get('cache_train_images', True),
        num_workers=data.get('num_workers', 0))

    monitor = trainer.get('monitor')
    if monitor is None and data['eval_datasets']:
        metrics = train_kw.get('metrics', ['PSNR'])
        monitor = f"{data['eval_datasets'][0]}/{metrics[0]}"

    tcfg = TrainerConfig(
        max_epochs=trainer['max_epochs'],
        check_val_every_n_epoch=trainer['check_val_every_n_epoch'],
        log_loss_every_n_epochs=train_kw['log_loss_every_n_epochs'],
        log_weights_every_n_epochs=train_kw['log_weights_every_n_epochs'],
        default_root_dir=trainer['default_root_dir'],
        save_results=train_kw['save_results'],
        save_results_from_epoch=train_kw['save_results_from_epoch'],
        metrics=tuple(train_kw['metrics']),
        metrics_for_pbar=tuple(train_kw['metrics_for_pbar']),
        monitor=monitor,
        save_top_k=trainer.get('save_top_k', 3),
        num_sanity_val_steps=trainer.get('num_sanity_val_steps', 2),
        accumulate_grad_batches=trainer.get('accumulate_grad_batches', 1),
        limit_train_batches=trainer.get('limit_train_batches'),
        limit_val_batches=trainer.get('limit_val_batches'),
        overfit_batches=int(trainer.get('overfit_batches', 0) or 0),
        fast_dev_run=trainer.get('fast_dev_run', False),
        enable_checkpointing=trainer.get('enable_checkpointing', True),
        profiler_dir=trainer.get('profiler'),
        log_every_n_steps=trainer.get('log_every_n_steps', 50),
        ckpt_path=trainer.get('ckpt_path'),
        gradient_clip_val=trainer.get('gradient_clip_val'),
        gradient_clip_algorithm=trainer.get('gradient_clip_algorithm',
                                            'norm'),
        detect_anomaly=bool(trainer.get('detect_anomaly', False)),
        deterministic=bool(trainer.get('deterministic', False)),
        remat=bool(trainer.get('remat', False)),
        predict_tile=int(trainer.get('predict_tile', 0) or 0),
        eval_tile_overlap=int(trainer.get('eval_tile_overlap', 8) or 0),
        predict_tile_overlap=int(trainer.get('predict_tile_overlap', 32)),
        steps_per_execution=int(trainer.get('steps_per_execution', 1)))

    fit_kwargs = {
        'losses': train_kw['losses'],
        'optimizer_name': train_kw['optimizer'],
        'optimizer_params': train_kw['optimizer_params'],
        'hparams': {
            'model': model_cfg['class_path'],
            'init_args': model_kw,
            'data': dict(data),
            'losses': train_kw['losses'],
            'optimizer': train_kw['optimizer'],
            'optimizer_params': train_kw['optimizer_params'],
            'precision': precision,
            'seed': seed,
            'monitor': monitor,
            'metrics': list(train_kw['metrics']),
            'metrics_for_pbar': list(train_kw['metrics_for_pbar']),
        },
    }
    return model, dm, tcfg, fit_kwargs
