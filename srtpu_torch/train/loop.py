"""Trainer (srtpu/train/loop.py): ``fit``, ``validate`` and ``predict``.

``fit`` covers srtpu's epoch loop: ``max_epochs``,
``limit_train_batches``, ``fast_dev_run``, the per-epoch progress line
(``epoch %d/%d  loss %.4f  %.1f items/s``) and ``global_step``. An
:class:`~srtpu_torch.models.SRGAN` trains adversarially instead
(srtpu's ``_fit_gan``): the loss DSL is ignored, the step is
:func:`~srtpu_torch.train.gan.make_gan_train_step` with its VGG19 term,
both optimizers take the lr of ``optimizer_params`` (default 1e-4), and
the line is ``epoch %d/%d  g_loss %.4f  d_loss %.4f  %.1f items/s``. The
model trains the generator and discriminator it holds, with its own
``dtype`` (srtpu's ``_fit_gan`` rebuilds its generator positionally and
so drops the dtype, ROADMAP.md F8). The model's current weights are the
initial state (srtpu's ``seed`` draws them; here the caller does, as
``python -m srtpu_torch fit --seed`` does for the weights and the
loader).
Validation during ``fit``, checkpoints, trackers and image dumps are
not ported yet (ROADMAP.md queue 1, item 7): ``fit`` with eval datasets,
``monitor`` or ``ckpt_path`` raises.

``validate`` scores every eval image (batch 1, bucket-padded, masked)
with ``metrics`` and returns ``{dataset/metric: mean}``; ``predict``
writes PNGs. Both take srtpu's routes: a ``'cs'`` model without
``GLOBAL_POOLING`` runs an LR shape that srtpu's lane budget cannot take
directly (``tiled.route_tiled``) through the tiled step when
``eval_tile`` > 0 (predict first edge-pads the LR to ``eval_tile``
multiples); else ``predict`` takes host tiles when ``predict_tile`` > 0
and the image's sides both exceed it; else the direct full-image
forward. srtpu defaults ``eval_tile`` to 80 for its TPU's lane budget
and tiles only on a TPU; the card has no such budget (RDN-B's direct
forward at LR 512x352 takes 44.5 ms on an H100), so here it defaults to
0, srtpu's "plain full-image forward", on every device, and
``eval_tile=80`` gives srtpu's TPU routing.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..data.pipeline import center_crop
from ..losses import VGGLoss, parse_losses
from ..metrics import build_metrics
from ..models import SRGAN
from ..optim import build_optimizer, parse_optimizer_params
from ..utils.logging import save_image
from .gan import create_gan_state, make_gan_train_step
from .state import TrainState
from .steps import (make_eval_step, make_predict_step,
                    make_tiled_eval_step, make_tiled_predict_step,
                    make_train_step)
from .tiled import route_tiled, tiled_predict

_logger = logging.getLogger(__name__)


@dataclass
class TrainerConfig:
    default_root_dir: str = '.'
    max_epochs: int = 20
    limit_train_batches: int | None = None
    fast_dev_run: bool = False      # one epoch of one step
    monitor: str | None = None      # not ported: raises (item 7)
    ckpt_path: str | None = None    # not ported: raises (item 7)
    metrics: tuple[str, ...] = ('PSNR', 'SSIM')
    limit_val_batches: int | None = None
    eval_tile: int = 0              # srtpu: 80 (its TPU's lane budget)
    eval_tile_overlap: int = 8      # LR px halo per tile edge
    predict_tile: int = 0           # > 0: host tiles past this size
    predict_tile_overlap: int = 32  # LR px, >= the receptive radius


class Trainer:
    def __init__(self, cfg: TrainerConfig):
        self.cfg = cfg
        self.root = Path(cfg.default_root_dir)
        self.global_step = 0
        self.current_epoch = 0

    def fit(self, model: torch.nn.Module, datamodule, losses: str = 'l1',
            optimizer_name: str = 'ADAM',
            optimizer_params: list[str] | None = None):
        """Train ``model`` in place on ``datamodule``'s train datasets on
        the model's device, in train mode (its mode is restored after);
        returns the final :class:`TrainState` (an SRGAN's:
        :class:`~srtpu_torch.train.gan.GANTrainState`)."""
        cfg = self.cfg
        if cfg.monitor or cfg.ckpt_path:
            raise NotImplementedError(
                'checkpoints (monitor, ckpt_path) are not ported to '
                'srtpu_torch yet (ROADMAP.md queue 1, item 7)')
        if datamodule.eval_dataset_names:
            raise NotImplementedError(
                'validation during fit is not ported to srtpu_torch yet '
                '(ROADMAP.md queue 1, item 7); run validate after fit')
        datamodule.setup('fit')
        device = next(model.parameters()).device
        if isinstance(model, SRGAN):
            lr = parse_optimizer_params(optimizer_params).get('lr', 1e-4)
            vgg = VGGLoss(device=device)
            if not vgg.pretrained:
                _logger.warning(
                    '=' * 66 + "\nWARNING: SRGAN's VGG content term is "
                    'running on deterministic random-init features (no '
                    'converted pretrained weights found) — the training '
                    'objective will not match the reference. Convert '
                    'weights with tools/convert_torch_weights.py into '
                    '$SRTPU_WEIGHTS_DIR.\n' + '=' * 66)
            state = create_gan_state(model, lr)
            train_step = make_gan_train_step(vgg_loss=vgg)
            keys = ('g_loss', 'd_loss')
        else:
            state = TrainState(model, build_optimizer(
                optimizer_name, optimizer_params, model.parameters()))
            train_step = make_train_step(parse_losses(losses))
            keys = ('loss',)
        loader = datamodule.train_loader()
        n_params = sum(p.numel() for p in model.parameters())
        _logger.info('model parameters: %s (%.2f MB fp32)', f'{n_params:,}',
                     n_params * 4 / 2 ** 20)
        limit = 1 if cfg.fast_dev_run else cfg.limit_train_batches
        max_epochs = 1 if cfg.fast_dev_run else cfg.max_epochs
        was_training = model.training
        model.train()       # srtpu's train=True: batch statistics
        try:
            self._epochs(state, train_step, loader, device, limit, max_epochs,
                         keys)
        finally:
            model.train(was_training)
        return state

    def _epochs(self, state, train_step, loader, device, limit, max_epochs,
                keys):
        for epoch in range(max_epochs):
            loader.set_epoch(epoch)
            t0 = time.time()
            items, logs = 0, None
            for i, batch in enumerate(loader):
                if limit is not None and i >= limit:
                    break
                lr = torch.from_numpy(batch.lr).to(device)
                hr = torch.from_numpy(batch.hr).to(device)
                logs = train_step(state, lr, hr)
                self.global_step += 1
                items += lr.shape[0]
            self.current_epoch = epoch
            # reading a loss waits for the step
            losses = [float(logs[k]) if logs else 0.0 for k in keys]
            _logger.info('epoch %d/%d  ' + '  '.join(f'{k} %.4f' for k in keys)
                         + '  %.1f items/s', epoch + 1, max_epochs, *losses,
                         items / max(time.time() - t0, 1e-9))

    # ------------------------------------------------------------ routing

    def _tiled_gate(self, model):
        """(scale, tile, overlap) when the tiled steps apply: ``eval_tile``
        > 0 and a ``'cs'`` model without ``GLOBAL_POOLING`` (RCAN's
        channel attention pools over the image, which a tile would change),
        on any device; else None (srtpu ``_tiled_gate`` without its TPU
        check)."""
        cfg = self.cfg
        if (cfg.eval_tile <= 0 or getattr(model, 'use_pallas', None) != 'cs'
                or getattr(model, 'GLOBAL_POOLING', False)):
            return None
        return model.scale_factor, cfg.eval_tile, cfg.eval_tile_overlap

    def _route_tiled(self, model, lr_shape) -> bool:
        """srtpu's rule: tile an LR shape no direct plan of its lane budget
        takes (``tiled.route_tiled``)."""
        return route_tiled(lr_shape, getattr(model, 'n_feats', 64))

    def _make_eval_step(self, metrics: dict, model: torch.nn.Module):
        """The direct eval step, or, where the gate opens, one that sends
        each shape the router picks through the tiled step."""
        direct = make_eval_step(model, metrics)
        gate = self._tiled_gate(model)
        if gate is None:
            return direct
        tiled = make_tiled_eval_step(model, metrics, *gate)

        def eval_step(lr, hr, mask):
            if self._route_tiled(model, lr.shape):
                return tiled(lr, hr, mask)
            return direct(lr, hr, mask)

        return eval_step

    # ----------------------------------------------------------- validate

    def validate(self, model: torch.nn.Module, datamodule,
                 metrics=None) -> dict[str, float]:
        """Score ``model`` (eval mode, on its device) on every eval
        dataset of ``datamodule`` with ``metrics`` (default the config's),
        at most ``limit_val_batches`` images each; logs srtpu's ``val``
        line and returns ``{dataset/metric: mean over images}``. Each
        metric is read to the host once an image."""
        datamodule.setup('validate')
        device = next(model.parameters()).device
        eval_step = self._make_eval_step(
            build_metrics(list(metrics or self.cfg.metrics)), model)
        limit = self.cfg.limit_val_batches
        all_metrics: dict[str, float] = {}
        for ds_name, loader in zip(datamodule.eval_dataset_names,
                                   datamodule.eval_loaders()):
            per_metric: dict[str, list[float]] = {}
            for i, batch in enumerate(loader):
                if limit is not None and i >= limit:
                    break
                lr, hr, mask = (torch.from_numpy(a).to(device)
                                for a in (batch.lr, batch.hr, batch.mask))
                _, results = eval_step(lr, hr, mask)
                for k, v in results.items():
                    per_metric.setdefault(k, []).append(float(v))
            for k, vals in per_metric.items():
                all_metrics[f'{ds_name}/{k}'] = float(np.mean(vals))
        if all_metrics:
            _logger.info('val @ epoch %d: %s', self.current_epoch + 1,
                         '  '.join(f'{k}={v:.4f}'
                                   for k, v in all_metrics.items()))
        return all_metrics

    # ------------------------------------------------------------ predict

    def predict(self, model: torch.nn.Module, datamodule) -> list[Path]:
        """Super-resolve every predict image on the model's device in eval
        mode, crop the SR to its true size, write
        ``<root>/<dataset>/<name>.png`` and, for images of at least
        96 x 96, ``<name>_center.png``. Returns the SR image paths. The
        route of each image is srtpu's (the module docstring)."""
        datamodule.setup('predict')
        device = next(model.parameters()).device
        predict_step = make_predict_step(model)
        gate = self._tiled_gate(model)
        tiled_step = None if gate is None else \
            make_tiled_predict_step(model, *gate)
        cfg, scale = self.cfg, datamodule.scale_factor
        written = []
        for ds_name, loader in zip(datamodule.predict_dataset_names,
                                   datamodule.predict_loaders()):
            for batch in loader:
                hs, ws = batch.hr_size
                lh, lw = hs // scale, ws // scale
                if tiled_step is not None and \
                        self._route_tiled(model, batch.lr.shape):
                    g = cfg.eval_tile
                    src = np.pad(batch.lr[:, :lh, :lw],
                                 ((0, 0), (0, -(-lh // g) * g - lh),
                                  (0, -(-lw // g) * g - lw), (0, 0)),
                                 mode='edge')
                    sr = tiled_step(torch.from_numpy(src).to(device))
                    sr_np = sr[0, :hs, :ws].cpu().numpy()
                elif cfg.predict_tile and \
                        min(batch.lr.shape[1:3]) > cfg.predict_tile:
                    sr_np = tiled_predict(
                        lambda t: predict_step(
                            torch.from_numpy(t).to(device)).cpu().numpy(),
                        batch.lr[0, :lh, :lw], scale, tile=cfg.predict_tile,
                        overlap=cfg.predict_tile_overlap)[:hs, :ws]
                else:
                    sr = predict_step(torch.from_numpy(batch.lr).to(device))
                    sr_np = sr[0, :hs, :ws].cpu().numpy()
                name = batch.names[0]
                path = self.root / ds_name / f'{name}.png'
                save_image(sr_np, path)
                written.append(path)
                if hs >= 96 and ws >= 96:
                    save_image(center_crop(sr_np, 96, 96),
                               self.root / ds_name / f'{name}_center.png')
                _logger.info('predicted %s/%s (%dx%d)', ds_name, name, hs, ws)
        return written
