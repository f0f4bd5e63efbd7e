"""Trainer (srtpu/train/loop.py): ``fit`` and ``predict``.

``fit`` covers srtpu's epoch loop: ``max_epochs``,
``limit_train_batches``, ``fast_dev_run``, the per-epoch progress line
(``epoch %d/%d  loss %.4f  %.1f items/s``) and ``global_step``. The
model's current weights are the initial state (srtpu's ``seed`` draws
them; here the caller does, as ``python -m srtpu_torch fit --seed``
does for the weights and the loader).
Validation, checkpoints, trackers and image dumps are not ported yet
(ROADMAP.md queue 1, items 4 and 7): asking for them raises.
``predict`` is the direct full-image path of srtpu's
``Trainer.predict``.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from ..data.pipeline import center_crop
from ..losses import parse_losses
from ..optim import build_optimizer
from ..utils.logging import save_image
from .state import TrainState
from .steps import make_predict_step, make_train_step

_logger = logging.getLogger(__name__)


@dataclass
class TrainerConfig:
    default_root_dir: str = '.'
    max_epochs: int = 20
    limit_train_batches: int | None = None
    fast_dev_run: bool = False      # one epoch of one step
    monitor: str | None = None      # not ported: raises (item 7)
    ckpt_path: str | None = None    # not ported: raises (item 7)


class Trainer:
    def __init__(self, cfg: TrainerConfig):
        self.cfg = cfg
        self.root = Path(cfg.default_root_dir)
        self.global_step = 0

    def fit(self, model: torch.nn.Module, datamodule, losses: str = 'l1',
            optimizer_name: str = 'ADAM',
            optimizer_params: list[str] | None = None) -> TrainState:
        """Train ``model`` in place on ``datamodule``'s train datasets on
        the model's device, in train mode (its mode is restored after);
        returns the final :class:`TrainState`."""
        cfg = self.cfg
        if cfg.monitor or cfg.ckpt_path:
            raise NotImplementedError(
                'checkpoints (monitor, ckpt_path) are not ported to '
                'srtpu_torch yet (ROADMAP.md queue 1, item 7)')
        datamodule.setup('fit')
        state = TrainState(model, build_optimizer(
            optimizer_name, optimizer_params, model.parameters()))
        train_step = make_train_step(parse_losses(losses))
        loader = datamodule.train_loader()
        device = next(model.parameters()).device
        n_params = sum(p.numel() for p in model.parameters())
        _logger.info('model parameters: %s (%.2f MB fp32)', f'{n_params:,}',
                     n_params * 4 / 2 ** 20)
        limit = 1 if cfg.fast_dev_run else cfg.limit_train_batches
        max_epochs = 1 if cfg.fast_dev_run else cfg.max_epochs
        was_training = model.training
        model.train()       # srtpu's train=True: batch statistics
        try:
            self._epochs(state, train_step, loader, device, limit, max_epochs)
        finally:
            model.train(was_training)
        return state

    def _epochs(self, state, train_step, loader, device, limit, max_epochs):
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
            loss = float(logs['loss']) if logs else 0.0    # waits for the step
            _logger.info('epoch %d/%d  loss %.4f  %.1f items/s', epoch + 1,
                         max_epochs, loss, items / max(time.time() - t0, 1e-9))

    def predict(self, model: torch.nn.Module, datamodule) -> list[Path]:
        """Super-resolve every predict image on the model's device: forward
        the bucket-padded LR in eval mode, crop the SR to its true size, write
        ``<root>/<dataset>/<name>.png`` and, for images of at least
        96 x 96, ``<name>_center.png``. Returns the SR image paths."""
        datamodule.setup('predict')
        device = next(model.parameters()).device
        predict_step = make_predict_step(model)
        written = []
        for ds_name, loader in zip(datamodule.predict_dataset_names,
                                   datamodule.predict_loaders()):
            for batch in loader:
                hs, ws = batch.hr_size
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
