"""Trainer (srtpu/train/loop.py). Predict only so far: the direct
full-image path of srtpu's ``Trainer.predict``."""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path

import torch

from ..data.pipeline import center_crop
from ..utils.logging import save_image

from .steps import make_predict_step

_logger = logging.getLogger(__name__)


@dataclass
class TrainerConfig:
    default_root_dir: str = '.'


class Trainer:
    def __init__(self, cfg: TrainerConfig):
        self.cfg = cfg
        self.root = Path(cfg.default_root_dir)

    def predict(self, model: torch.nn.Module, datamodule) -> list[Path]:
        """Super-resolve every predict image on the model's device: forward
        the bucket-padded LR, crop the SR to its true size, write
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
