"""TrainState: the model, its optimizer and the step count (srtpu
``train/state.py``). PyTorch updates the parameters in place, so the
state is one mutable object that the train step advances. No ported loss
has trainable parameters, so there are none beside the model's yet."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
