"""Step functions (srtpu/train/steps.py). Predict only so far."""

from __future__ import annotations

import torch


def make_predict_step(model: torch.nn.Module):
    """``lr -> clip(model(lr).float(), 0, 1)`` without autograd
    (srtpu make_predict_step)."""
    def predict_step(lr: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model(lr).float().clamp(0.0, 1.0)

    return predict_step
