"""Pixel-space losses: L1/MAE and L2/MSE on f32 inputs
(srtpu/losses/basic.py:17-23)."""

from __future__ import annotations

import torch


def l1_loss(sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
    return (sr.float() - hr.float()).abs().mean()


def l2_loss(sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
    return (sr.float() - hr.float()).square().mean()
