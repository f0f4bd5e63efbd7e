"""Pixel-space losses: L1/MAE and L2/MSE on f32 inputs and total variation
(srtpu/losses/basic.py:17-35)."""

from __future__ import annotations

import torch


def l1_loss(sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
    return (sr.float() - hr.float()).abs().mean()


def l2_loss(sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
    return (sr.float() - hr.float()).square().mean()


def tv_loss(x: torch.Tensor) -> torch.Tensor:
    """Total variation of NHWC x in f32 (srtpu/losses/basic.py:26-35): 2 *
    (sum of squared row steps / their count per image + the same of the
    column steps) / batch."""
    x = x.float()
    b = x.shape[0]
    h_tv = (x[:, 1:] - x[:, :-1]).square().sum()
    w_tv = (x[:, :, 1:] - x[:, :, :-1]).square().sum()
    count_h = x[:, 1:].numel() // b
    count_w = x[:, :, 1:].numel() // b
    return 2.0 * (h_tv / count_h + w_tv / count_w) / b
