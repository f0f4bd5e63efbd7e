"""Pixel-space losses: L1/MAE and L2/MSE on f32 inputs and total variation
(srtpu/losses/basic.py:17-35), and the JAX forms of ``clip`` and ``abs``
that srtpu's losses differentiate."""

from __future__ import annotations

import torch


def l1_loss(sr: torch.Tensor, hr: torch.Tensor) -> torch.Tensor:
    """mean |sr - hr|, with JAX's gradient where sr equals hr
    (:func:`abs_`)."""
    return abs_(sr.float() - hr.float()).mean()


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


# srtpu's losses take JAX's gradients, which differ from PyTorch's at
# ties, and the ties are common here (an SR clamped to exactly 0 or 1, a
# Haar response exactly 0 in a flat region, a colour difference exactly
# 0 where the images agree). These two give JAX's.

def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: min(max(x, lo), hi), whose gradient at a bound is
    0.5 (``torch.clamp`` passes 1)."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


class _Abs(torch.autograd.Function):
    """``torch.abs`` forward (one launch), JAX's gradient backward."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def abs_(x: torch.Tensor) -> torch.Tensor:
    """``jnp.abs``, whose gradient at 0 is 1 (``torch.abs``'s is 0)."""
    return _Abs.apply(x)
