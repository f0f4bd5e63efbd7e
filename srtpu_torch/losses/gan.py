"""GAN losses: lsgan, vanilla (BCE with logits) and wgangp
(srtpu/losses/gan.py), on the discriminator's output in f32."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gan_loss(prediction: torch.Tensor, target_is_real: bool,
             gan_mode: str = 'wgangp') -> torch.Tensor:
    p = prediction.float()
    target = 1.0 if target_is_real else 0.0
    if gan_mode == 'lsgan':
        return (p - target).square().mean()
    if gan_mode == 'vanilla':
        # BCE with logits in srtpu's stable form
        return (F.relu(p) - p * target + torch.log1p(torch.exp(-p.abs()))) \
            .mean()
    if gan_mode == 'wgangp':
        return -p.mean() if target_is_real else p.mean()
    raise NotImplementedError(f'gan mode {gan_mode} not implemented')
