"""SRGAN's adversarial step: two optimizers, the discriminator updated
first, then the generator against the updated discriminator
(srtpu/train/gan.py):

* D step: d_loss = 1 + gan(D(hr), real) + gan(D(sr detached), fake), D in
  train mode on hr, then on sr (its running statistics move after each
  call, in that order), then one D update;
* G step, with the updated D in eval mode: mse on [-1, 1], content =
  (VGG19 relu5_4 + mse) / 2, g_loss = content + 1e-3 adv + 2e-8 tv, then
  one G update;
* optimizers: Adam(lr) for each with a x0.1 step every 100,000 updates
  (:func:`steplr_adam`).

srtpu runs the generator forward twice from the same parameters and
batch statistics, once for each update, and keeps the second call's
running-statistic update; the two outputs are equal. Here the generator
runs once per step: D reads its detached output, and the G step
back-propagates through it, so the generator's running statistics move
exactly once per step, as srtpu's do.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..losses import VGGLoss, gan_loss, l2_loss, tv_loss
from ..optim import build_optimizer
from .state import Updater


@dataclass
class GANTrainState:
    """The generator and discriminator, their optimizers and learning-rate
    schedules, each optimizer's :class:`~srtpu_torch.train.state.Updater`
    (accumulation and clipping) and the step count (srtpu
    ``GANTrainState``; PyTorch updates the modules in place). Its
    checkpoint holds both modules under ``generator.`` and
    ``discriminator.`` and the optimizers as ``g`` and ``d``, as srtpu's
    combined view."""
    generator: torch.nn.Module
    discriminator: torch.nn.Module
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    g_sched: torch.optim.lr_scheduler.LRScheduler
    d_sched: torch.optim.lr_scheduler.LRScheduler
    step: int = 0
    g_updater: Updater = field(default_factory=Updater)
    d_updater: Updater = field(default_factory=Updater)

    def optimizers(self) -> dict:
        return {'g': (self.g_opt, self.g_sched, self.g_updater),
                'd': (self.d_opt, self.d_sched, self.d_updater)}

    def modules(self) -> dict[str, torch.nn.Module]:
        return {'generator.': self.generator,
                'discriminator.': self.discriminator}


def steplr_adam(parameters, lr: float = 1e-4, step_size: int = 100_000,
                gamma: float = 0.1):
    """(Adam, StepLR): the port's Adam (optax's ``adam``) at ``lr``, times
    ``gamma`` every ``step_size`` updates (optax ``exponential_decay``
    with staircase, as srtpu's ``steplr_adam``); the schedule steps once
    per optimizer step."""
    opt = build_optimizer('ADAM', {'lr': lr}, parameters)
    return opt, torch.optim.lr_scheduler.StepLR(opt, step_size, gamma)


def create_gan_state(model, lr: float = 1e-4, accumulate: int = 1,
                     clip_val: float | None = None,
                     clip_algorithm: str = 'norm') -> GANTrainState:
    """The state of an :class:`~srtpu_torch.models.SRGAN` (its
    ``generator`` and ``discriminator``), each with :func:`steplr_adam`
    and an updater of ``accumulate`` mini-steps clipping at ``clip_val``
    (srtpu wraps both optimizers alike; the schedules count updates)."""
    g_opt, g_sched = steplr_adam(model.generator.parameters(), lr)
    d_opt, d_sched = steplr_adam(model.discriminator.parameters(), lr)
    return GANTrainState(
        model.generator, model.discriminator, g_opt, d_opt, g_sched,
        d_sched, g_updater=Updater(accumulate, clip_val, clip_algorithm),
        d_updater=Updater(accumulate, clip_val, clip_algorithm))


def make_gan_train_step(gan_mode: str = 'wgangp',
                        vgg_loss: VGGLoss | None = None,
                        adv_weight: float = 1e-3, tv_weight: float = 2e-8,
                        plain: bool = False):
    """``train_step(state, lr, hr) -> logs``: one D and one G update (the
    module note). The generator runs in the mode it is in (train mode
    under ``Trainer.fit``: batch statistics); the discriminator in train
    mode for its update and in eval mode for the generator's, left in
    train mode. Logs are 0-dim device tensors read without a host sync:
    d_loss, g_loss, content_loss, adv_loss, tv_loss, mse_loss, vgg_loss.
    ``plain`` runs the generator's kernels' plain versions."""
    vgg = vgg_loss if vgg_loss is not None else VGGLoss()

    def train_step(state: GANTrainState, lr_img: torch.Tensor,
                   hr_img: torch.Tensor) -> dict[str, torch.Tensor]:
        g, d = state.generator, state.discriminator
        sr = g(lr_img, plain=plain)

        state.d_opt.zero_grad(set_to_none=True)
        d.train()
        d_loss = (1.0 + gan_loss(d(hr_img), True, gan_mode)
                  + gan_loss(d(sr.detach()), False, gan_mode))
        d_loss.backward()
        state.d_updater.apply(state.d_opt, state.d_sched)

        state.g_opt.zero_grad(set_to_none=True)
        d.eval()
        d.requires_grad_(False)     # the G step needs D's input gradient
        try:
            sr32, hr32 = sr.float(), hr_img.float()
            mse = l2_loss(sr32 * 2 - 1, hr32 * 2 - 1)
            vgg_l = vgg(sr32, hr32)
            content = (vgg_l + mse) / 2.0
            adv = gan_loss(d(sr), True, gan_mode)
            tv = tv_loss(sr32)
            g_loss = content + adv_weight * adv + tv_weight * tv
            g_loss.backward()
        finally:
            d.requires_grad_(True)
            d.train()
        state.g_updater.apply(state.g_opt, state.g_sched)
        state.step += 1
        logs = {'d_loss': d_loss, 'g_loss': g_loss, 'content_loss': content,
                'adv_loss': adv, 'tv_loss': tv, 'mse_loss': mse,
                'vgg_loss': vgg_l}
        return {k: v.detach() for k, v in logs.items()}

    return train_step
