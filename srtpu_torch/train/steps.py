"""Step functions (srtpu/train/steps.py): the train step and the predict
step."""

from __future__ import annotations

import torch

from .state import TrainState


def make_train_step(composite_loss, plain: bool = False):
    """``train_step(state, lr, hr) -> logs`` (srtpu ``train_step_body``):
    the forward in the model's compute dtype, ``composite_loss(sr.float(),
    hr.float())``, backward, one optimizer step. Gradients are cleared
    (set to None) before the backward, so after a step ``p.grad`` holds
    that step's gradients. Logs are 0-dim tensors on the device, read
    without a host sync: ``{'loss', 'loss/<name>'}``. ``plain`` runs the
    kernels' plain versions (the reference a card run is held against).
    The step runs the model in the mode it is in: ``Trainer.fit`` puts it
    in train mode (srtpu's ``train=True``).
    """
    def train_step(state: TrainState, lr_img: torch.Tensor,
                   hr_img: torch.Tensor) -> dict[str, torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        sr = state.model(lr_img, plain=plain)
        total, parts = composite_loss(sr.float(), hr_img.float())
        total.backward()
        state.optimizer.step()
        state.step += 1
        logs = {'loss': sum(parts.values()).detach()}
        logs.update({f'loss/{k}': v.detach() for k, v in parts.items()})
        return logs

    return train_step


def make_predict_step(model: torch.nn.Module):
    """``lr -> clip(model(lr).float(), 0, 1)`` without autograd, in eval
    mode (srtpu make_predict_step runs ``train=False``: batch norm reads
    its running statistics and leaves them as they are); the model's
    mode is restored after each call."""
    def predict_step(lr: torch.Tensor) -> torch.Tensor:
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode():
                return model(lr).float().clamp(0.0, 1.0)
        finally:
            model.train(was_training)

    return predict_step
