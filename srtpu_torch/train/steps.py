"""Step functions (srtpu/train/steps.py): the train step, the eval and
predict steps, and their tiled forms (the forward in fixed-shape tile
batches, ``train/tiled.py``). The eval and predict steps run the model in
eval mode without autograd; the SR image stays on the model's device and
the metrics are computed there."""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from ..metrics import NO_REFERENCE
from .state import TrainState


def make_train_step(composite_loss, plain: bool = False,
                    remat: bool = False):
    """``train_step(state, lr, hr) -> logs`` (srtpu ``train_step_body``):
    the forward in the model's compute dtype, ``composite_loss(sr.float(),
    hr.float()[, state.loss_params])``, backward, one optimizer step over
    the model's and the loss's parameters. Gradients are cleared (set to
    None) before the backward, so after a step ``p.grad`` holds that
    step's gradients. A parameter the loss does not reach gets a zero
    gradient, not None, as ``jax.grad`` gives srtpu: the optimizer then
    steps it as optax does (Adam's count moves and its moments decay;
    ``torch.optim.Adam`` would skip a parameter without a gradient). A
    DSL whose every term carries no gradient (``edge_loss``,
    ``pencil_sketch``) runs no backward and steps on zeros. Logs are
    0-dim tensors on the device, read without a host sync: ``{'loss',
    'loss/<name>'}``. The update is the state's
    :class:`~srtpu_torch.train.state.Updater` (optax's ``MultiSteps``
    with srtpu's clip chain: the parameters move on every
    ``accumulate_grad_batches``-th step; ``state.step`` counts every
    batch). ``plain`` runs the kernels' plain versions (the reference a
    card run is held against). The step runs the model in the mode it is
    in: ``Trainer.fit`` puts it in train mode (srtpu's ``train=True``).
    ``remat`` runs the model
    forward under ``torch.utils.checkpoint.checkpoint`` (non-reentrant;
    the forward draws no random numbers, so no RNG state is kept): its
    activations are recomputed in the backward, the loss stays outside
    (srtpu's ``jax.checkpoint`` of the forward).
    """
    def train_step(state: TrainState, lr_img: torch.Tensor,
                   hr_img: torch.Tensor) -> dict[str, torch.Tensor]:
        state.optimizer.zero_grad(set_to_none=True)
        if remat:
            sr = torch.utils.checkpoint.checkpoint(
                state.model, lr_img, plain=plain, use_reentrant=False,
                preserve_rng_state=False)
        else:
            sr = state.model(lr_img, plain=plain)
        if state.loss_params is None:
            total, parts = composite_loss(sr.float(), hr_img.float())
        else:
            total, parts = composite_loss(sr.float(), hr_img.float(),
                                          state.loss_params)
        if total.requires_grad:
            total.backward()
        for group in state.optimizer.param_groups:
            for p in group['params']:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        state.updater.apply(state.optimizer)
        state.step += 1
        logs = {'loss': sum(parts.values()).detach()}
        logs.update({f'loss/{k}': v.detach() for k, v in parts.items()})
        return logs

    return train_step


def repeat_step(train_step, k: int):
    """``multi_step(state, lrs, hrs) -> logs``: ``train_step`` on each of
    the window's ``k`` LR and HR batches in order, on the model's device
    (a ``(k, B, ...)`` stack is ``k`` such batches); the last step's
    logs. The eager form of a window: the CPU's, and the card's where a
    CUDA graph cannot take the step (``detect_anomaly``)."""
    if k < 1:
        raise ValueError(f'steps_per_execution must be >= 1, got {k}')

    def multi_step(state: TrainState, lrs, hrs) -> dict[str, torch.Tensor]:
        if len(lrs) != k or len(hrs) != k:
            raise ValueError(f'a window of {k} steps takes {k} batches '
                             f'(k, B, ...), got {len(lrs)} and {len(hrs)}')
        logs = None
        for lr, hr in zip(lrs, hrs):
            logs = train_step(state, lr, hr)
        return logs

    return multi_step


def make_multi_train_step(composite_loss, k: int, remat: bool = False,
                          plain: bool = False):
    """srtpu's ``make_multi_train_step``: ``multi_step(state, lr_stack,
    hr_stack) -> logs``, ``k`` train steps (:func:`make_train_step`'s)
    over a stacked window ``(k, B, ...)`` in order, the last step's logs
    returned. This is the eager form, the reference the card's
    :class:`~srtpu_torch.train.graph.StepGraph` (the same ``k`` steps as
    one CUDA graph) is held to."""
    return repeat_step(make_train_step(composite_loss, plain=plain,
                                       remat=remat), k)


def _eval_forward(model: torch.nn.Module, plain: bool = False):
    """``lr -> model(lr)`` without autograd, in eval mode (srtpu's
    ``train=False``: batch norm reads its running statistics and leaves
    them as they are); the model's mode is restored after each call.
    ``plain`` runs the kernels' plain versions."""
    def forward(lr: torch.Tensor) -> torch.Tensor:
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode():
                return model(lr, plain=plain)
        finally:
            model.train(was_training)

    return forward


def _metric_results(metrics: dict, sr: torch.Tensor, hr: torch.Tensor,
                    mask: torch.Tensor | None):
    """SR and HR clipped to [0, 1] in f32, then ``{name: fn(sr, hr,
    mask)}`` in name order, as srtpu's jitted step returns them (srtpu
    ``_metric_results``); a no-reference metric (BRISQUE) gets the SR
    alone, here the edge-padded bucket (the Trainer scores it again on
    the true shape). Returns (the clipped SR, the 0-dim results)."""
    sr = sr.float().clamp(0.0, 1.0)
    hr = hr.float().clamp(0.0, 1.0)
    with torch.inference_mode():
        return sr, {name: metrics[name](sr) if name in NO_REFERENCE
                    else metrics[name](sr, hr, mask=mask)
                    for name in sorted(metrics)}


def make_predict_step(model: torch.nn.Module, plain: bool = False):
    """``lr -> clip(model(lr).float(), 0, 1)`` without autograd, in eval
    mode (srtpu ``make_predict_step``)."""
    forward = _eval_forward(model, plain)

    def predict_step(lr: torch.Tensor) -> torch.Tensor:
        return forward(lr).float().clamp(0.0, 1.0)

    return predict_step


def make_eval_step(model: torch.nn.Module, metrics: dict,
                   plain: bool = False):
    """``eval_step(lr, hr, mask) -> (sr, {metric: value})``: the direct
    full-image forward, then the masked metrics (srtpu
    ``make_eval_step``)."""
    forward = _eval_forward(model, plain)

    def eval_step(lr, hr, mask):
        return _metric_results(metrics, forward(lr), hr, mask)

    return eval_step


def _tiled_forward(model, plain: bool, scale: int, tile, overlap: int,
                   batch: int):
    """``lr -> sr`` through ``make_tiled_apply`` without autograd."""
    from .tiled import make_tiled_apply
    th, tw = (tile, tile) if isinstance(tile, int) else tile
    tiler = make_tiled_apply(scale, th, tw, overlap, batch)
    forward = _eval_forward(model, plain)

    def tiled(lr: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return tiler(forward, lr)

    return tiled


def make_tiled_eval_step(model: torch.nn.Module, metrics: dict, scale: int,
                         tile: int | tuple[int, int] = 64, overlap: int = 8,
                         batch: int = 16, plain: bool = False):
    """``eval_step`` whose forward runs in batches of at most ``batch``
    (tile_h, tile_w) LR tiles, stitched on the device
    (:func:`~srtpu_torch.train.tiled.make_tiled_apply`), then the metrics
    on the stitched SR (srtpu ``make_tiled_eval_step``)."""
    forward = _tiled_forward(model, plain, scale, tile, overlap, batch)

    def eval_step(lr, hr, mask):
        return _metric_results(metrics, forward(lr), hr, mask)

    return eval_step


def make_tiled_predict_step(model: torch.nn.Module, scale: int,
                            tile: int | tuple[int, int] = 64,
                            overlap: int = 8, batch: int = 16,
                            plain: bool = False):
    """``predict_step`` on the tile-batched forward (srtpu
    ``make_tiled_predict_step``)."""
    forward = _tiled_forward(model, plain, scale, tile, overlap, batch)

    def predict_step(lr: torch.Tensor) -> torch.Tensor:
        return forward(lr).float().clamp(0.0, 1.0)

    return predict_step
