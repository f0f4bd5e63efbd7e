"""Loss registry and the composite-loss DSL (srtpu/losses/__init__.py).

``parse_losses("0.5 * l1 + 0.5 * adaptive")`` builds a
:class:`CompositeLoss` with srtpu's parsing, error messages and log keys
from srtpu's twelve names: ``adaptive`` (trainable, ``adaptive.py``),
``dists``, ``lpips`` (VGG16, ``vgg.py``), ``edge_loss``, ``flip``,
``haarpsi``, ``l1`` / ``mae``, ``l2`` / ``mse``, ``pencil_sketch`` and
``pieapp``. A loss is built only when the DSL names it. Per srtpu's
dispatch, ``haarpsi`` and ``pieapp`` see the SR clipped to [0, 1] (with
JAX's gradient at the bounds), and a trainable loss reads its
parameters, keyed ``{i}_{name}``, from the ``loss_params`` the call is
given (the train state owns them and optimises them with the model).
``edge_loss`` and ``pencil_sketch`` carry no gradient. The perceptual
losses run on srtpu's random init unless converted weights are on disk
(``vgg.py``). SRGAN's adversarial step uses :func:`gan_loss`,
:func:`tv_loss` and :class:`VGGLoss` outside the DSL, as srtpu's does.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable

import torch

from .adaptive import AdaptiveLoss
from .basic import clip, l1_loss, l2_loss, tv_loss
from .edge import edge_loss, extract_edges
from .flip import flip, flip_loss
from .gan import gan_loss
from .haarpsi import haarpsi, haarpsi_loss
from .pencil_sketch import pencil_sketch, pencil_sketch_loss
from .vgg import DISTS, LPIPS, VGGLoss

_logger = logging.getLogger(__name__)


@dataclasses.dataclass
class SubLoss:
    name: str
    weight: float
    fn: Any             # fn(sr, hr), or fn(sr, hr, params) when trainable
    trainable: bool = False
    clamp_sr: bool = False

    def init_params(self) -> dict[str, torch.Tensor] | None:
        if self.trainable and hasattr(self.fn, 'init'):
            return self.fn.init()
        return None


def _pieapp():
    from .pieapp import PieAPP      # its 58M-weight head: only when named
    return PieAPP()


def _loss_factories() -> dict[str, Callable[[], Any]]:
    return {
        'adaptive': lambda: AdaptiveLoss(num_levels=2),
        'dists': DISTS,
        'edge_loss': lambda: edge_loss,
        'flip': lambda: flip_loss,
        'haarpsi': lambda: haarpsi_loss,
        'l1': lambda: l1_loss,
        'l2': lambda: l2_loss,
        'lpips': LPIPS,
        'mae': lambda: l1_loss,
        'mse': lambda: l2_loss,
        'pencil_sketch': lambda: pencil_sketch_loss,
        'pieapp': _pieapp,
    }


def supported_losses() -> list[str]:
    return sorted(_loss_factories())


class CompositeLoss:
    """Weighted sum of named sub-losses (srtpu ``CompositeLoss``)."""

    def __init__(self, sub_losses: list[SubLoss]):
        self.sub_losses = sub_losses

    @property
    def names(self) -> list[str]:
        return [s.name for s in self.sub_losses]

    @property
    def has_trainable(self) -> bool:
        return any(s.trainable for s in self.sub_losses)

    def init_params(self) -> dict[str, dict[str, torch.Tensor]]:
        """The trainable losses' initial parameters, keyed ``{i}_{name}``
        (deterministic: srtpu's draw no random numbers)."""
        params = {}
        for i, s in enumerate(self.sub_losses):
            p = s.init_params()
            if p is not None:
                params[f'{i}_{s.name}'] = p
        return params

    def __call__(self, sr: torch.Tensor, hr: torch.Tensor, loss_params=None
                 ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """(total, {log key: weighted loss}). The log key is the bare
        name, or ``{i}_{name}`` when the DSL repeats a loss type.
        ``loss_params`` maps ``{i}_{name}`` to a trainable loss's
        parameters."""
        loss_params = loss_params if loss_params is not None else {}
        counts: dict[str, int] = {}
        for s in self.sub_losses:
            counts[s.name] = counts.get(s.name, 0) + 1
        total = 0.0
        per_loss: dict[str, torch.Tensor] = {}
        for i, s in enumerate(self.sub_losses):
            x = clip(sr, 0.0, 1.0) if s.clamp_sr else sr
            key = f'{i}_{s.name}'
            value = s.fn(x, hr, loss_params[key]) if s.trainable \
                else s.fn(x, hr)
            weighted = s.weight * value
            per_loss[s.name if counts[s.name] == 1 else key] = weighted
            total = total + weighted
        return total, per_loss


def parse_losses(losses_str: str) -> CompositeLoss:
    """Parse ``"w1 * name1 + w2 * name2"`` (srtpu ``parse_losses``)."""
    factories = _loss_factories()
    subs = []
    for term in losses_str.split('+'):
        parts = term.split('*')
        if len(parts) > 2:
            raise ValueError(
                f'malformed loss term {term.strip()!r}: expected '
                f'"weight * name" or "name"')
        if len(parts) == 2:
            weight_str, loss_type = parts
            try:
                weight = float(weight_str)
            except ValueError:
                raise ValueError(
                    f'{weight_str!r} is not a valid number to be used as '
                    f'weight for loss function {loss_type.strip()}')
        else:
            weight, loss_type = 1.0, parts[0]
        loss_type = loss_type.strip().lower()
        if loss_type not in factories:
            raise AttributeError(
                f"Couldn't find loss {loss_type}. Supported losses: "
                f"{', '.join(supported_losses())}")
        fn = factories[loss_type]()
        _logger.info('%.3f * %s', weight, loss_type)
        subs.append(SubLoss(name=loss_type, weight=weight, fn=fn,
                            trainable=getattr(fn, 'trainable', False),
                            clamp_sr=loss_type in ('haarpsi', 'pieapp')))
    return CompositeLoss(subs)


__all__ = ['AdaptiveLoss', 'CompositeLoss', 'DISTS', 'LPIPS', 'SubLoss',
           'VGGLoss', 'edge_loss', 'extract_edges', 'flip', 'flip_loss',
           'gan_loss', 'haarpsi', 'haarpsi_loss', 'l1_loss', 'l2_loss',
           'parse_losses', 'pencil_sketch', 'pencil_sketch_loss',
           'supported_losses', 'tv_loss']
