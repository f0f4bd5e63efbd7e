"""Loss registry and the composite-loss DSL (srtpu/losses/__init__.py).

``parse_losses("0.5 * l1 + 0.5 * mse")`` builds a :class:`CompositeLoss`
with srtpu's parsing, error messages and log keys. The registry keeps
srtpu's twelve names; ``l1``, ``mae``, ``l2`` and ``mse`` are ported, and
asking for any other raises ``NotImplementedError`` (ROADMAP.md queue 1,
item 15). No ported loss has trainable parameters.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable

import torch

from .basic import l1_loss, l2_loss

_logger = logging.getLogger(__name__)

PORTED: dict[str, Callable] = {'l1': l1_loss, 'l2': l2_loss, 'mae': l1_loss,
                               'mse': l2_loss}
# srtpu's other registered losses, still to port
NOT_PORTED = ('adaptive', 'dists', 'edge_loss', 'flip', 'haarpsi', 'lpips',
              'pencil_sketch', 'pieapp')


def supported_losses() -> list[str]:
    return sorted((*PORTED, *NOT_PORTED))


@dataclasses.dataclass
class SubLoss:
    name: str
    weight: float
    fn: Callable


class CompositeLoss:
    """Weighted sum of named sub-losses (srtpu ``CompositeLoss``)."""

    def __init__(self, sub_losses: list[SubLoss]):
        self.sub_losses = sub_losses

    @property
    def names(self) -> list[str]:
        return [s.name for s in self.sub_losses]

    def __call__(self, sr: torch.Tensor, hr: torch.Tensor
                 ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """(total, {log key: weighted loss}). The log key is the bare
        name, or ``{i}_{name}`` when the DSL repeats a loss type."""
        counts: dict[str, int] = {}
        for s in self.sub_losses:
            counts[s.name] = counts.get(s.name, 0) + 1
        total = 0.0
        per_loss: dict[str, torch.Tensor] = {}
        for i, s in enumerate(self.sub_losses):
            weighted = s.weight * s.fn(sr, hr)
            per_loss[s.name if counts[s.name] == 1 else f'{i}_{s.name}'] = \
                weighted
            total = total + weighted
        return total, per_loss


def parse_losses(losses_str: str) -> CompositeLoss:
    """Parse ``"w1 * name1 + w2 * name2"`` (srtpu ``parse_losses``)."""
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
        if loss_type in NOT_PORTED:
            raise NotImplementedError(
                f'loss {loss_type!r} is not ported to srtpu_torch yet '
                f'(ROADMAP.md queue 1, item 15); ported: '
                f'{", ".join(sorted(PORTED))}')
        if loss_type not in PORTED:
            raise AttributeError(
                f"Couldn't find loss {loss_type}. Supported losses: "
                f"{', '.join(supported_losses())}")
        _logger.info('%.3f * %s', weight, loss_type)
        subs.append(SubLoss(name=loss_type, weight=weight,
                            fn=PORTED[loss_type]))
    return CompositeLoss(subs)


__all__ = ['CompositeLoss', 'NOT_PORTED', 'PORTED', 'SubLoss', 'l1_loss',
           'l2_loss', 'parse_losses', 'supported_losses']
