"""Optimizer registry and ``optimizer_params`` parsing (srtpu/optim.py).

``ADAM`` and ``SGD`` are ported: ``torch.optim.Adam`` computes optax's
``adam`` update (eps outside the square root, bias-corrected moments),
and ``weight_decay`` adds wd * p to the gradient before the update, as
srtpu chains ``add_decayed_weights`` before the optimizer (not AdamW).
``SGD`` is ``optax.sgd``: heavy-ball momentum without dampening,
optionally Nesterov. RMSprop and the Ranger family raise
``NotImplementedError`` (ROADMAP.md queue 1, item 16).
"""

from __future__ import annotations

from typing import Any, Iterable

import torch

NOT_PORTED = ('RMSprop', 'Ranger', 'RangerQH', 'RangerVA')


def supported_optimizers() -> list[str]:
    return ['ADAM', 'RMSprop', 'Ranger', 'RangerQH', 'RangerVA', 'SGD']


def parse_optimizer_params(params: list[str] | None) -> dict[str, Any]:
    """Parse ``["lr=1e-4", "betas=0.9,0.99"]`` (srtpu semantics)."""
    out: dict[str, Any] = {}
    for param in params or []:
        name, value = param.strip().split('=')
        name = name.strip()
        if name in ('eps', 'lr', 'lr_decay', 'weight_decay', 'momentum',
                    'alpha'):
            out[name] = float(value)
        elif name in ('betas', 'nus'):
            out[name] = tuple(float(v) for v in value.split(','))
        elif name in ('k', 'sync_period'):
            out['k'] = int(value)
        elif name == 'nesterov':
            out[name] = value.strip().lower() in ('1', 'true', 'yes')
        else:
            out[name] = value
    return out


def build_optimizer(name: str, params: dict[str, Any] | list[str] | None,
                    parameters: Iterable[torch.nn.Parameter]
                    ) -> torch.optim.Optimizer:
    """The optimizer ``name`` with parsed ``params`` over ``parameters``,
    with srtpu's defaults (lr 1e-2 for ``SGD`` as written, else 1e-3).
    Parameters the optimizer does not take raise, as in srtpu."""
    kw = parse_optimizer_params(params) if not isinstance(params, dict) \
        else dict(params or {})
    key = name.lower()
    if name in NOT_PORTED or key in {n.lower() for n in NOT_PORTED}:
        raise NotImplementedError(
            f'optimizer {name} is not ported to srtpu_torch yet (ROADMAP.md '
            f'queue 1, item 16); ported: ADAM, SGD')
    # srtpu picks the default from the name as written: 'sgd' gets 1e-3
    lr = kw.pop('lr', 1e-3 if name not in ('SGD', 'RMSprop') else 1e-2)
    weight_decay = kw.pop('weight_decay', 0.0)
    if key == 'adam':
        betas = kw.pop('betas', (0.9, 0.999))
        cls, args = torch.optim.Adam, dict(betas=(betas[0], betas[1]),
                                           eps=kw.pop('eps', 1e-8))
    elif key == 'sgd':
        momentum = kw.pop('momentum', 0.0)
        # optax's Nesterov trace at momentum 0 is plain SGD; torch's SGD
        # refuses nesterov without momentum
        cls, args = torch.optim.SGD, dict(
            momentum=momentum,
            nesterov=bool(kw.pop('nesterov', False)) and momentum != 0)
    else:
        raise ValueError(
            f'Optimizer not recognized: {name}. Supported optimizers: '
            f'{", ".join(supported_optimizers())}')
    if kw:
        raise ValueError(
            f'optimizer params not supported by {name}: {sorted(kw)}')
    return cls(list(parameters), lr=lr, weight_decay=weight_decay, **args)
