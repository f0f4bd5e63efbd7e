"""Optimizer registry and ``optimizer_params`` parsing (srtpu/optim.py).

Every optimizer of srtpu's registry is built here, each computing srtpu's
optax transform over torch parameters updated in place:

* ``ADAM``: ``torch.optim.Adam`` computes optax's ``adam`` update (eps
  outside the square root, bias-corrected moments). On the card it is
  built ``capturable``: its count lives on the device and the bias
  corrections are computed there in f32, so a CUDA graph of the step
  (``train/graph.py``) runs the same arithmetic as the eager step. On
  the CPU the host's double-precision form runs, as before;
* ``SGD``: ``optax.sgd``, heavy-ball momentum without dampening,
  optionally Nesterov;
* ``RMSprop``: optax's ``rmsprop(lr, decay=alpha, eps, momentum)``:
  ``scale_by_rms`` (eps inside the square root, ``rsqrt(nu + eps)``),
  the lr, then optax's ``trace`` of the scaled update (present at
  momentum 0, where it passes the update through);
* ``Ranger`` / ``RangerVA`` / ``RangerQH``: srtpu's ``lookahead`` (slow
  weights synced every ``k`` updates at ``alpha``) around optax's
  ``scale_by_radam`` (below the variance threshold its bias-corrected
  momentum) or, for RangerQH, srtpu's ``scale_by_qhadam``, then the lr;
  RangerVA centralises the gradients first, as srtpu's ``_centralize``
  does on srtpu's own parameter layout (``centralize``, the module
  :func:`srtpu_torch.convert.centralize_plan` gives it per model).

``weight_decay`` adds wd * p to the gradient before the update, as srtpu
chains ``add_decayed_weights`` before the optimizer (not AdamW). The
four optimizers that are not torch's keep their state per parameter
(their count a 0-dim f32 tensor on the parameter's device, optax's one
count repeated), made when the optimizer is built, and branch on the
count with ``torch.where`` only, so nothing in a step reads the device
from the host and a CUDA graph captures it. ``torch.optim.RMSprop`` and
``RAdam`` are not used: their formulas are not optax's.
"""

from __future__ import annotations

from typing import Any, Iterable

import torch


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


def srtpu_centralize_rule(shape) -> tuple | None:
    """srtpu's ``_centralize`` on a tensor of ``shape`` in srtpu's own
    layout, as (the view, the axes of the mean) or None: a 4-D HWIO
    kernel per output channel over (h, w, c_in); a 3-D CS stack (L, 3 a,
    3 b) per (l, row) over the three taps of a column block and the
    columns."""
    shape = tuple(shape)
    if len(shape) == 4:
        return shape, (0, 1, 2)
    if len(shape) == 3 and shape[1] % 3 == 0 and shape[2] % 3 == 0:
        return (shape[0], 3, shape[1] // 3, shape[2]), (1, 3)
    return None


def centralize(g: torch.Tensor, plan: tuple | None) -> torch.Tensor:
    """``g`` less its mean over ``plan``'s axes of ``plan``'s view (a
    new tensor), or ``g`` itself without a plan."""
    if plan is None:
        return g
    view, axes = plan
    v = g.reshape(view)
    return (v - v.mean(axes, keepdim=True)).reshape(g.shape)


class _OptaxOptimizer(torch.optim.Optimizer):
    """An optax chain on torch parameters: :meth:`_update` maps (the
    gradient after weight decay, the parameter, its state) to the update
    added to the parameter (optax ``apply_updates``). Its state is made
    when the optimizer is built (:meth:`_init_state`)."""

    def __init__(self, params, defaults):
        super().__init__(params, defaults)
        for group in self.param_groups:
            for p in group['params']:
                self.state[p] = self._init_state(p, group)

    def _init_state(self, p, group) -> dict:
        raise NotImplementedError

    def _update(self, g, p, st, group) -> torch.Tensor:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            wd = group['weight_decay']
            for p in group['params']:
                if p.grad is None:
                    continue
                g = p.grad
                if wd:
                    g = g + wd * p
                p.add_(self._update(g, p, self.state[p], group))
        return loss


def _count(p) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=p.device)


class RMSprop(_OptaxOptimizer):
    """optax ``rmsprop(lr, decay=alpha, eps, momentum=momentum)``:
    ``nu = (1 - decay) g^2 + decay nu``, ``u = -lr g rsqrt(nu + eps)``,
    ``trace = u + momentum trace``, the update is the trace."""

    def __init__(self, params, lr=1e-2, alpha=0.99, eps=1e-8, momentum=0.0,
                 weight_decay=0.0):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps,
                                      momentum=momentum,
                                      weight_decay=weight_decay))

    def _init_state(self, p, group):
        return {'nu': torch.zeros_like(p), 'trace': torch.zeros_like(p)}

    def _update(self, g, p, st, group):
        decay = group['alpha']
        st['nu'].copy_((1 - decay) * (g * g) + decay * st['nu'])
        u = torch.rsqrt(st['nu'] + group['eps']) * g * (-group['lr'])
        st['trace'].copy_(u + group['momentum'] * st['trace'])
        return st['trace']


class _Lookahead(_OptaxOptimizer):
    """srtpu's ``lookahead`` around an inner update (:meth:`_inner`):
    the count moves each update; on every ``k``-th the slow weights move
    ``alpha`` of the way to the fast ones (``p + u``) and the update
    takes the parameter there."""

    def _init_state(self, p, group):
        return {'count': _count(p), 'slow': p.detach().clone(),
                **self._inner_state(p)}

    def _inner_state(self, p) -> dict:
        raise NotImplementedError

    def _inner(self, g, st, group, count) -> torch.Tensor:
        raise NotImplementedError

    def _update(self, g, p, st, group):
        count = st['count']
        count.add_(1)
        u = self._inner(g, st, group, count) * (-group['lr'])
        sync = torch.remainder(count, group['k']) == 0
        slow = st['slow']
        synced = slow + group['alpha'] * (p + u - slow)
        u = torch.where(sync, synced - p, u)
        slow.copy_(torch.where(sync, synced, slow))
        return u


class Ranger(_Lookahead):
    """Lookahead over optax's ``scale_by_radam(b1, b2, eps)``: RAdam's
    rectified step where the variance is tractable (``ro >= 5``), else
    its bias-corrected momentum."""

    def __init__(self, params, lr=1e-3, betas=(0.95, 0.999), eps=1e-5, k=6,
                 alpha=0.5, weight_decay=0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      k=k, alpha=alpha,
                                      weight_decay=weight_decay))

    def _inner_state(self, p):
        return {'mu': torch.zeros_like(p), 'nu': torch.zeros_like(p)}

    def _inner(self, g, st, group, count):
        b1, b2 = group['betas']
        mu, nu = st['mu'], st['nu']
        mu.copy_((1 - b1) * g + b1 * mu)
        nu.copy_((1 - b2) * (g * g) + b2 * nu)
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = torch.pow(b2, count)
        ro = ro_inf - 2 * count * b2t / (1 - b2t)
        mu_hat = mu / (1 - torch.pow(b1, count))
        nu_hat = nu / (1 - b2t)
        r = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                       / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
        rect = r * mu_hat / (torch.sqrt(nu_hat) + group['eps'])
        return torch.where(ro >= 5.0, rect, mu_hat)


class RangerVA(Ranger):
    """:class:`Ranger` on centralised gradients: ``centralize``
    ``{parameter: (view, axes)}`` says where srtpu's ``_centralize``
    takes each mean on srtpu's layout of that parameter; a parameter not
    in it takes srtpu's rule on its own shape
    (:func:`srtpu_centralize_rule`)."""

    def __init__(self, params, centralize=None, **kw):
        params = list(params)
        plans = dict(centralize or {})
        self._plans = {p: plans[p] if p in plans
                       else srtpu_centralize_rule(p.shape) for p in params}
        super().__init__(params, **kw)

    def _update(self, g, p, st, group):
        return super()._update(centralize(g, self._plans[p]), p, st, group)


class RangerQH(_Lookahead):
    """Lookahead over srtpu's ``scale_by_qhadam(b1, b2, nu1, nu2, eps)``:
    ``(nu1 m_hat + (1 - nu1) g) / (sqrt(nu2 v_hat + (1 - nu2) g^2) +
    eps)``."""

    def __init__(self, params, lr=1e-3, betas=(0.95, 0.999), nus=(0.7, 1.0),
                 eps=1e-5, k=6, alpha=0.5, weight_decay=0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas),
                                      nus=tuple(nus), eps=eps, k=k,
                                      alpha=alpha,
                                      weight_decay=weight_decay))

    def _inner_state(self, p):
        return {'m': torch.zeros_like(p), 'v': torch.zeros_like(p)}

    def _inner(self, g, st, group, count):
        b1, b2 = group['betas']
        nu1, nu2 = group['nus']
        m, v = st['m'], st['v']
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        m_hat = m / (1 - torch.pow(b1, count))
        v_hat = v / (1 - torch.pow(b2, count))
        num = nu1 * m_hat + (1 - nu1) * g
        den = torch.sqrt(nu2 * v_hat + (1 - nu2) * g * g) + group['eps']
        return num / den


def build_optimizer(name: str, params: dict[str, Any] | list[str] | None,
                    parameters: Iterable[torch.nn.Parameter],
                    centralize: dict | None = None
                    ) -> torch.optim.Optimizer:
    """The optimizer ``name`` with parsed ``params`` over ``parameters``,
    with srtpu's defaults (lr 1e-2 for ``SGD`` and ``RMSprop`` as
    written, else 1e-3). Parameters the optimizer does not take raise,
    as in srtpu. ``centralize`` is RangerVA's ``{parameter: (view,
    axes)}`` (:class:`RangerVA`); the others ignore it."""
    kw = parse_optimizer_params(params) if not isinstance(params, dict) \
        else dict(params or {})
    parameters = list(parameters)
    key = name.lower()
    # srtpu picks the default from the name as written: 'sgd' gets 1e-3
    lr = kw.pop('lr', 1e-3 if name not in ('SGD', 'RMSprop') else 1e-2)
    weight_decay = kw.pop('weight_decay', 0.0)
    if key == 'adam':
        betas = kw.pop('betas', (0.9, 0.999))
        cuda = any(p.is_cuda for p in parameters)
        cls, args = torch.optim.Adam, dict(betas=(betas[0], betas[1]),
                                           eps=kw.pop('eps', 1e-8),
                                           capturable=cuda)
    elif key == 'sgd':
        momentum = kw.pop('momentum', 0.0)
        # optax's Nesterov trace at momentum 0 is plain SGD; torch's SGD
        # refuses nesterov without momentum
        cls, args = torch.optim.SGD, dict(
            momentum=momentum,
            nesterov=bool(kw.pop('nesterov', False)) and momentum != 0)
    elif key == 'rmsprop':
        cls, args = RMSprop, dict(alpha=kw.pop('alpha', 0.99),
                                  eps=kw.pop('eps', 1e-8),
                                  momentum=kw.pop('momentum', 0.0))
    elif key in ('ranger', 'rangerva', 'rangerqh'):
        args = dict(betas=kw.pop('betas', (0.95, 0.999)),
                    eps=kw.pop('eps', 1e-5), k=int(kw.pop('k', 6)),
                    alpha=kw.pop('alpha', 0.5))
        if key == 'rangerqh':
            cls = RangerQH
            args['nus'] = kw.pop('nus', (0.7, 1.0))
        elif key == 'rangerva':
            cls = RangerVA
            args['centralize'] = centralize
        else:
            cls = Ranger
    else:
        raise ValueError(
            f'Optimizer not recognized: {name}. Supported optimizers: '
            f'{", ".join(supported_optimizers())}')
    if kw:
        raise ValueError(
            f'optimizer params not supported by {name}: {sorted(kw)}')
    opt = cls(parameters, lr=lr, weight_decay=weight_decay, **args)
    if key == 'adam' and args['capturable']:
        # eager steps on the card run capturable too (module note): no
        # warning that they are not captured
        opt._warned_capturable_if_run_uncaptured = True
    return opt
