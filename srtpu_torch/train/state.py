"""TrainState: the model, the trainable losses' parameters, their one
optimizer and the step count (srtpu ``train/state.py``). PyTorch updates
the parameters in place, so the state is one mutable object that the
train step advances. The loss parameters (the adaptive loss's latents,
:func:`loss_parameters`) are ``nn.Parameter`` s in a ``ParameterDict``
keyed ``{i}_{name}`` as srtpu's ``loss_params``; the optimizer runs over
the model's parameters and theirs together, as srtpu's ``tx`` runs over
``{'model', 'loss'}``, so gradient clipping's global norm covers both.

:class:`Updater` is what srtpu's Trainer wraps around its optax
optimizer: ``optax.MultiSteps(chain(clip, tx), k)`` (srtpu
``train/loop.py:104-123``, ``:188-191``). Each mini-step folds the
batch's gradients into a running mean (MultiSteps' Welford update,
``acc + (g - acc) / (n + 1)``); every ``k``-th one clips that mean
(``norm``: by the global L2 norm, optax ``clip_by_global_norm``;
``value``: elementwise, optax ``clip``) and takes one optimizer step.
On the other mini-steps the parameters and the optimizer's state stay
as they are, and the state's ``step`` still counts the batch, as
srtpu's ``TrainState.apply_gradients`` does.

A checkpoint (:func:`state_to_tree`) is a dict of tensors and numbers:
``step``, the model's full ``state_dict`` (buffers too: batch norm's
running statistics) under ``model``, the loss parameters under
``loss_params`` (``{i}_{name}.{latent}``; empty without a trainable
loss, and a checkpoint without the entry loads as empty), and under
``opt_state`` one entry
per optimizer (``model``; an SRGAN's ``g`` and ``d``, as srtpu's
combined view) with its type, its per-parameter state keyed by the
parameter's name in ``model`` (a loss parameter's:
``loss_params.{i}_{name}.{latent}``) rather than by index (Adam's
``step``, ``exp_avg``, ``exp_avg_sq``; SGD's ``momentum_buffer``;
RMSprop's ``nu`` and ``trace``; the Ranger family's ``count``, ``slow``
and moments), the accumulator's ``mini_step`` and ``acc_grads``, and a
learning-rate schedule's state. Restoring replaces the optimizer's and
the accumulator's tensors: a CUDA graph captured before it is dropped
(:class:`~srtpu_torch.train.graph.StepGraph`).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import torch

_logger = logging.getLogger(__name__)

CLIP_ALGORITHMS = ('norm', 'value')


def check_clip_algorithm(algorithm: str | None) -> str:
    """``algorithm`` in lower case; anything but ``norm`` and ``value``
    raises srtpu's ``ValueError``."""
    algo = (algorithm or 'norm').lower()
    if algo not in CLIP_ALGORITHMS:
        raise ValueError(f"gradient_clip_algorithm must be 'norm' or "
                         f"'value', got {algo!r}")
    return algo


@dataclass
class Updater:
    """optax ``MultiSteps(chain(clip, tx), every)`` on a torch optimizer:
    :meth:`apply` after each backward (module note). ``every`` 1 and no
    ``clip_val`` is the plain ``optimizer.step()``."""
    every: int = 1
    clip_val: float | None = None
    clip_algorithm: str = 'norm'
    mini_step: int = 0
    acc_grads: list[torch.Tensor] | None = None

    def __post_init__(self):
        if self.clip_val:           # srtpu checks it only when clipping
            self.clip_algorithm = check_clip_algorithm(self.clip_algorithm)
        if self.every < 1:
            raise ValueError(f'accumulate_grad_batches must be >= 1, got '
                             f'{self.every}')

    def _clip(self, grads: list[torch.Tensor]) -> None:
        val = self.clip_val
        if not val:
            return
        val = float(val)
        if self.clip_algorithm == 'value':
            for g in grads:
                g.clamp_(-val, val)
            return
        # optax clip_by_global_norm: t / norm * max where norm >= max
        norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        keep = norm < val
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * val))

    def apply(self, optimizer: torch.optim.Optimizer,
              schedule=None) -> bool:
        """Fold this mini-step's ``p.grad`` in; on every ``every``-th,
        clip, step ``optimizer`` (and ``schedule``). Returns whether the
        parameters moved."""
        if self.every == 1 and not self.clip_val:
            self._step(optimizer, schedule)
            return True
        params = [p for g in optimizer.param_groups for p in g['params']]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if self.every == 1:
            self._clip(grads)
            for p, g in zip(params, grads):
                p.grad = g
            self._step(optimizer, schedule)
            return True
        if self.acc_grads is None:
            self.acc_grads = [torch.zeros_like(p) for p in params]
        n = self.mini_step
        for acc, g in zip(self.acc_grads, grads):
            acc.add_((g - acc) / (n + 1))
        self.mini_step = (n + 1) % self.every
        if self.mini_step:
            return False
        for p, acc in zip(params, self.acc_grads):
            p.grad = acc.clone()
        self._clip([p.grad for p in params])
        self._step(optimizer, schedule)
        for acc in self.acc_grads:
            acc.zero_()
        return True

    @staticmethod
    def _step(optimizer, schedule) -> None:
        optimizer.step()
        if schedule is not None:
            schedule.step()


def loss_parameters(composite, device=None
                    ) -> torch.nn.ParameterDict | None:
    """The trainable losses' initial parameters of ``composite`` (a
    :class:`~srtpu_torch.losses.CompositeLoss`) as a ``ParameterDict`` of
    ``ParameterDict`` s on ``device``, or None without a trainable loss."""
    if not getattr(composite, 'has_trainable', False):
        return None
    return torch.nn.ParameterDict({
        key: torch.nn.ParameterDict({
            k: torch.nn.Parameter(v.to(device)) for k, v in p.items()})
        for key, p in composite.init_params().items()})


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    updater: Updater = field(default_factory=Updater)
    loss_params: torch.nn.ParameterDict | None = None

    @classmethod
    def create(cls, model: torch.nn.Module, composite, optimizer_name: str,
               optimizer_params, updater: Updater | None = None):
        """The state of ``model`` trained on ``composite``: the trainable
        losses' initial parameters on the model's device, one optimizer
        over the model's parameters and theirs (srtpu
        ``TrainState.create``)."""
        from ..optim import build_optimizer
        loss_params = loss_parameters(composite,
                                      next(model.parameters()).device)
        params = list(model.parameters()) + (
            [] if loss_params is None else list(loss_params.parameters()))
        centralize = None
        if optimizer_name.lower() == 'rangerva':
            # srtpu's centralisation on its own layout of each parameter;
            # the loss's latents take its rule on their own shapes
            from ..convert import centralize_plan
            named = dict(model.named_parameters())
            centralize = {named[n]: v
                          for n, v in centralize_plan(model).items()}
        return cls(model, build_optimizer(optimizer_name, optimizer_params,
                                          params, centralize),
                   updater=updater or Updater(), loss_params=loss_params)

    def optimizers(self) -> dict:
        """``{key: (optimizer, schedule, updater)}`` as the checkpoint
        keys them."""
        return {'model': (self.optimizer, None, self.updater)}

    def modules(self) -> dict[str, torch.nn.Module]:
        """``{prefix: module}``: the modules whose state_dicts, each key
        under ``prefix``, make the checkpoint's ``model``."""
        return {'': self.model}


def _named(state) -> dict[str, torch.Tensor]:
    """The checkpoint's ``model`` entries of ``state``."""
    out = {}
    for prefix, module in state.modules().items():
        out.update({prefix + k: v for k, v in module.state_dict().items()})
    return out


def _loss_named(state) -> dict[str, torch.Tensor]:
    """The checkpoint's ``loss_params`` entries of ``state``."""
    lp = getattr(state, 'loss_params', None)
    return {} if lp is None else dict(lp.state_dict())


LOSS_PREFIX = 'loss_params.'


def _param_names(state) -> dict[int, str]:
    """id(parameter) -> its name in the checkpoint's ``model``, or
    ``loss_params.`` and its name in ``loss_params``."""
    names = {id(p): prefix + name
             for prefix, module in state.modules().items()
             for name, p in module.named_parameters()}
    lp = getattr(state, 'loss_params', None)
    if lp is not None:
        names.update({id(p): LOSS_PREFIX + name
                      for name, p in lp.named_parameters()})
    return names


def _opt_tree(opt, schedule, updater: Updater, names: dict) -> dict:
    params = [p for g in opt.param_groups for p in g['params']]
    sd = opt.state_dict()
    state = {names[id(p)]: {k: (v.detach().cpu().clone()
                                if torch.is_tensor(v) else v)
                            for k, v in sd['state'][i].items()}
             for i, p in enumerate(params) if i in sd['state']}
    tree = {'type': type(opt).__name__,
            'params': [names[id(p)] for p in params],
            'state': state, 'mini_step': updater.mini_step,
            'acc_grads': None if updater.acc_grads is None else {
                names[id(p)]: a.detach().cpu().clone()
                for p, a in zip(params, updater.acc_grads)}}
    if schedule is not None:
        tree['schedule'] = schedule.state_dict()
    return tree


def state_to_tree(state) -> dict:
    """The checkpoint of ``state`` (a :class:`TrainState` or an SRGAN's
    ``GANTrainState``), on the CPU (module note)."""
    names = _param_names(state)
    return {'step': int(state.step),
            'model': {k: v.detach().cpu().clone()
                      for k, v in _named(state).items()},
            'loss_params': {k: v.detach().cpu().clone()
                            for k, v in _loss_named(state).items()},
            'opt_state': {key: _opt_tree(opt, sched, upd, names)
                          for key, (opt, sched, upd)
                          in state.optimizers().items()}}


def _same_structure(state, tree: dict) -> bool:
    """The stored optimizers are the live ones: the same keys, types and
    parameter sets (by name and shape; the order is the live one's)."""
    stored, live = tree.get('opt_state') or {}, state.optimizers()
    if set(stored) != set(live):
        return False
    names = _param_names(state)
    shapes = {k: tuple(v.shape) for k, v in tree['model'].items()}
    shapes.update({LOSS_PREFIX + k: tuple(v.shape)
                   for k, v in tree.get('loss_params', {}).items()})
    for key, (opt, _, _) in live.items():
        params = [p for g in opt.param_groups for p in g['params']]
        ours = [names[id(p)] for p in params]
        if stored[key]['type'] != type(opt).__name__ or \
                sorted(stored[key]['params']) != sorted(ours) or \
                any(shapes.get(n) != tuple(p.shape)
                    for n, p in zip(ours, params)):
            return False
    return True


def _load_opt(opt, schedule, updater: Updater, tree: dict,
              names: dict) -> None:
    params = [p for g in opt.param_groups for p in g['params']]
    index = {names[id(p)]: i for i, p in enumerate(params)}
    sd = opt.state_dict()
    sd['state'] = {index[n]: dict(st) for n, st in tree['state'].items()}
    opt.load_state_dict(sd)         # casts to each parameter's device
    updater.mini_step = int(tree['mini_step'])
    acc = tree.get('acc_grads')
    updater.acc_grads = None if acc is None else [
        acc[names[id(p)]].to(p.device, p.dtype).clone() for p in params]
    if schedule is not None and 'schedule' in tree:
        schedule.load_state_dict(tree['schedule'])


def tree_to_state(state, tree: dict):
    """Load ``tree`` into ``state`` in place and return it. A parameter
    set that does not match the model's raises srtpu's named
    ``ValueError``; optimizers of another structure are left fresh, with
    srtpu's warning (srtpu ``checkpoint._tree_to_state``)."""
    live = {k: tuple(v.shape) for k, v in _named(state).items()}
    stored = {k: tuple(v.shape) for k, v in tree['model'].items()}
    if live != stored:
        missing = sorted(k for k in live if k not in stored)[:3]
        extra = sorted(k for k in stored if k not in live)[:3]
        shaped = sorted(k for k in live if k in stored
                        and live[k] != stored[k])[:3]
        raise ValueError(
            "checkpoint parameter tree does not match the model's "
            f'(checkpoint lacks e.g. {missing}, has e.g. {extra}, differs '
            f'in shape at e.g. {shaped}). Most likely the checkpoint was '
            'trained with another model or size than this one: rebuild '
            "the model from the checkpoint's hparams.json, or convert an "
            'srtpu state with python -m srtpu_torch.convert --state.')
    live_lp = {k: tuple(v.shape) for k, v in _loss_named(state).items()}
    stored_lp = {k: tuple(v.shape)
                 for k, v in tree.get('loss_params', {}).items()}
    if live_lp != stored_lp:
        raise ValueError(
            f"checkpoint loss parameters {sorted(stored_lp)} do not match "
            f"the loss's {sorted(live_lp)}: the checkpoint was trained with "
            'another --losses than this one')
    for prefix, module in state.modules().items():
        module.load_state_dict({k[len(prefix):]: v
                                for k, v in tree['model'].items()
                                if k.startswith(prefix)})
    if live_lp:
        state.loss_params.load_state_dict(tree['loss_params'])
    if _same_structure(state, tree):
        names = _param_names(state)
        for key, (opt, sched, upd) in state.optimizers().items():
            _load_opt(opt, sched, upd, tree['opt_state'][key], names)
    else:
        _logger.warning('optimizer state structure mismatch on restore; '
                        'keeping freshly initialized optimizer state')
    state.step = int(tree['step'])
    return state
