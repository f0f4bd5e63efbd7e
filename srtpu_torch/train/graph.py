"""StepGraph: the card's form of srtpu's ``make_multi_train_step`` (srtpu
``train/steps.py:84-103``), ``k`` consecutive train steps captured as one
``torch.cuda.CUDAGraph`` and replayed once a window: one dispatch from
the host per ``k`` steps, as srtpu's ``lax.scan`` inside one jitted call.

A window is ``k`` LR and ``k`` HR batches on the card (the loader's;
a ``(k, B, ...)`` stack is ``k`` such batches). Its steps are
:func:`~srtpu_torch.train.steps.make_train_step`'s, so the graph runs
the kernels' forward and backward launches, the loss and the optimizer
exactly as the eager step does; :func:`~srtpu_torch.train.steps
.repeat_step` is the eager form it is held to.

* The first window of each key runs its ``k`` steps eagerly on a side
  stream: that is PyTorch's warm-up before a capture (lazy
  initialisation, cuDNN's and cuBLAS's handles, the kernels' build), and
  they are that window's real steps, counted and logged, on its batches.
  Then the same ``k`` steps are captured (capture runs nothing on the
  device) and every later window of the key is one stacking launch of
  its ``k`` LR and of its ``k`` HR batches into the graph's static
  buffers, and one replay. The capture holds
  ``data.pipeline.capture_lock``: a loader's producer thread makes no
  CUDA call while it runs. The
  graph's static outputs are the last step's logs (returned as copies).
* The key is the accumulator's phase at the window's start (the
  :class:`~srtpu_torch.train.state.Updater`'s ``mini_step``; at most
  ``every / gcd(k, every)`` phases occur) and the stacks' shapes: a
  graph of ``k`` steps freezes which of them steps the optimizer. The
  Python mirrors of the phase and of ``state.step`` move by ``k`` after
  each replay.
* A graph writes into the tensors it captured. It is captured only when
  the optimizer's state exists (Adam's moments, SGD's momentum buffer,
  the accumulator's ``acc_grads``; a window before that runs eagerly),
  and every window first checks that the parameters, buffers, optimizer
  state and accumulator are the tensors it captured: if the state was
  reloaded (``load_state_dict`` replaces them), the graphs are dropped
  and made again.
* The kernels' launch counters (``launches*`` and ``calls`` on the
  wrappers in ``srtpu_torch.ops``) count host calls, which a replay does
  not make: the change a capture made is recorded (and taken back: the
  capture launched nothing) and added again after each replay.

A capture that fails raises (a host sync or a host-to-device copy inside
the step, an op that cannot be captured); there is no eager fallback.
``captures``, ``replays`` and ``eager_windows`` count what ran.
"""

from __future__ import annotations

import inspect
import sys
from dataclasses import dataclass

import torch

from ..data.pipeline import capture_lock


def _counter_attrs(fn) -> list[str]:
    return [a for a, v in vars(fn).items()
            if (a.startswith('launches') or a == 'calls')
            and isinstance(v, int) and not isinstance(v, bool)]


def launch_counters() -> list[tuple]:
    """Every launch counter of the port's kernels, (wrapper, attribute),
    from the loaded ``srtpu_torch.ops`` modules."""
    seen, out = set(), []
    for name, mod in list(sys.modules.items()):
        if not name.startswith('srtpu_torch.ops') or mod is None:
            continue
        for obj in vars(mod).values():
            if inspect.isfunction(obj) and id(obj) not in seen:
                seen.add(id(obj))
                out.extend((obj, a) for a in _counter_attrs(obj))
    return out


def _read(counters) -> list[int]:
    return [getattr(fn, a) for fn, a in counters]


def _captured_tensors(state) -> list[torch.Tensor]:
    """The tensors a graph of ``state``'s step writes in place: the
    modules' parameters and buffers, the loss's parameters, every
    optimizer's state and the accumulators' running means."""
    out = [t for m in state.modules().values()
           for t in (*m.parameters(), *m.buffers())]
    lp = getattr(state, 'loss_params', None)
    if lp is not None:
        out.extend(lp.parameters())
    for opt, _, updater in state.optimizers().values():
        for group in opt.param_groups:
            for p in group['params']:
                out.extend(v for v in opt.state.get(p, {}).values()
                           if torch.is_tensor(v))
        out.extend(updater.acc_grads or ())
    return out


def state_ready(state) -> bool:
    """Whether every optimizer's state exists, so that no step would
    make it (a graph would make it anew at each replay): Adam's moments,
    SGD's momentum buffer where it keeps one, the accumulator's
    ``acc_grads`` where it accumulates. The port's RMSprop and Ranger
    family make theirs when they are built."""
    for opt, _, updater in state.optimizers().values():
        if updater.every > 1 and updater.acc_grads is None:
            return False
        for group in opt.param_groups:
            keeps = isinstance(opt, torch.optim.Adam) or (
                isinstance(opt, torch.optim.SGD) and group['momentum'])
            if keeps and any(not opt.state.get(p) for p in group['params']):
                return False
    return True


@dataclass
class _Captured:
    graph: torch.cuda.CUDAGraph
    lr: torch.Tensor                    # the static input stacks
    hr: torch.Tensor
    logs: dict                          # the last step's logs
    delta: list[tuple]                  # (wrapper, counter, its change)
    tensors: list                       # what it writes in place

    def valid(self, state) -> bool:
        now = _captured_tensors(state)
        return len(now) == len(self.tensors) and all(
            a is b for a, b in zip(now, self.tensors))


class StepGraph:
    """``graph_step(state, lrs, hrs) -> logs``: ``k`` steps of
    ``train_step`` a window, replayed from CUDA graphs (module note).
    ``lrs`` and ``hrs`` are ``k`` batches each, on the card, where
    ``state`` lies."""

    def __init__(self, train_step, k: int):
        if k < 1:
            raise ValueError(f'steps_per_execution must be >= 1, got {k}')
        self.step, self.k = train_step, k
        self.graphs: dict[tuple, _Captured] = {}
        self.captures = self.replays = self.eager_windows = 0

    def _key(self, state, lrs, hrs) -> tuple:
        phases = tuple(u.mini_step for _, _, u in state.optimizers().values())
        return (phases, (len(lrs), *lrs[0].shape), (len(hrs), *hrs[0].shape),
                lrs[0].dtype, hrs[0].dtype)

    def __call__(self, state, lrs, hrs) -> dict[str, torch.Tensor]:
        k = self.k
        if len(lrs) != k or len(hrs) != k:
            raise ValueError(f'a window of {k} steps takes {k} batches '
                             f'(k, B, ...), got {len(lrs)} and {len(hrs)}')
        device = next(state.model.parameters()).device
        if device.type != 'cuda':
            raise ValueError(f'StepGraph runs on a card, not on {device}')
        if lrs[0].device != device or hrs[0].device != device:
            raise ValueError(f'a window\'s batches lie on {device}, got '
                             f'{lrs[0].device} and {hrs[0].device}')
        key = self._key(state, lrs, hrs)
        cap = self.graphs.get(key)
        if cap is not None and not cap.valid(state):
            self.graphs.clear()         # the state was reloaded
            cap = None
        if cap is None:
            lr_dev, hr_dev = torch.stack(list(lrs)), torch.stack(list(hrs))
            logs = self._eager(state, lr_dev, hr_dev, device)
            if state_ready(state):
                self.graphs[key] = self._capture(state, key, lr_dev, hr_dev)
            return logs
        torch.stack(list(lrs), out=cap.lr)
        torch.stack(list(hrs), out=cap.hr)
        cap.graph.replay()
        self.replays += 1
        state.step += k
        for _, _, u in state.optimizers().values():
            u.mini_step = (u.mini_step + k) % u.every
        for fn, attr, d in cap.delta:
            setattr(fn, attr, getattr(fn, attr) + d)
        return {name: v.clone() for name, v in cap.logs.items()}

    def _eager(self, state, lr, hr, device) -> dict:
        """The window's steps, eagerly on a side stream (the warm-up)."""
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for i in range(self.k):
                logs = self.step(state, lr[i], hr[i])
        main.wait_stream(side)
        self.eager_windows += 1
        return logs

    def _capture(self, state, key, lr, hr) -> _Captured:
        """The window's ``k`` steps from phase ``key[0]``, captured: the
        Python mirrors and the counters are put back as they were, since
        capture runs nothing."""
        updaters = [u for _, _, u in state.optimizers().values()]
        saved = (state.step, [u.mini_step for u in updaters])
        counters = launch_counters()
        before = _read(counters)
        static_lr, static_hr = lr.clone(), hr.clone()
        graph = torch.cuda.CUDAGraph()
        try:
            for u, phase in zip(updaters, key[0]):
                u.mini_step = phase
            with capture_lock, torch.cuda.graph(graph):
                for i in range(self.k):
                    logs = self.step(state, static_lr[i], static_hr[i])
        finally:
            after = _read(counters)
            for (fn, attr), v in zip(counters, before):
                setattr(fn, attr, v)
            state.step = saved[0]
            for u, phase in zip(updaters, saved[1]):
                u.mini_step = phase
        self.captures += 1
        delta = [(fn, attr, a - b) for (fn, attr), a, b
                 in zip(counters, after, before) if a != b]
        return _Captured(graph, static_lr, static_hr, logs, delta,
                         _captured_tensors(state))
