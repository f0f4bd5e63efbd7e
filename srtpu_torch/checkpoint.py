"""Checkpoints (srtpu/checkpoint.py): top-k retention on a monitored
metric, plus ``last``, in srtpu's directory layout::

    <directory>/hparams.json          the hparams snapshot
    <directory>/top/<step>/state.pt   the save_top_k kept on ``monitor``
    <directory>/top/<step>/metrics.json
    <directory>/last/state.pt         replaced on every save

``state.pt`` is :func:`~srtpu_torch.train.state.state_to_tree` written
with ``torch.save`` and read with ``torch.load(weights_only=True)``.
Retention is Orbax's as srtpu configures it (``max_to_keep`` =
``save_top_k``, ``best_fn`` the monitored value, ``best_mode`` ``mode``):
a step is kept under ``top`` only when ``metrics`` holds the monitor and
the step is past the latest kept one; then the ``save_top_k`` best stay,
sorted stably by value (``min`` mode reversed) so that of equal values
the later steps stay. ``save_top_k`` <= 0 keeps every step, and the best
step is then the latest, as Orbax without ``best_fn``.
"""

from __future__ import annotations

import json
import logging
import shutil
from pathlib import Path
from typing import Any

import torch

_logger = logging.getLogger(__name__)

STATE_FILE = 'state.pt'


class CheckpointManager:
    def __init__(self, directory: str | Path, monitor: str = 'PSNR',
                 mode: str = 'max', save_top_k: int = 3,
                 save_last: bool = True,
                 hparams: dict[str, Any] | None = None):
        self._dir = Path(directory).absolute()
        self._dir.mkdir(parents=True, exist_ok=True)
        self._monitor = monitor or ''
        self._mode = mode
        self._keep = save_top_k if save_top_k > 0 else None
        self._save_last = save_last
        self._safe_key = self._monitor.replace('/', '__')
        self._top = self._dir / 'top'
        # steps already under top/, with their metrics, as Orbax reads them
        self._steps: dict[int, dict] = {}
        if self._top.is_dir():
            for d in self._top.iterdir():
                if d.name.isdigit() and (d / STATE_FILE).is_file():
                    m = d / 'metrics.json'
                    self._steps[int(d.name)] = (json.loads(m.read_text())
                                                if m.is_file() else None)
        if hparams is not None:
            (self._dir / 'hparams.json').write_text(
                json.dumps(hparams, indent=2, default=str))

    def _sorted(self) -> list[int]:
        """Steps with metrics, worst first (Orbax's ``BestN``)."""
        with_metrics = [s for s in sorted(self._steps)
                        if self._steps[s] is not None
                        and self._safe_key in self._steps[s]]
        return sorted(with_metrics,
                      key=lambda s: self._steps[s][self._safe_key],
                      reverse=self._mode == 'min')

    def save(self, step: int, state, metrics: dict[str, float]) -> None:
        from .train.state import state_to_tree
        tree = state_to_tree(state)
        latest = self.latest_step()
        if self._monitor in metrics and (latest is None or step > latest):
            path = self._top / str(step)
            path.mkdir(parents=True, exist_ok=True)
            torch.save(tree, path / STATE_FILE)
            rec = {self._safe_key: float(metrics[self._monitor])}
            (path / 'metrics.json').write_text(json.dumps(rec))
            self._steps[step] = rec
            if self._keep is not None and len(self._steps) > self._keep:
                keep = set(self._sorted()[-self._keep:])
                keep |= {s for s, m in self._steps.items() if m is None}
                for s in [s for s in self._steps if s not in keep]:
                    shutil.rmtree(self._top / str(s))
                    del self._steps[s]
        if self._save_last:
            path = self._dir / 'last'
            if path.exists():
                shutil.rmtree(path)
            path.mkdir(parents=True)
            torch.save(tree, path / STATE_FILE)

    def latest_step(self) -> int | None:
        return max(self._steps) if self._steps else None

    def best_step(self) -> int | None:
        if self._keep is None:
            return self.latest_step()
        ranked = self._sorted()
        return ranked[-1] if ranked else None

    def restore(self, state, step: int | None = None):
        """Load into ``state`` (in place; returned): ``step`` when given,
        else the best step on the monitor when there is one, else the
        latest, else ``last`` (srtpu ``restore``)."""
        if step is None and self._monitor:
            step = self.best_step()
        if step is None:
            step = self.latest_step()
        path = self._dir / 'last' if step is None else self._top / str(step)
        return _into(state, path)

    def restore_last(self, state):
        return _into(state, self._dir / 'last')


def _into(state, path: Path):
    """``path``'s checkpoint loaded into ``state``."""
    from .train.state import tree_to_state
    f = path / STATE_FILE
    if not f.is_file():
        raise FileNotFoundError(f'no checkpoint at {f}')
    return tree_to_state(state, torch.load(f, map_location='cpu',
                                           weights_only=True))


def load_hparams(directory: str | Path) -> dict[str, Any]:
    """``hparams.json`` of ``directory``, or of the nearest parent that
    has one (``directory`` may be ``.../checkpoints/top`` or a step)."""
    path = Path(directory) / 'hparams.json'
    if not path.exists():
        for parent in Path(directory).absolute().parents:
            cand = parent / 'hparams.json'
            if cand.exists():
                path = cand
                break
    return json.loads(path.read_text())
