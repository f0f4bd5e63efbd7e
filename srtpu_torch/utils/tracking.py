"""Experiment trackers (srtpu/utils/tracking.py): the Trainer logs
through one :class:`MultiTracker`, which fans out to

* TensorBoard, always on: an event file in ``<root>/tensorboard_logs``
  (:class:`~srtpu_torch.utils.tensorboard.EventWriter`, written by hand:
  scalars, val images and weight histograms, as srtpu's tensorboardX
  ``TBLogger``);
* :class:`JsonlTracker`, always on: every scalar dict is one line of
  ``metrics.jsonl`` (``{"step": ..., "time": ..., <key>: <value>}``),
  hyperparameters go to ``params.json`` and artifact paths to
  ``assets.json``, all in the run root;
* Comet, when ``comet_ml`` imports and ``COMET_API_KEY`` is set.

A backend that fails logs a warning and training goes on.
"""

from __future__ import annotations

import json
import logging
import os
import time
from pathlib import Path

import numpy as np

from .tensorboard import EventWriter

_logger = logging.getLogger(__name__)


class JsonlTracker:
    """``metrics.jsonl``, ``params.json`` and ``assets.json`` in the run
    root."""

    def __init__(self, root: str | Path):
        self._root = Path(root)
        self._root.mkdir(parents=True, exist_ok=True)
        self._fh = open(self._root / 'metrics.jsonl', 'a', buffering=1)
        self._assets: list[str] = []

    def params(self, params: dict) -> None:
        (self._root / 'params.json').write_text(
            json.dumps(params, indent=2, default=str))

    def scalars(self, values: dict, step: int) -> None:
        rec = {'step': int(step), 'time': time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._fh.write(json.dumps(rec) + '\n')

    def image(self, tag: str, img, step: int) -> None:
        pass    # images already land on disk as PNGs

    def asset(self, path: str | Path) -> None:
        self._assets.append(str(path))
        (self._root / 'assets.json').write_text(
            json.dumps(self._assets, indent=2))

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


class CometTracker:
    """Comet (srtpu's optional backend); made only when ``comet_ml``
    imports and ``COMET_API_KEY`` is set."""

    def __init__(self, project: str | None = None):
        import comet_ml
        self._exp = comet_ml.Experiment(
            project_name=project or os.environ.get('COMET_PROJECT_NAME'))

    def params(self, params: dict) -> None:
        self._exp.log_parameters(params)

    def scalars(self, values: dict, step: int) -> None:
        self._exp.log_metrics({k: float(v) for k, v in values.items()},
                              step=step)

    def image(self, tag: str, img, step: int) -> None:
        self._exp.log_image(np.asarray(img), name=tag, step=step)

    def asset(self, path: str | Path) -> None:
        p = Path(path)
        if p.is_dir():
            self._exp.log_asset_folder(str(p))
        elif p.exists():
            self._exp.log_asset(str(p))

    def close(self) -> None:
        self._exp.end()


class MultiTracker:
    """The fan-out the Trainer logs through; it never raises."""

    def __init__(self, root: str | Path):
        self._closed = False
        self._backends: list = []
        try:
            self._backends.append(EventWriter(Path(root) /
                                              'tensorboard_logs'))
        except Exception:
            _logger.warning('TensorBoard event file unavailable',
                            exc_info=True)
        self._backends.append(JsonlTracker(root))
        if os.environ.get('COMET_API_KEY'):
            try:
                self._backends.append(CometTracker())
                _logger.info('Comet tracking enabled')
            except Exception:
                _logger.warning('comet_ml unavailable or misconfigured; '
                                'Comet tracking disabled', exc_info=True)

    def _fanout(self, method: str, *args) -> None:
        for b in self._backends:
            fn = getattr(b, method, None)
            if fn is None:
                continue
            try:
                fn(*args)
            except Exception:
                _logger.warning('tracker %s.%s failed',
                                type(b).__name__, method, exc_info=True)

    def params(self, params: dict) -> None:
        self._fanout('params', params)

    def scalars(self, values: dict, step: int) -> None:
        self._fanout('scalars', values, step)

    def image(self, tag: str, img, step: int) -> None:
        self._fanout('image', tag, img, step)

    def histogram(self, tag: str, values, step: int) -> None:
        """TensorBoard's histogram of ``values`` (srtpu's weight
        histograms)."""
        self._fanout('histogram', tag, values, step)

    def asset(self, path) -> None:
        self._fanout('asset', path)

    def flush(self) -> None:
        self._fanout('flush')

    def close(self) -> None:
        """Idempotent: ends Comet's experiment, closes the files."""
        if self._closed:
            return
        self._closed = True
        self._fanout('close')
