"""Trainer (srtpu/train/loop.py): ``fit``, ``validate`` and ``predict``.

``fit`` is srtpu's epoch loop with its knobs:

* ``max_epochs``, ``limit_train_batches``, ``fast_dev_run`` (one epoch
  of one step, no sanity pass), ``overfit_batches`` (the same first N
  batches every epoch: the sampler's epoch pinned at 0);
* the progress lines: per epoch ``epoch %d/%d  loss %.4f  %.1f
  items/s``, and every ``log_every_n_steps`` batches srtpu's in-epoch
  ``epoch %d  step %d/%d  loss %.4f  %.1f items/s`` (one host read);
  every ``log_loss_every_n_epochs`` the last batch's losses go to the
  trackers;
* validation: a sanity pass of ``num_sanity_val_steps`` images per
  dataset first (no logging, no images), then a pass after every
  ``check_val_every_n_epoch``-th epoch and after the last one, at most
  ``limit_val_batches`` images each; all metrics go to the trackers,
  the ``val @ epoch`` line shows those matching ``metrics_for_pbar``;
  ``save_results`` images per dataset (-1: all) are written as
  ``<root>/<dataset>/<image>/epoch_%05d[_center].png`` on the epochs
  ``save_results_from_epoch`` names (``all``, ``last``, ``half``,
  ``quarter``), with their per-image metrics, and with ``edge_loss`` or
  ``pencil_sketch`` in the DSL their ``_edges`` / ``_sketch`` maps (the
  HR's once per image); BRISQUE, which reads the SR alone, is scored
  on each image's true shape, where srtpu scores it again;
* checkpoints (:class:`~srtpu_torch.checkpoint.CheckpointManager` in
  ``<root>/checkpoints``) after each val pass: top ``save_top_k`` on
  ``monitor`` (default the first eval dataset and the first metric;
  ``min`` mode for lower-is-better metrics) and ``last``; on any
  exception ``last`` is saved as the state stands, the traceback goes to
  ``run.log`` and the exception is raised again; ``ckpt_path`` (``last``
  or a checkpoints directory) resumes: the state is restored and the
  loop goes on from epoch ``step // steps_per_epoch``;
* ``accumulate_grad_batches`` and ``gradient_clip_val`` /
  ``gradient_clip_algorithm`` (the state's
  :class:`~srtpu_torch.train.state.Updater`: optax's ``MultiSteps``
  around srtpu's clip chain) over the model's parameters and the
  trainable loss's (the adaptive loss's latents, in the one optimizer);
* trackers (:class:`~srtpu_torch.utils.tracking.MultiTracker`:
  ``metrics.jsonl`` always, Comet where it is configured) and
  ``run.log`` in the root.

An :class:`~srtpu_torch.models.SRGAN` trains adversarially (srtpu's
``_fit_gan``) with the same knobs: the loss DSL is ignored, the step is
:func:`~srtpu_torch.train.gan.make_gan_train_step` with its VGG19 term,
both optimizers take the lr of ``optimizer_params`` (default 1e-4), and
the line is ``epoch %d/%d  g_loss %.4f  d_loss %.4f  %.1f items/s``; its
checkpoints hold the generator, the discriminator and both optimizers.
The model trains the generator and discriminator it holds, with its own
``dtype`` (srtpu's ``_fit_gan`` rebuilds its generator positionally and
so drops the dtype, ROADMAP.md F8). The model's current weights are the
initial state (srtpu's ``seed`` draws them; here the caller does, as
``python -m srtpu_torch fit --seed`` does for the weights and the
loader).

srtpu's debugging and bookkeeping knobs:

* ``remat``: the model forward under
  ``torch.utils.checkpoint.checkpoint`` (non-reentrant), its activations
  recomputed in the backward; the loss stays outside, as srtpu's
  ``jax.checkpoint``. Ignored, as in srtpu, for batch-norm models
  (SRResNet; SRGAN's generator) and in the GAN fit;
* ``deterministic``: srtpu draws the state from seed 0 instead of its
  ``seed``; here the caller draws the weights (the CLI and
  ``config.build_all`` draw them from seed 0 under the knob). On a card
  ``fit`` also sets ``torch.use_deterministic_algorithms(True)``,
  ``cudnn.deterministic`` and ``cudnn.benchmark = False`` (and
  ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` where unset; set it before the
  process's first cuBLAS call, as the CLI does) and restores them all
  when it returns;
* ``detect_anomaly`` (srtpu's ``jax_debug_nans``): forward hooks on every
  submodule and the backward under ``torch.autograd.detect_anomaly``;
  the first NaN raises ``FloatingPointError`` naming the module or the
  backward node it came from. Off, nothing is installed;
* ``profiler_dir``: ``torch.profiler`` (CPU and, on a card, CUDA
  activity) from after the sanity pass to the end of ``fit``, its trace
  written to ``<profiler_dir>/<host>.<pid>.pt.trace.json``;
* ``log_weights_every_n_epochs``: every parameter's histogram to
  TensorBoard (``weights/<name>``) every that many epochs (0: never);
* run assets, written to the root and registered with the trackers
  before training (srtpu ``_log_run_assets``): ``model_summary.txt``
  (one line a parameter, the total), ``source_snapshot.zip``
  (``srtpu_torch/**/*.py`` and ``ops/csrc/*``) and ``model_graph.txt``,
  the exported graph of the eval forward at a train batch's LR shape
  (:func:`~srtpu_torch.export.graph_text`); a failure there logs a
  warning and training goes on.

srtpu's ``_fit_gan`` reads none of these knobs; here the GAN fit takes
all but ``remat`` and ``steps_per_execution``.

The train loader (:class:`~srtpu_torch.data.TrainLoader`, srtpu's)
makes the batches on a producer thread and, on a card, copies them
there ahead of the step (device prefetch); the step takes them as they
come. Its core (``native`` or ``numpy``) is written to ``run.log``.

``steps_per_execution`` k > 1 is srtpu's window loop (srtpu
``loop.py:304-326``): k batches make a window and run as k
train steps in one call, ``global_step`` moves by k and the in-epoch
progress line is checked at window boundaries (its cadence is on the
global step); an epoch's remainder batches run through the single step.
On the card a window is one replay of a CUDA graph of its k steps
(:class:`~srtpu_torch.train.graph.StepGraph`: one host dispatch per k
steps; a capture that fails raises), on the CPU its k eager steps
(:func:`~srtpu_torch.train.steps.repeat_step`), the same arithmetic.
``fast_dev_run`` runs one step (k 1, as srtpu); the GAN fit runs one
step a dispatch, as srtpu's ``_fit_gan``, which never reads the key;
with ``detect_anomaly`` (whose hooks read the host, which no graph can
capture) each window's k steps run eagerly, with one warning.

``validate`` scores every eval image (batch 1, bucket-padded, masked)
with ``metrics`` and returns ``{dataset/metric: mean}``; ``predict``
writes PNGs. Both take srtpu's routes: a ``'cs'`` model without
``GLOBAL_POOLING`` runs an LR shape that srtpu's lane budget cannot take
directly (``tiled.route_tiled``) through the tiled step when
``eval_tile`` > 0 (predict first edge-pads the LR to ``eval_tile``
multiples); else ``predict`` takes host tiles when ``predict_tile`` > 0
and the image's sides both exceed it; else the direct full-image
forward. srtpu defaults ``eval_tile`` to 80 for its TPU's lane budget
and tiles only on a TPU; the card has no such budget (RDN-B's direct
forward at LR 512x352 takes 44.5 ms on an H100), so here it defaults to
0, srtpu's "plain full-image forward", on every device, and
``eval_tile=80`` gives srtpu's TPU routing.
"""

from __future__ import annotations

import logging
import os
import socket
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..data.pipeline import center_crop
from ..losses import VGGLoss, extract_edges, parse_losses, pencil_sketch
from ..metrics import LOWER_IS_BETTER, NO_REFERENCE, build_metrics
from ..models import SRGAN
from ..optim import parse_optimizer_params
from ..utils.logging import attach_run_log, has_run_log, save_image
from ..utils.tracking import MultiTracker
from .gan import create_gan_state, make_gan_train_step
from .graph import StepGraph
from .state import TrainState, Updater
from .steps import (make_eval_step, make_predict_step,
                    make_tiled_eval_step, make_tiled_predict_step,
                    make_train_step, repeat_step)
from .tiled import route_tiled, tiled_predict

_logger = logging.getLogger(__name__)


@dataclass
class TrainerConfig:
    default_root_dir: str = '.'
    max_epochs: int = 20
    check_val_every_n_epoch: int = 1
    log_loss_every_n_epochs: int = 5
    save_results: int = -1                  # images saved per dataset
    save_results_from_epoch: str = 'last'   # all | last | half | quarter
    metrics: tuple[str, ...] = ('PSNR', 'SSIM')
    metrics_for_pbar: tuple[str, ...] = ('PSNR', 'SSIM')
    monitor: str | None = None              # e.g. 'DIV2K/PSNR'
    save_top_k: int = 3
    num_sanity_val_steps: int = 2
    accumulate_grad_batches: int = 1
    limit_train_batches: int | None = None
    limit_val_batches: int | None = None
    overfit_batches: int = 0   # > 0: the same N batches every epoch
    fast_dev_run: bool = False      # one epoch of one step
    enable_checkpointing: bool = True
    enable_progress_log: bool = True
    log_every_n_steps: int = 50     # in-epoch progress cadence
    ckpt_path: str | None = None    # 'last' or a checkpoints directory
    gradient_clip_val: float | None = None
    gradient_clip_algorithm: str = 'norm'   # 'norm' (global L2) | 'value'
    eval_tile: int = 0              # srtpu: 80 (its TPU's lane budget)
    eval_tile_overlap: int = 8      # LR px halo per tile edge
    predict_tile: int = 0           # > 0: host tiles past this size
    predict_tile_overlap: int = 32  # LR px, >= the receptive radius
    log_weights_every_n_epochs: int = 50    # weight histograms; 0: never
    profiler_dir: str | None = None         # torch.profiler trace directory
    detect_anomaly: bool = False            # srtpu's jax_debug_nans
    deterministic: bool = False             # deterministic algorithms
    remat: bool = False                     # recompute the forward
    steps_per_execution: int = 1            # train steps a dispatch


CUBLAS_DETERMINISTIC = ':4096:8'    # CUBLAS_WORKSPACE_CONFIG's value


def has_batch_stats(model: torch.nn.Module) -> bool:
    """Whether ``model`` keeps batch-norm running statistics (srtpu's
    ``batch_stats``): SRResNet, SRGAN."""
    from ..models.common import BNTrunk
    from ..models.srgan import BatchNorm
    return any(isinstance(m, (BNTrunk, BatchNorm)) for m in model.modules())


def set_deterministic(device: torch.device):
    """On a card, torch's deterministic algorithms, cuDNN's deterministic
    and not benchmarked convs, and ``CUBLAS_WORKSPACE_CONFIG`` where unset;
    returns what :func:`restore_deterministic` puts back (None off a
    card)."""
    if device.type != 'cuda':
        return None
    cudnn = torch.backends.cudnn
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            cudnn.deterministic, cudnn.benchmark,
            os.environ.get('CUBLAS_WORKSPACE_CONFIG'))
    os.environ.setdefault('CUBLAS_WORKSPACE_CONFIG', CUBLAS_DETERMINISTIC)
    torch.use_deterministic_algorithms(True)
    cudnn.deterministic, cudnn.benchmark = True, False
    return prev


def restore_deterministic(prev) -> None:
    """Undo :func:`set_deterministic`."""
    if prev is None:
        return
    algos, warn_only, cudnn_det, bench, cublas = prev
    torch.use_deterministic_algorithms(algos, warn_only=warn_only)
    cudnn = torch.backends.cudnn
    cudnn.deterministic, cudnn.benchmark = cudnn_det, bench
    if cublas is None:
        os.environ.pop('CUBLAS_WORKSPACE_CONFIG', None)


def anomaly_guard(model: torch.nn.Module, train_step):
    """srtpu's ``jax_debug_nans`` for ``train_step``: a forward hook on
    every submodule raises ``FloatingPointError`` at the first NaN output,
    naming the module; the step runs under
    ``torch.autograd.detect_anomaly(check_nan=True)``, whose error at a
    NaN in the backward is raised again as ``FloatingPointError``.
    Returns (the guarded step, the hooks' handles)."""
    def hook_of(name: str):
        def hook(module, inputs, out):
            outs = out if isinstance(out, (tuple, list)) else (out,)
            for t in outs:
                if torch.is_tensor(t) and t.is_floating_point() and \
                        bool(torch.isnan(t).any()):
                    raise FloatingPointError(
                        f'NaN in the forward output of {name or "the model"}'
                        f' ({type(module).__name__})')
        return hook

    handles = [m.register_forward_hook(hook_of(name))
               for name, m in model.named_modules()]

    def guarded(state, lr, hr):
        with torch.autograd.detect_anomaly(check_nan=True):
            try:
                return train_step(state, lr, hr)
            except RuntimeError as e:
                if 'nan' not in str(e).lower():
                    raise
                raise FloatingPointError(f'NaN in the backward: {e}') from e

    return guarded, handles


class Trainer:
    def __init__(self, cfg: TrainerConfig):
        self.cfg = cfg
        self.root = Path(cfg.default_root_dir)
        self.global_step = 0
        self.current_epoch = 0
        self._last_progress_step = 0
        self._tb: MultiTracker | None = None
        self._ckpt: CheckpointManager | None = None
        self._edge_ops: list[str] = []
        self._saved_hr_versions: set[tuple[str, str, str]] = set()
        self._log: logging.Handler | None = None
        self._device: torch.device | None = None
        self.step_graph = None          # the last fit's StepGraph (card)

    @property
    def tb(self) -> MultiTracker:
        """The trackers, made (with the root) at the first record."""
        if self._tb is None:
            self._tb = MultiTracker(self.root)
        return self._tb

    def close(self) -> None:
        """Close the trackers (idempotent); ``fit``'s run.log handler,
        when it attached one, is detached."""
        if self._tb is not None:
            self._tb.close()
            self._tb = None
        if self._log is not None:
            logging.getLogger().removeHandler(self._log)
            self._log.close()
            self._log = None

    # ------------------------------------------------------------------ fit

    def fit(self, model: torch.nn.Module, datamodule, losses: str = 'l1',
            optimizer_name: str = 'ADAM',
            optimizer_params: list[str] | None = None,
            hparams: dict[str, Any] | None = None):
        """Train ``model`` in place on ``datamodule``'s train datasets on
        the model's device, in train mode (its mode is restored after),
        validating on its eval datasets (the module note); returns the
        final :class:`TrainState` (an SRGAN's:
        :class:`~srtpu_torch.train.gan.GANTrainState`). ``hparams`` go to
        the trackers and to ``checkpoints/hparams.json``."""
        cfg = self.cfg
        datamodule.setup('fit')
        device = self._device = next(model.parameters()).device
        if not has_run_log(self.root):
            self._log = attach_run_log(self.root)
        acc = dict(accumulate=cfg.accumulate_grad_batches,
                   clip_val=cfg.gradient_clip_val,
                   clip_algorithm=cfg.gradient_clip_algorithm)
        if isinstance(model, SRGAN):
            lr = parse_optimizer_params(optimizer_params).get('lr', 1e-4)
            vgg = VGGLoss(device=device)
            if not vgg.pretrained:
                _logger.warning(
                    '=' * 66 + "\nWARNING: SRGAN's VGG content term is "
                    'running on deterministic random-init features (no '
                    'converted pretrained weights found) — the training '
                    'objective will not match the reference. Convert '
                    'weights with tools/convert_torch_weights.py into '
                    '$SRTPU_WEIGHTS_DIR.\n' + '=' * 66)
            self._edge_ops = []
            state = create_gan_state(model, lr, **acc)
            train_step = make_gan_train_step(vgg_loss=vgg)
            keys = ('g_loss', 'd_loss')
            # srtpu's GAN eval step takes no tiled route
            eval_step = self._eval_step_of(model, datamodule, tiled=False)
        else:
            composite = parse_losses(losses)
            self._warn_missing_pretrained(composite)
            state = TrainState.create(
                model, composite, optimizer_name, optimizer_params,
                Updater(acc['accumulate'], acc['clip_val'],
                        acc['clip_algorithm']))
            # srtpu's edge / sketch val images follow these losses
            self._edge_ops = [n for n in composite.names
                              if n in ('edge_loss', 'pencil_sketch')]
            # srtpu's remat skips batch-norm models
            train_step = make_train_step(
                composite, remat=cfg.remat and not has_batch_stats(model))
            keys = ('loss',)
            eval_step = self._eval_step_of(model, datamodule)
        was_training = model.training
        flags = set_deterministic(device) if cfg.deterministic else None
        try:
            return self._fit(model, datamodule, state, train_step, keys,
                             eval_step, device, hparams)
        finally:
            model.train(was_training)
            restore_deterministic(flags)

    @staticmethod
    def _warn_missing_pretrained(composite) -> None:
        """srtpu's banner when a perceptual loss runs without converted
        weights: it trains on random-init features, another objective."""
        missing = [s.name for s in getattr(composite, 'sub_losses', ())
                   if getattr(s.fn, 'pretrained', True) is False]
        if missing:
            _logger.warning(
                '=' * 66 + '\nWARNING: perceptual loss(es) %s selected '
                'WITHOUT converted pretrained weights — running on '
                'deterministic random-init features. Scores/gradients will '
                "not match the reference's. Convert weights with "
                'tools/convert_torch_weights.py into $SRTPU_WEIGHTS_DIR.\n'
                + '=' * 66, ', '.join(missing))

    def _eval_step_of(self, model, datamodule, tiled: bool = True):
        """The val passes' eval step on the config's metrics, or None
        without eval datasets."""
        if not datamodule.eval_dataset_names:
            return None
        return self._make_eval_step(build_metrics(list(self.cfg.metrics)),
                                    model, tiled)

    def _fit(self, model, datamodule, state, train_step, keys, eval_step,
             device, hparams):
        cfg = self.cfg
        loader = datamodule.train_loader(device=device)
        _logger.info('train loader: the %s core, batches %s', loader.core,
                     f'prefetched to {device}' if device.type == 'cuda'
                     else 'on the host')
        limit = cfg.overfit_batches if cfg.overfit_batches > 0 \
            else cfg.limit_train_batches
        if cfg.ckpt_path:
            ckpt_dir = (self.root / 'checkpoints' if cfg.ckpt_path == 'last'
                        else Path(cfg.ckpt_path))
            CheckpointManager(ckpt_dir, monitor='').restore_last(state)
            steps_per_epoch = len(loader)
            if limit is not None:
                steps_per_epoch = min(steps_per_epoch, limit)
            steps_per_epoch = max(steps_per_epoch, 1)
            self.current_epoch = state.step // steps_per_epoch
            self.global_step = state.step
            _logger.info('resumed from %s at epoch %d (step %d)', ckpt_dir,
                         self.current_epoch, self.global_step)
        n_params = sum(p.numel() for p in model.parameters())
        _logger.info('model parameters: %s (%.2f MB fp32)', f'{n_params:,}',
                     n_params * 4 / 2 ** 20)
        self._log_run_assets(model, loader.peek().lr.shape)
        monitor = cfg.monitor
        if monitor is None and datamodule.eval_dataset_names and cfg.metrics:
            monitor = f'{datamodule.eval_dataset_names[0]}/{cfg.metrics[0]}'
        if cfg.enable_checkpointing:
            metric_name = monitor.split('/')[-1] if monitor else ''
            self._ckpt = CheckpointManager(
                self.root / 'checkpoints', monitor=monitor or '',
                mode='min' if metric_name in LOWER_IS_BETTER else 'max',
                save_top_k=cfg.save_top_k, hparams=hparams or {})
        if hparams:
            self.tb.params(hparams)
        max_epochs = 1 if cfg.fast_dev_run else cfg.max_epochs
        if cfg.num_sanity_val_steps and not cfg.fast_dev_run:
            self._run_validation(eval_step, datamodule,
                                 limit=cfg.num_sanity_val_steps, sanity=True)
        model.train()       # srtpu's train=True: batch statistics
        last_logs = None
        hooks = []
        if cfg.detect_anomaly:
            train_step, hooks = anomaly_guard(model, train_step)
        # srtpu's k: at least 1; one observable step under fast_dev_run;
        # the GAN fit one step a dispatch
        spe = max(int(cfg.steps_per_execution), 1)
        if cfg.fast_dev_run or isinstance(model, SRGAN):
            spe = 1
        multi_step = self._window_step(train_step, spe, device)

        def on_device(a):       # the card's loader has put it there
            return a if torch.is_tensor(a) else torch.from_numpy(a).to(device)

        def single(batch):
            return train_step(state, on_device(batch.lr), on_device(batch.hr))
        profiler = self._start_profiler(device) if cfg.profiler_dir \
            else None
        try:
            for epoch in range(self.current_epoch, max_epochs):
                self.current_epoch = epoch
                t0 = time.time()
                items = 0
                n_batches = len(loader)
                if limit is not None:
                    n_batches = min(n_batches, limit)
                loader.set_epoch(0 if cfg.overfit_batches > 0 else epoch)
                pending = []
                for i, batch in enumerate(loader):
                    if limit is not None and i >= limit:
                        break
                    if cfg.fast_dev_run and i >= 1:
                        break
                    pending.append(batch)
                    if len(pending) < spe:
                        continue
                    last_logs = single(batch) if multi_step is None else \
                        multi_step(state,
                                   [on_device(b.lr) for b in pending],
                                   [on_device(b.hr) for b in pending])
                    self.global_step += len(pending)
                    items += sum(b.lr.shape[0] for b in pending)
                    pending = []
                    self._step_progress(i, n_batches, items, t0, last_logs,
                                        keys)
                # an epoch's remainder batches run through the single step
                for b in pending:
                    last_logs = single(b)
                    self.global_step += 1
                    items += b.lr.shape[0]
                if cfg.enable_progress_log:
                    # reading a loss waits for the step
                    vals = [float(last_logs[k]) if last_logs else 0.0
                            for k in keys]
                    _logger.info(
                        'epoch %d/%d  ' + '  '.join(f'{k} %.4f' for k in keys)
                        + '  %.1f items/s', epoch + 1, max_epochs, *vals,
                        items / max(time.time() - t0, 1e-9))
                if last_logs is not None and \
                        (epoch + 1) % cfg.log_loss_every_n_epochs == 0:
                    self.tb.scalars(self._loss_scalars(last_logs, keys),
                                    self.global_step)
                if cfg.log_weights_every_n_epochs > 0 and \
                        (epoch + 1) % cfg.log_weights_every_n_epochs == 0:
                    self._log_weight_histograms(model)
                if (epoch + 1) % cfg.check_val_every_n_epoch == 0 \
                        or epoch + 1 == max_epochs:
                    metrics = self._run_validation(eval_step, datamodule)
                    if self._ckpt is not None:
                        self._ckpt.save(epoch + 1, state, metrics)
        except BaseException as e:
            # srtpu's crash containment: a resumable 'last', the traceback
            # in run.log, the trackers flushed below, the error raised on
            if self._ckpt is not None:
                _logger.info('%s during fit — saving last checkpoint',
                             type(e).__name__)
                try:
                    self._ckpt.save(self.current_epoch + 1, state, {})
                except Exception:
                    _logger.exception('failed to save crash checkpoint')
            if not isinstance(e, KeyboardInterrupt):
                _logger.exception('fit crashed')
            raise
        finally:
            loader.close()
            for h in hooks:
                h.remove()
            if profiler is not None:
                self._stop_profiler(profiler)
            graphs = self.step_graph
            if graphs is not None:
                _logger.info('steps_per_execution %d: %d windows as CUDA '
                             'graphs (%d graphs captured, %d replays, %d '
                             'eager windows)', graphs.k,
                             graphs.replays + graphs.eager_windows,
                             graphs.captures, graphs.replays,
                             graphs.eager_windows)
            self._record_run_artifacts()
        return state

    def _window_step(self, train_step, k: int, device):
        """The window form of ``train_step`` at k > 1 steps a window (the
        module note), or None at k 1."""
        self.step_graph = None
        if k == 1:
            return None
        if self.cfg.detect_anomaly:
            _logger.warning(
                'steps_per_execution=%d with detect_anomaly: its NaN hooks '
                'read the device from the host, which a CUDA graph cannot '
                'capture; each window runs its %d steps eagerly', k, k)
        elif device.type == 'cuda':
            self.step_graph = StepGraph(train_step, k)
            return self.step_graph
        return repeat_step(train_step, k)

    def _start_profiler(self, device: torch.device):
        """torch.profiler over CPU and, on a card, CUDA activity."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == 'cuda':
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler) -> None:
        """Stop and write ``<profiler_dir>/<host>.<pid>.pt.trace.json``."""
        profiler.stop()
        out = Path(self.cfg.profiler_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / f'{socket.gethostname()}.{os.getpid()}.pt.trace.json'
        profiler.export_chrome_trace(str(path))
        _logger.info('profiler trace written to %s', path)

    def _log_weight_histograms(self, model: torch.nn.Module) -> None:
        """Every parameter's histogram to TensorBoard as
        ``weights/<name>`` at the epoch (srtpu ``_log_weight_histograms``)."""
        for name, p in model.named_parameters():
            self.tb.histogram(f'weights/{name}',
                              p.detach().float().cpu().numpy(),
                              self.current_epoch + 1)

    def _log_run_assets(self, model: torch.nn.Module, sample_shape) -> None:
        """srtpu's ``_log_run_assets``: ``model_summary.txt`` (a line a
        parameter: name, shape, dtype, size; the total),
        ``source_snapshot.zip`` (the package's ``.py`` files and
        ``ops/csrc``) and ``model_graph.txt`` (the exported eval forward at
        ``sample_shape``), in the root and as tracker assets. A failure
        logs a warning; training goes on."""
        try:
            import zipfile
            from ..export import export_serving, graph_text
            self.root.mkdir(parents=True, exist_ok=True)
            lines, total = [f'model: {type(model).__name__}', ''], 0
            for name, p in model.named_parameters():
                dtype = str(p.dtype).replace('torch.', '')
                lines.append(f'{name:60s} {str(tuple(p.shape)):20s} '
                             f'{dtype}  {p.numel():,}')
                total += p.numel()
            lines += ['', f'total parameters: {total:,} '
                      f'({total * 4 / 2 ** 20:.2f} MB fp32)']
            summary = self.root / 'model_summary.txt'
            summary.write_text('\n'.join(lines))
            self.tb.asset(summary)

            pkg = Path(__file__).resolve().parents[1]
            snap = self.root / 'source_snapshot.zip'
            with zipfile.ZipFile(snap, 'w', zipfile.ZIP_DEFLATED) as zf:
                for f in sorted(pkg.rglob('*.py')):
                    zf.write(f, f'srtpu_torch/{f.relative_to(pkg)}')
                for f in sorted((pkg / 'ops' / 'csrc').glob('*')):
                    zf.write(f, f'srtpu_torch/ops/csrc/{f.name}')
            self.tb.asset(snap)

            b, h, w, _ = sample_shape
            graph = self.root / 'model_graph.txt'
            graph.write_text(graph_text(export_serving(model, b, h, w)))
            self.tb.asset(graph)
        except Exception:   # bookkeeping never stops training
            _logger.warning('run-asset logging failed', exc_info=True)

    @staticmethod
    def _loss_scalars(logs: dict, keys) -> dict[str, float]:
        """The last batch's losses as srtpu logs them each
        ``log_loss_every_n_epochs``: the parts and ``loss/total``; an
        SRGAN's every term as ``loss/<name>``."""
        if keys == ('loss',):
            out = {k: float(v) for k, v in logs.items() if k != 'loss'}
            out['loss/total'] = float(logs['loss'])
            return out
        return {f'loss/{k}': float(v) for k, v in logs.items()}

    def _step_progress(self, i: int, n_batches: int, items: int, t0: float,
                       logs, keys) -> None:
        """srtpu's in-epoch progress line every ``log_every_n_steps``
        batches (on the global step) and the train losses to the
        trackers; one host read each time."""
        cfg = self.cfg
        n = cfg.log_every_n_steps
        if not cfg.enable_progress_log or n <= 0 or \
                self.global_step - self._last_progress_step < n:
            return
        self._last_progress_step = self.global_step
        vals = {k: float(logs[k]) for k in keys if k in logs}
        _logger.info('epoch %d  step %d%s  %s  %.1f items/s',
                     self.current_epoch + 1, i + 1,
                     f'/{n_batches}' if n_batches else '',
                     '  '.join(f'{k} {v:.4f}' for k, v in vals.items()),
                     items / max(time.time() - t0, 1e-9))
        self.tb.scalars({f'train/{k}': v for k, v in vals.items()},
                        self.global_step)

    def _record_run_artifacts(self) -> None:
        """The checkpoints and run.log as tracker assets, then a flush
        (on success and on a crash)."""
        try:
            for path in (self.root / 'checkpoints', self.root / 'run.log'):
                if path.exists():
                    self.tb.asset(path)
            self.tb.flush()
        except Exception:
            _logger.warning('recording run artifacts failed', exc_info=True)

    # ---------------------------------------------------------- validation

    def _run_validation(self, eval_step, datamodule, limit=None,
                        sanity: bool = False) -> dict[str, float]:
        """One val pass (srtpu ``_run_validation``): ``{dataset/metric:
        mean}``; unless ``sanity``, the metrics to the trackers, the val
        line and the epoch's images."""
        cfg = self.cfg
        all_metrics: dict[str, float] = {}
        if eval_step is None:
            return all_metrics
        limit = limit if limit is not None else cfg.limit_val_batches
        device = self._device
        for ds_name, loader in zip(datamodule.eval_dataset_names,
                                   datamodule.eval_loaders()):
            per_metric: dict[str, list[float]] = {}
            for i, batch in enumerate(loader):
                if limit is not None and i >= limit:
                    break
                lr, hr, mask = (torch.from_numpy(a).to(device)
                                for a in (batch.lr, batch.hr, batch.mask))
                sr, results = eval_step(lr, hr, mask, batch.hr_size)
                results = {k: float(v) for k, v in results.items()}
                for k, v in results.items():
                    per_metric.setdefault(k, []).append(v)
                if not sanity and self._should_save_images(i):
                    self._save_val_images(ds_name, batch, sr, results)
            for k, vals in per_metric.items():
                all_metrics[f'{ds_name}/{k}'] = float(np.mean(vals))
        if not sanity and all_metrics:
            self.tb.scalars(all_metrics, self.global_step)
            pbar = {k: v for k, v in all_metrics.items()
                    for m in cfg.metrics_for_pbar if m in k}
            _logger.info('val @ epoch %d: %s', self.current_epoch + 1,
                         '  '.join(f'{k}={v:.4f}' for k, v in
                                   (pbar or all_metrics).items()))
        return all_metrics

    def _should_save_images(self, batch_idx: int) -> bool:
        cfg = self.cfg
        e, last = self.current_epoch + 1, cfg.max_epochs
        gate = (cfg.save_results_from_epoch == 'all'
                or (cfg.save_results_from_epoch == 'last' and e == last)
                or (cfg.save_results_from_epoch == 'half' and e == last // 2)
                or (cfg.save_results_from_epoch == 'quarter'
                    and e == last // 4))
        return gate and (cfg.save_results == -1
                         or batch_idx < cfg.save_results)

    def _save_val_images(self, ds_name: str, batch, sr, results) -> None:
        """The SR and its 96 px centre crop (images of at least 96 x 96)
        as ``<root>/<dataset>/<image>/epoch_%05d[_center].png``, and the
        per-image metrics as ``<dataset>/<image>/<metric>`` (srtpu
        ``_save_val_images``). With ``edge_loss`` or ``pencil_sketch`` in
        the DSL (``_edge_ops``) also their maps, computed on the card: of
        the SR and its crop (``_edges``, ``_center_edges``; ``_sketch``,
        ``_center_sketch``) and, once per image and op, of the HR and its
        crop (``_hr_edges``, ``_hr_center_edges``, ...)."""
        name = batch.names[0]
        e = self.current_epoch + 1
        hs, ws = batch.hr_size
        sr_np = sr[0, :hs, :ws].float().cpu().numpy()
        imgs = [(sr_np, '')]
        sr_crop = None
        if hs >= 96 and ws >= 96:
            sr_crop = center_crop(sr_np, 96, 96)
            imgs.append((sr_crop, '_center'))
        for op in self._edge_ops:
            fn, sfx = (extract_edges, 'edges') if op == 'edge_loss' else \
                (pencil_sketch, 'sketch')

            def tform(a, fn=fn):
                with torch.inference_mode():
                    x = torch.from_numpy(np.ascontiguousarray(a[None]))
                    return fn(x.to(self._device))[0].cpu().numpy()
            imgs.append((tform(sr_np), f'_{sfx}'))
            if sr_crop is not None:
                imgs.append((tform(sr_crop), f'_center_{sfx}'))
            if (ds_name, name, op) not in self._saved_hr_versions:
                hr_np = np.asarray(batch.hr)[0, :hs, :ws]
                imgs.append((tform(hr_np), f'_hr_{sfx}'))
                if sr_crop is not None:
                    imgs.append((tform(center_crop(hr_np, 96, 96)),
                                 f'_hr_center_{sfx}'))
                self._saved_hr_versions.add((ds_name, name, op))
        out_dir = self.root / ds_name / name
        for img, suffix in imgs:
            save_image(img, out_dir / f'epoch_{e:05d}{suffix}.png')
            self.tb.image(f'{ds_name}/{name}/epoch_{e:05d}{suffix}', img,
                          self.global_step)
        self.tb.scalars({f'{ds_name}/{name}/{k}': v
                         for k, v in results.items()}, self.global_step)

    # ------------------------------------------------------------ routing

    def _tiled_gate(self, model):
        """(scale, tile, overlap) when the tiled steps apply: ``eval_tile``
        > 0 and a ``'cs'`` model without ``GLOBAL_POOLING`` (RCAN's
        channel attention pools over the image, which a tile would change),
        on any device; else None (srtpu ``_tiled_gate`` without its TPU
        check)."""
        cfg = self.cfg
        if (cfg.eval_tile <= 0 or getattr(model, 'use_pallas', None) != 'cs'
                or getattr(model, 'GLOBAL_POOLING', False)):
            return None
        return model.scale_factor, cfg.eval_tile, cfg.eval_tile_overlap

    def _route_tiled(self, model, lr_shape) -> bool:
        """srtpu's rule: tile an LR shape no direct plan of its lane budget
        takes (``tiled.route_tiled``)."""
        return route_tiled(lr_shape, getattr(model, 'n_feats', 64))

    def _make_eval_step(self, metrics: dict, model: torch.nn.Module,
                        tiled: bool = True):
        """``eval_step(lr, hr, mask, hr_size=None) -> (sr, {name: 0-dim})``
        in name order: the full-reference metrics in the direct eval step
        or, where ``tiled`` and the gate open, in the tiled step for each
        shape the router picks; a no-reference metric (BRISQUE) once, on
        the SR cropped to ``hr_size``, the image's true shape (the
        bucket's edge padding moves its global statistics; srtpu scores it
        again there)."""
        ref = {k: fn for k, fn in metrics.items() if k not in NO_REFERENCE}
        no_ref = {k: fn for k, fn in metrics.items() if k in NO_REFERENCE}
        direct = make_eval_step(model, ref)
        gate = self._tiled_gate(model) if tiled else None
        tiled_step = None if gate is None else \
            make_tiled_eval_step(model, ref, *gate)

        def eval_step(lr, hr, mask, hr_size=None):
            step = direct
            if tiled_step is not None and self._route_tiled(model, lr.shape):
                step = tiled_step
            sr, results = step(lr, hr, mask)
            hs, ws = hr_size or sr.shape[1:3]
            with torch.inference_mode():
                results.update({k: fn(sr[:, :hs, :ws])
                                for k, fn in no_ref.items()})
            return sr, {k: results[k] for k in sorted(results)}

        return eval_step

    # ----------------------------------------------------------- validate

    def validate(self, model: torch.nn.Module, datamodule,
                 metrics=None) -> dict[str, float]:
        """Score ``model`` (eval mode, on its device) on every eval
        dataset of ``datamodule`` with ``metrics`` (default the config's),
        at most ``limit_val_batches`` images each: srtpu's val pass (the
        trackers, the ``val`` line, the epoch's images); returns
        ``{dataset/metric: mean over images}``. Each metric is read to
        the host once an image."""
        datamodule.setup('validate')
        self._device = next(model.parameters()).device
        eval_step = self._make_eval_step(
            build_metrics(list(metrics or self.cfg.metrics)), model)
        self._edge_ops = []
        return self._run_validation(eval_step, datamodule)

    # ------------------------------------------------------------ predict

    def predict(self, model: torch.nn.Module, datamodule) -> list[Path]:
        """Super-resolve every predict image on the model's device in eval
        mode, crop the SR to its true size, write
        ``<root>/<dataset>/<name>.png`` and, for images of at least
        96 x 96, ``<name>_center.png``. Returns the SR image paths. The
        route of each image is srtpu's (the module docstring)."""
        datamodule.setup('predict')
        device = next(model.parameters()).device
        predict_step = make_predict_step(model)
        gate = self._tiled_gate(model)
        tiled_step = None if gate is None else \
            make_tiled_predict_step(model, *gate)
        cfg, scale = self.cfg, datamodule.scale_factor
        written = []
        for ds_name, loader in zip(datamodule.predict_dataset_names,
                                   datamodule.predict_loaders()):
            for batch in loader:
                hs, ws = batch.hr_size
                lh, lw = hs // scale, ws // scale
                if tiled_step is not None and \
                        self._route_tiled(model, batch.lr.shape):
                    g = cfg.eval_tile
                    src = np.pad(batch.lr[:, :lh, :lw],
                                 ((0, 0), (0, -(-lh // g) * g - lh),
                                  (0, -(-lw // g) * g - lw), (0, 0)),
                                 mode='edge')
                    sr = tiled_step(torch.from_numpy(src).to(device))
                    sr_np = sr[0, :hs, :ws].cpu().numpy()
                elif cfg.predict_tile and \
                        min(batch.lr.shape[1:3]) > cfg.predict_tile:
                    sr_np = tiled_predict(
                        lambda t: predict_step(
                            torch.from_numpy(t).to(device)).cpu().numpy(),
                        batch.lr[0, :lh, :lw], scale, tile=cfg.predict_tile,
                        overlap=cfg.predict_tile_overlap)[:hs, :ws]
                else:
                    sr = predict_step(torch.from_numpy(batch.lr).to(device))
                    sr_np = sr[0, :hs, :ws].cpu().numpy()
                name = batch.names[0]
                path = self.root / ds_name / f'{name}.png'
                save_image(sr_np, path)
                written.append(path)
                if hs >= 96 and ws >= 96:
                    save_image(center_crop(sr_np, 96, 96),
                               self.root / ds_name / f'{name}_center.png')
                _logger.info('predicted %s/%s (%dx%d)', ds_name, name, hs, ws)
        return written
