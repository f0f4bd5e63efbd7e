"""Serving export (srtpu ``cmd_export``, srtpu/cli.py:279-331): the eval
forward as a ``torch.export.ExportedProgram``.

:func:`export_serving` traces ``clip(model(lr).float(), 0, 1)`` at one
static LR shape, the weights held in the program, in eval mode and
without autograd; with ``tile > 0`` it traces the device-resident tiled
apply (:func:`~srtpu_torch.train.tiled.make_tiled_apply`, batches of 16
tiles) instead, as srtpu's ``--tile`` traces its tile-batched step.
Tracing is non-strict, so each kernel op's ``autograd.Function`` forward
runs in Python and reaches only the registered ``srtpu::`` operators
(:mod:`srtpu_torch.ops._library`) and stock ops.

A program exported on the card holds ``srtpu::`` operators: it launches
the port's hand-written kernels, the same launches as eager predict, and
runs only where those operators are registered, on a card; this is the
counterpart of srtpu's TPU-only artifacts that embed the Mosaic custom
calls. A program exported on the CPU holds the same operators, which run
their plain versions there. :func:`load` imports :mod:`srtpu_torch.ops`
(which registers the operators and builds the kernels at their first
launch) before ``torch.export.load``::

    from srtpu_torch.export import load
    sr = load('model.pt2').module()(lr)     # lr (B, H, W, 3) f32 in [0, 1]
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from pathlib import Path

import torch
from torch import nn

TILE_BATCH = 16     # tiles a forward call of the tiled apply, as srtpu's


class ServingForward(nn.Module):
    """``lr -> clip(f32(model(lr)), 0, 1)``, or through the tiled apply
    with ``tile > 0`` (srtpu's ``serve``)."""

    def __init__(self, model: nn.Module, tile: int = 0, overlap: int = 8):
        super().__init__()
        self.model = model
        self.tiler = None
        if tile > 0:
            from .train.tiled import make_tiled_apply
            self.tiler = make_tiled_apply(model.scale_factor, tile, tile,
                                          overlap, TILE_BATCH)

    def forward(self, lr: torch.Tensor) -> torch.Tensor:
        sr = (self.model(lr) if self.tiler is None
              else self.tiler(self.model, lr))
        return sr.float().clamp(0.0, 1.0)


def export_serving(model: nn.Module, batch: int, h: int, w: int,
                   tile: int = 0, overlap: int = 8
                   ) -> torch.export.ExportedProgram:
    """The serving forward of ``model`` (on its device) for LR (batch, h,
    w, channels) f32, exported with static shapes (the modules' forward
    hooks set aside); the model's mode is restored after."""
    import srtpu_torch.ops  # noqa: F401  the srtpu:: operators
    param = next(model.parameters())
    lr = torch.zeros((batch, h, w, getattr(model, 'channels', 3)),
                     dtype=torch.float32, device=param.device)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), _hooks_off(model):
            return torch.export.export(ServingForward(model, tile, overlap),
                                       (lr,), strict=False)
    finally:
        model.train(was_training)


@contextlib.contextmanager
def _hooks_off(model: nn.Module):
    """The modules' forward hooks and pre-hooks set aside while tracing:
    a caller's instrumentation is not part of the serving program, and
    the trace is not one of the caller's forwards."""
    kept = [(m, m._forward_hooks, m._forward_pre_hooks)
            for m in model.modules()]
    for m, _, _ in kept:
        m._forward_hooks, m._forward_pre_hooks = OrderedDict(), OrderedDict()
    try:
        yield
    finally:
        for m, hooks, pre in kept:
            m._forward_hooks, m._forward_pre_hooks = hooks, pre


def graph_text(program: torch.export.ExportedProgram) -> str:
    """The exported graph as text (its ``srtpu::`` operators and stock ops,
    one node a line): srtpu's ``--mlir`` StableHLO text's counterpart."""
    return str(program.graph_module.code)


def save(program: torch.export.ExportedProgram, path) -> int:
    """Write ``program`` to ``path`` (``torch.export.save``); returns its
    size in bytes."""
    torch.export.save(program, str(path))
    return Path(path).stat().st_size


def load(path) -> torch.export.ExportedProgram:
    """A saved serving program, after registering the ``srtpu::``
    operators it calls."""
    import srtpu_torch.ops  # noqa: F401
    return torch.export.load(str(path))


def srtpu_ops(program: torch.export.ExportedProgram) -> dict[str, int]:
    """``{operator name: nodes}`` of the ``srtpu::`` operators in
    ``program``'s graph."""
    out: dict[str, int] = {}
    for node in program.graph.nodes:
        name = getattr(node.target, 'name', None)
        if node.op == 'call_function' and callable(name):
            qual = name()
            if qual.startswith('srtpu::'):
                out[qual] = out.get(qual, 0) + 1
    return out
