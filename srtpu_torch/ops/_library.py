"""The forward kernels that an eval route reaches, as registered torch
operators in the ``srtpu`` namespace.

ctypes launches are invisible to a tracer, so ``torch.export`` could not
hold a program that runs the port's kernels. Each forward launch an eval
route makes is therefore one operator here: its CUDA implementation is
the wrapper module's ctypes launch (with its ``_build.expect`` checks,
its scratch and its launch counter, none of which a fake tensor could
take), its CPU implementation the plain version, and its fake
implementation gives the output shapes and dtypes without touching
memory. The wrappers (``conv3x3_fwd``, ``trunk_fwd``, ...) call the
operators, in eager runs and inside the ``autograd.Function`` forwards
alike, so an exported program launches the same kernels as eager
predict. The backward launches stay plain ctypes calls inside each
Function's ``backward``: export traces no backward.

The operators are defined with ``torch.library.Library`` (``define``,
``impl`` per device, ``register_fake``) rather than the
``torch.library.custom_op`` decorator, whose Python wrapper costs more
host time a call. Importing :mod:`srtpu_torch.ops` registers them; a
saved ``torch.export`` artifact that holds them loads only after that
import (:func:`srtpu_torch.export.load`).

=========================  ==============================  ===========
operator                   launch                          K
=========================  ==============================  ===========
``srtpu::conv_fwd``        ``srt_conv3x3_fwd`` / ``5x5``   K2
``srtpu::trunk_fwd``       ``srt_trunk_fwd``               K1
``srtpu::upsample_fwd``    ``srt_upsample_fwd``            K3
``srtpu::rcab_group_fwd``  ``srt_rcab_group_fwd``          K5
``srtpu::rdn_fwd``         ``srt_rdn_fwd``                 K6
``srtpu::wdsr_trunk_fwd``  ``srt_wdsr_trunk_fwd``          K7
``srtpu::resblock_trunk_fwd``  ``srt_resblock_f32_fwd``    K8a
``srtpu::ca_layer_fwd``    ``srt_ca_layer_fwd``            K8b
``srtpu::wdsr_block_fwd``  ``srt_wdsr_block_fwd``          K8c
=========================  ==============================  ===========

An operator taking ``save`` returns a list: ``[out]``, or with ``save``
what the Function's backward reads. ``rcab_group_fwd`` writes its RCABs'
outputs into ``ys`` when given (``Tensor(a!)?``; the training forward),
and returns ``[h1s, r2s]`` then, else ``[out]``.
"""

from __future__ import annotations

import torch

from .ca_layer import ca_layer_fwd_cuda, ca_layer_plain
from .conv import conv3x3_plain, conv_fwd_cuda
from .rcab import group_fwd_cpu, group_fwd_cuda
from .rdn import rdn_fwd_cuda, rdn_fwd_plain
from .resblock import resblock_trunk_fwd_cuda, resblock_trunk_plain
from .trunk import trunk_fwd_cuda, trunk_plain
from .upsample import upsample_fwd_cuda, upsample_plain
from .wdsr import kernel_c, wdsr_trunk_fwd_cuda, wdsr_trunk_plain
from .wdsr_block import wdsr_block_fused_plain, wdsr_block_fwd_cuda

LIB = torch.library.Library('srtpu', 'DEF')


def _listed(plain):
    """A plain version taking ``save`` last, returning the operator's
    list: ``[out]``, or with ``save`` ``[out, *saved]``."""
    def impl(*args):
        got = plain(*args)
        return list(got) if args[-1] else [got]
    return impl


def _like(x, shape=None, dtype=None):
    """A new tensor of ``shape`` (x's) and ``dtype`` (x's) on x's device:
    under a fake mode, a fake one."""
    return x.new_empty(x.shape if shape is None else shape,
                       dtype=x.dtype if dtype is None else dtype)


def _conv_fake(x, w, b, relu):
    return _like(x, (*x.shape[:-1], w.shape[-1]))


def _trunk_fake(x, w1s, b1s, w2s, b2s, res_scale, save):
    stack = (w1s.shape[0], *x.shape)
    return [_like(x), _like(x, stack), _like(x, stack)] if save else \
        [_like(x)]


def _upsample_fake(x, w, b, r):
    bsz, h, wd, c = x.shape
    return _like(x, (bsz, r * h, r * wd, c))


def _rcab_group_fake(x, w1s, b1s, w2s, b2s, wds, bds, wus, bus, ys):
    stack = (w1s.shape[0], *x.shape)
    return [_like(x)] if ys is None else [_like(x, stack), _like(x, stack)]


def _rdn_fake(x, wpk, b, wf, bf, save):
    d, _, g0 = b.shape
    bsz, h, w, _ = x.shape
    cat = _like(x, (bsz, h, w, d * g0))
    return [cat, _like(x, (d, bsz, h, w, wf.shape[1]))] if save else [cat]


def _wdsr_trunk_fake(x, w1s, b1s, w2s, b2s, w3s, b3s, res_scale, save):
    if not save:
        return [_like(x)]
    n_blocks, c, _ = w1s.shape
    if x.device.type == 'cuda':     # saved at the kernels' width
        cs = cl = kernel_c(c)
    else:                           # the plain version's: x's, h2's
        cs, cl = c, w2s.shape[-1]
    return [_like(x), _like(x, (n_blocks, *x.shape[:-1], cs)),
            _like(x, (n_blocks, *x.shape[:-1], cl))]


def _resblock_trunk_fake(x, w1s, b1s, w2s, b2s, res_scale, save):
    n_blocks = w1s.shape[0]
    return [_like(x), _like(x, (n_blocks - 1, *x.shape)),
            _like(x, (n_blocks, *x.shape))] if save else [_like(x)]


def _ca_layer_fake(x, w1, b1, w2, b2):
    return _like(x)


def _wdsr_block_fake(x, w1, b1, w2, b2, w3, b3, res_scale):
    return _like(x)


# schema, CUDA implementation, CPU implementation, fake implementation
OPS = (
    ('conv_fwd(Tensor x, Tensor w, Tensor? b, bool relu) -> Tensor',
     conv_fwd_cuda, conv3x3_plain, _conv_fake),
    ('trunk_fwd(Tensor x, Tensor w1s, Tensor b1s, Tensor w2s, Tensor b2s, '
     'float res_scale, bool save) -> Tensor[]',
     trunk_fwd_cuda, _listed(trunk_plain), _trunk_fake),
    ('upsample_fwd(Tensor x, Tensor w, Tensor b, int r) -> Tensor',
     upsample_fwd_cuda, upsample_plain, _upsample_fake),
    ('rcab_group_fwd(Tensor x, Tensor w1s, Tensor b1s, Tensor w2s, '
     'Tensor b2s, Tensor wds, Tensor bds, Tensor wus, Tensor bus, '
     'Tensor(a!)? ys) -> Tensor[]',
     group_fwd_cuda, group_fwd_cpu, _rcab_group_fake),
    ('rdn_fwd(Tensor x, Tensor wpk, Tensor b, Tensor wf, Tensor bf, '
     'bool save) -> Tensor[]',
     rdn_fwd_cuda, _listed(rdn_fwd_plain), _rdn_fake),
    ('wdsr_trunk_fwd(Tensor x, Tensor w1s, Tensor b1s, Tensor w2s, '
     'Tensor b2s, Tensor w3s, Tensor b3s, float res_scale, bool save) '
     '-> Tensor[]',
     wdsr_trunk_fwd_cuda, _listed(wdsr_trunk_plain), _wdsr_trunk_fake),
    ('resblock_trunk_fwd(Tensor x, Tensor w1s, Tensor b1s, Tensor w2s, '
     'Tensor b2s, float res_scale, bool save) -> Tensor[]',
     resblock_trunk_fwd_cuda, _listed(resblock_trunk_plain),
     _resblock_trunk_fake),
    ('ca_layer_fwd(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2) '
     '-> Tensor',
     ca_layer_fwd_cuda, ca_layer_plain, _ca_layer_fake),
    ('wdsr_block_fwd(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2, '
     'Tensor w3, Tensor b3, float res_scale) -> Tensor',
     wdsr_block_fwd_cuda, wdsr_block_fused_plain,
     _wdsr_block_fake),
)

NAMES = tuple(schema.split('(', 1)[0] for schema, *_ in OPS)

for _schema, _cuda, _cpu, _fake in OPS:
    _name = _schema.split('(', 1)[0]
    LIB.define(_schema)
    LIB.impl(_name, _cuda, 'CUDA')
    LIB.impl(_name, _cpu, 'CPU')
    torch.library.register_fake(f'srtpu::{_name}', _fake, lib=LIB)


def operator(name: str):
    """The registered ``srtpu::<name>`` overload."""
    return getattr(torch.ops.srtpu, name).default
