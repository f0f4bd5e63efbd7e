"""Weight gradient of a k x k SAME conv (k = 3, or 5 for the phase-dense
final convs of SRResNet's tail), or of a 3x3 REFLECT conv (SRGAN's BN
blocks: torch ReflectionPad2d(1) + a valid conv): dW and db in f32, the
half of the K1-K5 backward passes that the TPU kernels accumulate in
resident f32 scratch (``srtpu/ops/cs_conv.py``: ``_conv_bwd_kernel``,
``_ups_conv_bwd_kernel``, ``_trunk_bwd_kernel_mega``;
``srtpu/ops/bn_resblock_cs.py``: ``_b2_kernel``, ``_b3_kernel``).

The kernel is ``csrc/wgrad.cu``, whose head note says what bounds it on
the H100 and how it stays deterministic (per-block partials added in a
fixed order). :func:`conv_wgrad` launches it for CUDA tensors and takes
the plain version only for CPU tensors; it counts ``launches`` on the
instances of their own and ``launches_general`` on the general path
(any other multiples of 16: DDBPN's and the x3 tails' shapes).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import _build
from .layout import pm_from_fine

TH, TW = 8, 16          # the kernel's pixel tile
TARGET_BLOCKS = 264     # two blocks per SM of the H100's 132


def _gather(g: torch.Tensor, gscale: float, r: int) -> torch.Tensor:
    """The G the kernel reads: phase-major when r > 1, then
    ``bf16(gscale * g)`` in g's dtype when gscale != 1."""
    if r > 1:
        g = pm_from_fine(g, r)
    if gscale != 1.0:
        g = (g.float() * gscale).to(g.dtype)
    return g


def _dw_one(x: torch.Tensor, g: torch.Tensor, k: int,
            reflect: bool = False) -> torch.Tensor:
    bsz, h, w, cin = x.shape
    xc = x.permute(0, 3, 1, 2).float()
    if reflect:
        xc = F.pad(xc, (k // 2,) * 4, mode='reflect')
    cols = F.unfold(xc, k, padding=0 if reflect else k // 2)
    dw = torch.einsum('bkp,bpc->kc', cols, g.reshape(bsz, h * w, -1).float())
    return dw.reshape(cin, k, k, -1).permute(1, 2, 0, 3)


def conv_wgrad_plain(x: torch.Tensor, g: torch.Tensor, gscale: float = 1.0,
                     r: int = 1, k: int = 3, reflect: bool = False
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: x (..., B, H, W, Cin); g (..., B, H, W, Cout), or for
    r > 1 fine (..., B, r*H, r*W, Cout / (r*r)) read phase-major. Returns
    dW (..., k, k, Cin, Cout) and db (..., Cout), f32 sums of the
    products of the bf16 (or f32) inputs; ``reflect`` reads x's halo
    mirrored."""
    lead = x.shape[:-4]
    xs = x.reshape(-1, *x.shape[-4:])
    gs = g.reshape(-1, *g.shape[-4:])
    dws, dbs = [], []
    for xj, gj in zip(xs, gs):
        gj = _gather(gj, gscale, r)
        dws.append(_dw_one(xj, gj, k, reflect))
        dbs.append(gj.float().sum((0, 1, 2)))
    return (torch.stack(dws).reshape(*lead, *dws[0].shape),
            torch.stack(dbs).reshape(*lead, -1))


def _own_instance(cin: int, cout: int, r: int, k: int) -> bool:
    """The shapes with an instance of their own (the EDSR, RCAN, SRResNet
    and RDN paths); the rest go to the general path."""
    if k == 5:
        return cin == 256 and cout % 16 == 0 and r <= 1
    return k == 3 and ((cin == 64 and cout % 64 == 0)
                       or (cin == 256 and cout % 16 == 0 and r <= 1))


def _kernel_takes(cin: int, cout: int, r: int, k: int) -> bool:
    return _own_instance(cin, cout, r, k) or (
        k in (3, 5) and cin % 16 == 0 and cout % 16 == 0 and r <= 1)


def _blocks_per_part(cin: int, cout: int, r: int, k: int) -> int:
    """Blocks of one job's part: the kernel's grid.y. Own instances: the
    output chunks (times the 5 tap-row groups at 5x5); the general path
    (wgrad.cu: chunked): the X chunks of CK channels times the output
    chunks of NB, CK and NB chosen as there."""
    if _own_instance(cin, cout, r, k):
        return cout // (64 if cin == 64 else 16) * (5 if k == 5 else 1)
    ck = 64 if k == 3 and cin % 64 == 0 else 32 if cin % 32 == 0 else 16
    nb = 32 if cout % 32 == 0 else 16
    return cin // ck * (cout // nb)


def conv_wgrad(x: torch.Tensor, g: torch.Tensor, gscale: float = 1.0,
               r: int = 1, k: int = 3, reflect: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """As :func:`conv_wgrad_plain`, with bf16 x and g. On CUDA, k = 3 or 5
    with Cin and Cout multiples of 16 (r = 1), and at k = 3 Cin = 64 with
    Cout = r*r*64 when gathering; ``reflect`` at k = 3, Cin = 64, Cout a
    multiple of 64, r = 1 and H, W >= 2 (counted on ``launches``).
    Leading dims of x and g are stacked jobs, one launch for all."""
    if x.device.type == 'cpu':
        return conv_wgrad_plain(x, g, gscale, r, k, reflect)
    out = wgrad_launch(x, g, gscale, r, k, reflect)
    cin, cout = x.shape[-1], g.shape[-1] * (r * r if r > 1 else 1)
    if _own_instance(cin, cout, r, k):
        conv_wgrad.launches += 1
    else:
        conv_wgrad.launches_general += 1
    return out


def wgrad_launch(x: torch.Tensor, g: torch.Tensor, gscale: float = 1.0,
                 r: int = 1, k: int = 3, reflect: bool = False
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`conv_wgrad`'s launch on CUDA tensors, counted by its caller
    (K7's backward counts it on its own wrapper)."""
    if x.device.type != 'cuda':
        raise ValueError(f'conv_wgrad: no kernel for device {x.device}')
    lead = tuple(x.shape[:-4])
    bsz, h, w, cin = x.shape[-4:]
    cout = g.shape[-1] * (r * r if r > 1 else 1)
    if not _kernel_takes(cin, cout, r, k) or reflect and not (
            k == 3 and cin == 64 and cout % 64 == 0 and r <= 1
            and min(h, w) >= 2):
        raise ValueError(f'conv_wgrad: no kernel for {cin} -> {cout} '
                         f'channels (r={r}, k={k}, reflect={reflect}, '
                         f'{h}x{w})')
    dev = x.device
    n_jobs = math.prod(lead)
    g_shape = (*lead, bsz, r * h, r * w, cout // (r * r)) if r > 1 \
        else (*lead, bsz, h, w, cout)
    _build.expect(x, 'x', torch.bfloat16, x.shape, dev)
    _build.expect(g, 'g', torch.bfloat16, g_shape, dev)
    chunks = _blocks_per_part(cin, cout, r, k)
    tiles = bsz * -(-h // TH) * -(-w // TW)
    nparts = max(1, min(tiles, TARGET_BLOCKS // (n_jobs * chunks)))
    f32 = dict(dtype=torch.float32, device=dev)
    ws_w = torch.empty((n_jobs, nparts, k * k * cin * cout), **f32)
    ws_b = torch.empty((n_jobs, nparts, cout), **f32)
    dw = torch.empty((*lead, k, k, cin, cout), **f32)
    db = torch.empty((*lead, cout), **f32)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.srt_conv_wgrad(
            x.data_ptr(), g.data_ptr(), ws_w.data_ptr(), ws_b.data_ptr(),
            dw.data_ptr(), db.data_ptr(), n_jobs, bsz * h * w * cin,
            g[(0,) * len(lead)].numel(), bsz, h, w, cin, cout, r,
            float(gscale), nparts, k, int(reflect), _build.stream(dev))
    _build.check(err, 'srt_conv_wgrad')
    return dw, db


# launches on the instances of their own, and on the general path
conv_wgrad.launches = conv_wgrad.launches_general = 0
