"""Weight gradient of a k x k SAME conv (k = 3, or 5 for the phase-dense
final convs of SRResNet's tail), or of a 3x3 REFLECT conv (SRGAN's BN
blocks: torch ReflectionPad2d(1) + a valid conv): dW and db in f32, the
half of the K1-K5 backward passes that the TPU kernels accumulate in
resident f32 scratch (``srtpu/ops/cs_conv.py``: ``_conv_bwd_kernel``,
``_ups_conv_bwd_kernel``, ``_trunk_bwd_kernel_mega``;
``srtpu/ops/bn_resblock_cs.py``: ``_b2_kernel``, ``_b3_kernel``).

The kernel is ``csrc/wgrad.cu``: one wgmma engine for every shape and
mode (its head note says what bounds it on the H100 and how it stays
deterministic). Each job's pixel tiles are summed by a fixed split,
:func:`wgrad_parts`: clusters of blocks that add their f32 sums in rank
order through distributed shared memory, and, where one job needs more
than a cluster, partial slots added in order after. :func:`geometry`
mirrors the engine's split of dW into blocks. :func:`conv_wgrad`
launches it for CUDA tensors and takes the plain version only for CPU
tensors; it counts ``launches`` on the EDSR / RCAN / SRResNet / RDN
shapes and ``launches_general`` on the others (DDBPN's and the x3
tails').
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from . import _build
from .layout import pm_from_fine

TH, TW = 8, 16          # the kernel's pixel tile
# The plan's model of the H100 (one block an SM), fitted to the times of
# every split of 17 classes at the training shape on the card (the fitted
# splits are within 5% of the fastest measured). Clusters of c blocks the
# card holds at once (cudaOccupancyMaxActiveClusters: its 132 SMs sit in
# GPCs of 16-18, so 8-block clusters fit 15 times, not 16); a split past
# these runs in more waves.
CLUSTERS_AT_ONCE = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
TILE_US = 2.4           # one tile of a block of nine M-tiles at N = 64
SLOT_BYTES_PER_US = 2.0e6   # the partial slots' writes and reads
MAX_WAVES = 4


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


@functools.lru_cache(maxsize=None)
def _own_instance(cin: int, cout: int, r: int, k: int) -> bool:
    """The shapes the EDSR, RCAN, SRResNet and RDN paths launch (counted
    on ``launches``); the rest, DDBPN's, the x3 tails', K9c's and K7's,
    are the general path (``launches_general``). One engine runs both."""
    if k == 5:
        return cin == 256 and cout % 16 == 0 and r <= 1
    return k == 3 and ((cin == 64 and cout % 64 == 0)
                       or (cin == 256 and cout % 16 == 0 and r <= 1))


@functools.lru_cache(maxsize=None)
def _kernel_takes(cin: int, cout: int, r: int, k: int,
                  reflect: bool = False, h: int = 2, w: int = 2,
                  n_jobs: int = 1) -> bool:
    """What ``srt_conv_wgrad`` takes (wgrad.cu checks the same)."""
    if k not in (3, 5) or cin % 16 or cout % 16 or min(cin, cout) <= 0:
        return False
    if r > 1 and (cout % (r * r) or cout // (r * r) % 16 or n_jobs != 1):
        return False
    return not reflect or (k == 3 and cin == 64 and cout % 64 == 0
                           and r <= 1 and min(h, w) >= 2)


@functools.lru_cache(maxsize=None)
def geometry(cin: int, cout: int, r: int = 1, k: int = 3) -> dict:
    """The engine's split of one job's dW (wgrad.cu, srt_conv_wgrad):
    ``form_g`` (cout 16-48: A = G, the taps stacked along M; else A = X),
    A's channels ``ca`` in chunks of ``aw`` (64; at k = 1, where the
    engine takes 64-multiples, 192 or 128 where they divide it, an M-tile
    a consumer warpgroup), ``mtiles`` 64-row M-tiles a
    chunk in ``mgroups`` blocks of three warpgroups keeping ``mt`` each
    (at most 3: 96 f32 sums a thread at ``na`` = 64), B's channels in
    ``nchunks`` of ``na``; ``blocks``: the blocks over one pixel part."""
    form_g = cout <= 48 and r <= 1
    ca, nb = (cout, cin) if form_g else (cin, cout)
    aw = (next(a for a in (192, 128, 64) if ca % a == 0) if k == 1
          else min(ca, 64))
    fit = cout // (r * r) if r > 1 else nb
    na = next(n for n in (64, 32, 16) if nb % n == 0 and fit % n == 0)
    mtiles = -(-k * k * aw // 64)
    mt = 3 if mtiles >= 7 else -(-mtiles // 3)
    mgroups = -(-mtiles // (3 * mt))
    nchunks = nb // na
    blocks = -(-ca // aw) * mgroups * nchunks
    return dict(form_g=form_g, ca=ca, aw=aw, mtiles=mtiles, mt=mt,
                mgroups=mgroups, na=na, nchunks=nchunks, blocks=blocks)


@functools.lru_cache(maxsize=None)
def wgrad_parts(bsz: int, h: int, w: int, cin: int, cout: int, r: int = 1,
                k: int = 3, n_jobs: int = 1) -> tuple[int, int]:
    """(cluster, clusters): each job's TH x TW pixel tiles are split into
    cluster * clusters fixed runs, one block each. A cluster's blocks add
    their f32 sums in rank order through distributed shared memory; with
    more than one cluster a job, each writes a partial slot (the
    workspace, :func:`wgrad_workspace`), added in order by a second
    pass. The split is the one the model says is fastest: the waves
    (CLUSTERS_AT_ONCE) times the tiles of a block, plus the slots'
    traffic."""
    tiles = bsz * -(-h // TH) * -(-w // TW)
    geo = geometry(cin, cout, r, k)
    base = n_jobs * geo['blocks']
    rows = min(geo['mtiles'], 3 * geo['mt']) * 64  # dW rows a block sums
    tile_us = TILE_US * rows / 576 * geo['na'] / 64
    slot_bytes = 4 * n_jobs * k * k * cin * cout
    best, best_us = (1, 1), float('inf')
    for cluster, at_once in CLUSTERS_AT_ONCE.items():
        for clusters in range(1, tiles // cluster + 1):
            waves = -(-base * clusters // at_once)
            if waves > MAX_WAVES:
                break
            us = waves * -(-tiles // (cluster * clusters)) * tile_us
            if clusters > 1:
                us += 2 * clusters * slot_bytes / SLOT_BYTES_PER_US
            if us < best_us:
                best, best_us = (cluster, clusters), us
    return best


def wgrad_workspace(n_jobs: int, cluster: int, clusters: int, cin: int,
                    cout: int, k: int, device) -> tuple:
    """The partial slots a split writes where it has more than one cluster
    a job: (n_jobs, clusters, k k cin cout) and (n_jobs, clusters, cout)
    f32, else none (empty); every caller of the kernel sizes them here."""
    slots = clusters if clusters > 1 else 0
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((n_jobs, slots, k * k * cin * cout), **f32),
            torch.empty((n_jobs, slots, cout), **f32))


def conv_wgrad(x: torch.Tensor, g: torch.Tensor, gscale: float = 1.0,
               r: int = 1, k: int = 3, reflect: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """As :func:`conv_wgrad_plain`, with bf16 x and g. On CUDA: k = 3 or 5,
    Cin and Cout multiples of 16, gathering (r > 1, one job) Cout / r^2 a
    multiple of 16; ``reflect`` at k = 3, Cin = 64, Cout a multiple of 64,
    r = 1 and H, W >= 2. Leading dims of x and g are stacked jobs, one
    launch for all."""
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
    lead = x.shape[:-4]
    bsz, h, w, cin = x.shape[-4:]
    cout = g.shape[-1] * (r * r if r > 1 else 1)
    n_jobs = math.prod(lead)
    if not _kernel_takes(cin, cout, r, k, reflect, h, w, n_jobs):
        raise ValueError(f'conv_wgrad: no kernel for {cin} -> {cout} '
                         f'channels (r={r}, k={k}, reflect={reflect}, '
                         f'{h}x{w}, {n_jobs} jobs)')
    dev = x.device
    g_shape = (*lead, bsz, r * h, r * w, cout // (r * r)) if r > 1 \
        else (*lead, bsz, h, w, cout)
    _build.expect(x, 'x', torch.bfloat16, x.shape, dev)
    _build.expect(g, 'g', torch.bfloat16, g_shape, dev)
    cluster, clusters = wgrad_parts(bsz, h, w, cin, cout, r, k, n_jobs)
    ws = (wgrad_workspace(n_jobs, cluster, clusters, cin, cout, k, dev)
          if clusters > 1 else None)
    # dW and db in one allocation (an allocation costs microseconds a call)
    nw = n_jobs * k * k * cin * cout
    out = x.new_empty((nw + n_jobs * cout,), dtype=torch.float32)
    dw = out[:nw].view(*lead, k, k, cin, cout)
    db = out[nw:].view(*lead, cout)
    with _build.on(dev):
        err = _build.library().srt_conv_wgrad(
            x.data_ptr(), g.data_ptr(), ws and ws[0].data_ptr(),
            ws and ws[1].data_ptr(), dw.data_ptr(), db.data_ptr(), n_jobs,
            bsz * h * w * cin, g.numel() // n_jobs, bsz, h, w, cin, cout, r,
            float(gscale), cluster, clusters, k, int(reflect),
            _build.stream(dev))
    _build.check(err, 'srt_conv_wgrad')
    return dw, db


# launches on the EDSR / RCAN / SRResNet / RDN shapes, and on the others
conv_wgrad.launches = conv_wgrad.launches_general = 0
