"""Tiled inference (srtpu/train/tiled.py): super-resolve an image in
fixed-shape overlapping LR tiles.

* :func:`tiled_predict`, the host form: one (1, tile, tile, C) forward a
  tile, stitched in a numpy array (``predict --predict_tile``);
* :func:`make_tiled_apply`, the device-resident form: every tile window
  gathered on the device, the forward in batches of at most ``batch``
  tiles, each tile's emission rectangle written into the SR image in
  anchor order (b, y, x), so a later tile overwrites an earlier one where
  their emissions overlap, as srtpu's scan does. The SR never leaves the
  device (the tiled eval and predict steps).

Every emitted pixel comes from a tile where it sits at least ``overlap``
LR pixels from a tile edge that is not an image border; interiors are
exact when ``overlap`` is at least the model's receptive-field radius,
and smaller overlaps leave a bounded seam error (ROADMAP.md F2). An image
smaller than a tile is edge-padded up to one.

Also the port's copy of srtpu's routing arithmetic (``S_TARGET``,
``S_MAX``, ``cs_plan``, ``cs_plan_pad``; srtpu/ops/cs_conv.py:44-45,
:60-143) without its TPU backend check: :func:`route_tiled` is srtpu's
``Trainer._route_tiled`` rule, which tiles a shape that no direct plan
of srtpu's lane budget takes.
"""

from __future__ import annotations

import numpy as np
import torch

S_TARGET = 4096          # lanes per group srtpu's kernels are tuned for
S_MAX = 8320             # srtpu's VMEM ceiling for its fused resblock


def receptive_field_radius(model) -> int:
    """Conservative LR receptive-field radius: about one pixel per 3x3
    conv (srtpu's rule; deep RCANs want a larger overlap)."""
    n_blocks = getattr(model, 'n_resblocks', 16)
    return min(max(2 * n_blocks + 16, 24), 96)


def _select_k(b: int, h: int, w: int) -> int:
    """Images per lane row: the largest divisor of b with h w k near
    S_TARGET."""
    k = max(1, S_TARGET // (h * w))
    k = min(k, b)
    while k > 1 and b % k:
        k -= 1
    return k


def cs_plan(shape):
    """srtpu's (k, G) packing of (B, H, W, C) (``cs_plan_s`` at
    S_TARGET, S_MAX), or None."""
    b, h, w, c = shape
    if c % 16 or h < 2 or w < 2:
        return None
    k = _select_k(b, h, w)
    if b % k or h * w * k > S_MAX:
        return None
    if h * w * k % 128:
        for cand in range(min(b, S_MAX // (h * w)), 0, -1):
            if b % cand == 0 and h * w * cand % 128 == 0:
                return cand, b // cand
        return None
    return k, b // k


def cs_plan_pad(shape):
    """srtpu's (k, G, s_pad) packing with dead lanes, or None when
    :func:`cs_plan` takes the shape or nothing fits."""
    if cs_plan(shape) is not None:
        return None
    b, h, w, c = shape
    if c % 16 or h < 2 or w < 2:
        return None
    k = _select_k(b, h, w)
    if b % k:
        return None
    s_pad = -(-(h * w * k + w * k) // 128) * 128
    if s_pad > S_MAX:
        return None
    return k, b // k, s_pad


def route_tiled(lr_shape, n_feats: int = 64) -> bool:
    """srtpu's ``Trainer._route_tiled``: tile an LR batch shape that no
    direct plan takes and that is past the lane budget."""
    b, h, w, _ = lr_shape
    trunk = (b, h, w, n_feats)
    if cs_plan(trunk) is not None or cs_plan_pad(trunk) is not None:
        return False
    return h * w > S_MAX


def _anchors(size: int, tile: int, stride: int) -> list[int]:
    """Tile starts covering [0, size), the last clamped inside the image
    (no padding unless size < tile)."""
    if size <= tile:
        return [0]
    out, y = [], 0
    while True:
        out.append(min(y, size - tile))
        if y + tile >= size:
            break
        y += stride
    return sorted(set(out))


def tiled_predict(forward, lr: np.ndarray, scale: int, tile: int = 128,
                  overlap: int = 32) -> np.ndarray:
    """Super-resolve ``lr`` (HWC float32) in (tile, tile) LR tiles on the
    host. ``forward`` maps a (1, tile, tile, C) numpy tile to its (1,
    tile scale, tile scale, C) SR as numpy; tiles are ``tile - 2
    overlap`` apart."""
    assert tile > 2 * overlap >= 0, (tile, overlap)
    h, w, c = lr.shape
    stride = tile - 2 * overlap
    out = np.zeros((h * scale, w * scale, c), np.float32)
    ys = _anchors(h, tile, stride)
    xs = _anchors(w, tile, stride)
    for yi, y0 in enumerate(ys):
        for xi, x0 in enumerate(xs):
            y1, x1 = min(y0 + tile, h), min(x0 + tile, w)
            src = lr[y0:y1, x0:x1]
            pad_h, pad_w = tile - src.shape[0], tile - src.shape[1]
            if pad_h or pad_w:
                src = np.pad(src, ((0, pad_h), (0, pad_w), (0, 0)),
                             mode='edge')
            sr_tile = np.asarray(forward(src[None]))[0]
            # the deep-context center only, except at image borders
            vy0 = 0 if yi == 0 else overlap
            vx0 = 0 if xi == 0 else overlap
            vy1 = (y1 - y0) if yi == len(ys) - 1 else (y1 - y0) - overlap
            vx1 = (x1 - x0) if xi == len(xs) - 1 else (x1 - x0) - overlap
            out[(y0 + vy0) * scale:(y0 + vy1) * scale,
                (x0 + vx0) * scale:(x0 + vx1) * scale] = \
                sr_tile[vy0 * scale:vy1 * scale, vx0 * scale:vx1 * scale]
    return out


def _edge_pad(x: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """NHWC x edge-padded at the bottom and right to (hp, wp)."""
    _, h, w, _ = x.shape
    rows = torch.arange(hp, device=x.device).clamp_max(h - 1)
    cols = torch.arange(wp, device=x.device).clamp_max(w - 1)
    return x.index_select(1, rows).index_select(2, cols)


def make_tiled_apply(scale: int, tile_h: int = 64, tile_w: int = 64,
                     overlap: int = 8, batch: int = 16):
    """``tiled(forward_b, lr) -> sr`` on ``lr``'s device. ``forward_b``
    maps (n, tile_h, tile_w, C) to (n, tile_h scale, tile_w scale, C) for
    n at most ``batch``; tiles are gathered across the whole (B, H, W, C)
    input so the batches stay full. As srtpu's: a batch holds min(batch,
    tiles) tiles, and the last batch is filled by repeating the last
    anchor, whose writes repeat its own."""
    assert tile_h > 2 * overlap >= 0 and tile_w > 2 * overlap >= 0

    def tiled(forward_b, lr: torch.Tensor) -> torch.Tensor:
        b, h, w, c = lr.shape
        hp, wp = max(h, tile_h), max(w, tile_w)
        if (hp, wp) != (h, w):
            lr = _edge_pad(lr, hp, wp)
        ys = _anchors(hp, tile_h, tile_h - 2 * overlap)
        xs = _anchors(wp, tile_w, tile_w - 2 * overlap)
        anchors = [(bi, y, x) for bi in range(b) for y in ys for x in xs]
        n = len(anchors)
        batch_eff = min(batch, n)
        anchors += anchors[-1:] * (-(-n // batch_eff) * batch_eff - n)
        tiles = torch.stack([lr[bi, y:y + tile_h, x:x + tile_w]
                             for bi, y, x in anchors])
        srs = torch.cat([forward_b(tiles[i:i + batch_eff])
                         for i in range(0, len(anchors), batch_eff)])
        ths, tws, ovs = tile_h * scale, tile_w * scale, overlap * scale
        out = torch.zeros((b, hp * scale, wp * scale, c), dtype=srs.dtype,
                          device=srs.device)
        for (bi, y0, x0), sr_t in zip(anchors, srs):
            # srtpu's emission mask is this rectangle: the center, and the
            # border rows / columns of tiles at the image's edges
            r0 = 0 if y0 == 0 else ovs
            r1 = ths if y0 == hp - tile_h else ths - ovs
            c0 = 0 if x0 == 0 else ovs
            c1 = tws if x0 == wp - tile_w else tws - ovs
            out[bi, y0 * scale + r0:y0 * scale + r1,
                x0 * scale + c0:x0 * scale + c1] = sr_t[r0:r1, c0:c1]
        return out[:, :h * scale, :w * scale]

    return tiled
