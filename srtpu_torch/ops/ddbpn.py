"""DDBPN's back-projection convs as 3x3 coarse convs over phase-major
channels: the weight builders and masks of ``srtpu/ops/ddbpn_cs.py``, in
the port's HWIO arrangement.

DDBPN's projections (reference models/ddbpn.py:10-24) are stride-r convs
and transposed convs with kernel k = 6, 8, 12 for r = 2, 4, 8 and padding
2. Both lower to a plain 3x3 SAME conv at LR resolution:

* ConvTranspose (up, LR -> HR): fine row f = r*y + a reads coarse row
  y + dy through kernel index q = a + p - r*dy, live when 0 <= q < k. The
  whole convT is one 3x3 conv with phase-major outputs, channel
  ``(a*r + b)*C' + c'`` (:func:`w_up_pm`).
* Strided conv (down, HR -> LR): q = r*dy + a + p, a 3x3 conv reading
  phase-major inputs (:func:`w_down_pd`).

A coarse tap no fine tap lands on is a structural zero. The masks
(:func:`up_mask`, :func:`down_mask`, :func:`final_mask`) mark the live
slots; the model multiplies them into its stored coarse weights on every
forward, before the cast, so a dead slot's gradient is exactly 0 and each
fine weight has exactly one live slot. Boundaries are exact: torch pads
p = 2 < r fine pixels, all of which fall in coarse pixel -1 or H, which
the coarse conv's SAME padding zeroes.

Pure torch: nothing here imports srtpu. The phase-major <-> NHWC moves
are ``layout.pm_from_fine`` and ``layout.pm_to_nhwc``; the final 3x3
fine conv as a coarse conv is ``layout.w_phase_dense``.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from .layout import pm_from_fine, pm_to_nhwc, w_phase_dense

# scale -> (kernel, stride, padding) of the projection convs
_PROJ_PARAMS = {2: (6, 2, 2), 4: (8, 4, 2), 8: (12, 8, 2)}


def up_pm_scatter(r: int, k: int, p: int) -> list[tuple[int, int, int]]:
    """(dy, a, q) for the up (convT) builder: q = a + p - r*dy in [0, k)."""
    return [(dy, a, a + p - r * dy) for a in range(r) for dy in (-1, 0, 1)
            if 0 <= a + p - r * dy < k]


def down_pm_scatter(r: int, k: int, p: int) -> list[tuple[int, int, int]]:
    """(dy, a, q) for the down (strided conv) builder: q = r*dy + a + p in
    [0, k)."""
    return [(dy, a, r * dy + a + p) for a in range(r) for dy in (-1, 0, 1)
            if 0 <= r * dy + a + p < k]


def w_up_pm(w_hwoi: torch.Tensor, r: int) -> torch.Tensor:
    """ConvTranspose2d kernel HWOI (k, k, C', C) -> coarse HWIO (3, 3, C,
    r*r*C') with phase-major outputs ((a*r + b)*C' + c')."""
    k, _, c_out, c_in = w_hwoi.shape
    sc = up_pm_scatter(r, k, _PROJ_PARAMS[r][2])
    wpm = w_hwoi.new_zeros((3, 3, c_in, r * r * c_out))
    for dy, a, qy in sc:
        for dx, b, qx in sc:
            oc = (a * r + b) * c_out
            wpm[dy + 1, dx + 1, :, oc:oc + c_out] = w_hwoi[qy, qx].t()
    return wpm


def w_down_pd(w_hwio: torch.Tensor, r: int) -> torch.Tensor:
    """Strided Conv2d kernel HWIO (k, k, C, C') -> coarse HWIO (3, 3,
    r*r*C, C') reading phase-major inputs ((a*r + b)*C + c)."""
    k, _, c_in, c_out = w_hwio.shape
    sc = down_pm_scatter(r, k, _PROJ_PARAMS[r][2])
    wpd = w_hwio.new_zeros((3, 3, r * r * c_in, c_out))
    for dy, a, qy in sc:
        for dx, b, qx in sc:
            ic = (a * r + b) * c_in
            wpd[dy + 1, dx + 1, ic:ic + c_in, :] = w_hwio[qy, qx]
    return wpd


@lru_cache(maxsize=None)
def up_mask(r: int, c_in: int, c_out: int) -> torch.Tensor:
    """0/1 mask of the live up-conv weights, HWIO (3, 3, C, r*r*C')."""
    k = _PROJ_PARAMS[r][0]
    return w_up_pm(torch.ones((k, k, c_out, c_in)), r)


@lru_cache(maxsize=None)
def down_mask(r: int, c_in: int, c_out: int) -> torch.Tensor:
    """0/1 mask of the live down-conv weights, HWIO (3, 3, r*r*C, C')."""
    k = _PROJ_PARAMS[r][0]
    return w_down_pd(torch.ones((k, k, c_in, c_out)), r)


@lru_cache(maxsize=None)
def final_mask(r: int, c_in: int, ch: int) -> torch.Tensor:
    """0/1 mask of the live output-conv weights (the fine 3x3 conv as a
    phase-dense coarse conv), HWIO (3, 3, r*r*C, CO)."""
    return w_phase_dense(torch.ones((3, 3, c_in, ch)), r)


def nhwc_to_pm(x: torch.Tensor, r: int) -> torch.Tensor:
    """Fine NHWC (B, r*h, r*w, C) -> coarse NHWC with phase-major channels
    (B, h, w, r*r*C)."""
    return pm_from_fine(x, r)


def pm_to_nhwc_fine(x: torch.Tensor, r: int) -> torch.Tensor:
    """Inverse of :func:`nhwc_to_pm`."""
    return pm_to_nhwc(x, r, x.shape[-1] // (r * r))
