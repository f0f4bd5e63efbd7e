"""Time K8a (EDSR's True-route block) and K3 (the sub-pixel stage) on the card.

For the srtpu_torch of this checkout, or with ``--tree DIR`` of another
(the parent commit unpacked with ``git archive`` into a git-ignored
directory), at 64 channels, res_scale 1:

- first, the classes of K2's and W's engines and of the kernels sharing
  K2's engine, K5's and K6's (``tree_timing.engine_times``,
  ``epilogue_times``), and K1's, K4's and K7's 16-block trunks each way
  (``trunk_times``), which new epilogues must leave level;
- K8a's skip order: with W2 = 0 conv2's sums are exactly 0, so the
  output is b2 * res_scale + x rounded in the kernel's order; at
  res_scale 0.1, b2 and x are picked so that one fused multiply-add
  (one rounding to f32) and a product rounded before the add (two) give
  other bf16 outputs everywhere, and the count matching each says which
  the kernel computes;
- K8a at the training shape (batch 16, LR 32x32) and the predict shape
  (1 x 128 x 128): one block saving h1 (as a train step runs it) and
  not, and a trunk of 16 blocks forward saving and not (one host call
  on trees with ``resblock_trunk_fwd``, else 16 block calls, as the True
  route ran them), beside cuDNN's calls for the same work (two bf16
  ``F.conv2d``, ReLU and the scaled skip a block: h1 rounded, so a
  reference, not the same function);
- K3 at both shapes: the forward (``upsample_fwd``), beside ``F.conv2d``
  64 -> 256 then ``F.pixel_shuffle``; at the training shape also the dx
  alone (``upsample_dx``, or the parent's launch on its transposed
  weight) and the whole backward with its weight grads
  (``upsample_bwd``), beside ``aten.convolution_backward`` of that conv;

each as device time alone (one CUDA graph of the calls) and host time a
call, with the card's name and power limit. To compare two trees on one
card, run both in one call, in turns (parent, this, this, parent).
Needs a CUDA card::

    python3 tools/k8a_k3_plans.py [--tree DIR]
"""

from __future__ import annotations

import argparse
import importlib

import numpy as np
import torch
import torch.nn.functional as F

from tree_timing import (engine_times, epilogue_times, load_chip_smoke,
                         trunk_times)

ARGS = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ARGS.add_argument('--tree', help="time this checkout's srtpu_torch")
chip_smoke = load_chip_smoke(ARGS.parse_args().tree)
k8a = importlib.import_module('srtpu_torch.ops.resblock')
k3 = importlib.import_module('srtpu_torch.ops.upsample')
layout = importlib.import_module('srtpu_torch.ops.layout')
_build = importlib.import_module('srtpu_torch.ops._build')

SHAPES = {'training': (16, 32, 32), 'predict': (1, 128, 128)}


def show(tag: str, fn, smi: str, calls: int = 10) -> float:
    cs = chip_smoke
    dev = cs.graph_ms(fn, calls, 3)
    host = cs.host_ms(fn)
    print(f'{tag}: device {dev:.4f} ms, host {host:.4f} ms a call  [{smi}]',
          flush=True)
    return dev


def skip_operands(scale: float) -> tuple[np.ndarray, np.ndarray]:
    """Per channel c a power of two X, x's value at every pixel, and a b2
    whose product with ``scale`` (exact in float64) lies less than half an
    f32 step above X (2^-8 + 2^-24): there X + b2 scale crosses the f32
    tie between X (1 + 2^-8) and X (1 + 2^-8 + 2^-23). One fused rounding
    takes the exact sum up, then to bf16 X (1 + 2^-7); the product
    rounded first lands on the tie itself, which rounds to even, X (1 +
    2^-8), a bf16 tie that rounds to X. Signs alternate."""
    s = float(np.float32(scale))
    xs, bs = [], []
    for c in range(64):
        sign = -1.0 if c % 2 else 1.0
        big = 2.0 ** (c % 7 - 3)
        edge = big * (2.0 ** -8 + 2.0 ** -24)
        t = np.float32(edge / s)
        found = None
        for _ in range(64):
            p = float(t) * s                     # exact in float64
            if 0 < p - edge < big * 2.0 ** -32:
                found = t
                break
            t = np.nextafter(t, np.float32(np.inf) if p <= edge else
                             np.float32(0), dtype=np.float32)
        assert found is not None, c
        xs.append(sign * big)
        bs.append(sign * float(found))
    return np.array(xs, np.float32), np.array(bs, np.float32)


def skip_order(device, smi: str) -> None:
    cs = chip_smoke
    scale = 0.1
    xv, b2 = skip_operands(scale)
    bsz, h, w = SHAPES['training']
    gen = torch.Generator().manual_seed(2031)
    x = torch.from_numpy(xv).to(device, torch.bfloat16).expand(
        bsz, h, w, 64).contiguous()
    w1 = cs._uniform(gen, (3, 3, 64, 64), (9 * 64) ** -0.5, device,
                     torch.bfloat16)
    b1 = cs._uniform(gen, (64,), 0.1, device, torch.float32)
    w2 = torch.zeros((3, 3, 64, 64), dtype=torch.bfloat16, device=device)
    out = k8a.resblock_fused_fwd(x, w1, b1, w2,
                                 torch.from_numpy(b2).to(device), scale)
    s32 = float(np.float32(scale))
    fused = torch.from_numpy((b2.astype(np.float64) * s32 + xv).astype(
        np.float32)).bfloat16().to(device)
    twice = torch.from_numpy((b2 * np.float32(s32)).astype(np.float32)
                             + xv).bfloat16().to(device)
    diff = int((fused != twice).sum()) * bsz * h * w
    print(f'K8a skip order, res_scale {scale}: the two orders differ at '
          f'{diff} of {out.numel()} outputs; the kernel equals the fused '
          f'multiply-add at {int((out == fused).sum())}, the product '
          f'rounded first at {int((out == twice).sum())}  [{smi}]',
          flush=True)


def k8a_times(device, smi: str) -> None:
    cs = chip_smoke
    trunk_op = hasattr(k8a, 'resblock_trunk_fwd')
    print(f'K8a trunk op: {trunk_op}')
    cb = (9 * cs.C) ** -0.5
    bf, f32 = torch.bfloat16, torch.float32
    for name, (bsz, h, w) in SHAPES.items():
        gen = torch.Generator().manual_seed(bsz * 7951 + h)
        x = cs._uniform(gen, (bsz, h, w, cs.C), 1.0, device, bf)
        sp = (cs._uniform(gen, (cs.L, 3, 3, cs.C, cs.C), cb, device, bf),
              cs._uniform(gen, (cs.L, cs.C), cb, device, f32),
              cs._uniform(gen, (cs.L, 3, 3, cs.C, cs.C), cb, device, bf),
              cs._uniform(gen, (cs.L, cs.C), cb, device, f32))
        one = [t[0] for t in sp]
        tag = f'K8a {name} {bsz}x{h}x{w}'
        show(f'{tag} one block (saving h1)', lambda: k8a.resblock_fused_fwd(
            x, *one, 1.0, save_h1=True), smi)
        show(f'{tag} one block (predict)',
             lambda: k8a.resblock_fused_fwd(x, *one, 1.0), smi)
        if trunk_op:
            def fwd(save):
                return k8a.resblock_trunk_fwd(x, *sp, 1.0, save=save)
        else:
            def fwd(save):
                y = x
                for i in range(cs.L):
                    y = k8a.resblock_fused_fwd(y, *(t[i] for t in sp), 1.0,
                                               save_h1=save)
                    y = y[0] if save else y
                return y
        for save in (True, False):
            form = 'saving' if save else 'predict'
            dev = show(f'{tag} trunk of {cs.L} fwd ({form})',
                       lambda: fwd(save), smi, 3)
            print(f'  {dev / cs.L:.5f} ms a block')
        ref = cs.trunk_reference(x, *sp, 1.0, x.expand((cs.L, *x.shape)),
                                 x)[0]
        ref_one = cs.trunk_reference(x, *(t[:1] for t in sp), 1.0, x[None],
                                     x)[0]
        show(f'{tag} cuDNN reference, one block (2 F.conv2d, ReLU, scaled '
             f'skip)', ref_one, smi)
        show(f'{tag} cuDNN reference, {cs.L} blocks', ref, smi, 3)
        del x, sp, one
        torch.cuda.empty_cache()


def k3_times(device, smi: str) -> None:
    cs = chip_smoke
    bf, f32 = torch.bfloat16, torch.float32
    cb = (9 * cs.C) ** -0.5
    has_dx = hasattr(k3, 'upsample_dx')
    print(f'K3 dx alone: {"upsample_dx" if has_dx else "the wrapper launch"}')
    for name, (bsz, h, w) in SHAPES.items():
        gen = torch.Generator().manual_seed(bsz * 7963 + h)
        x = cs._uniform(gen, (bsz, h, w, cs.C), 1.0, device, bf)
        wt = cs._uniform(gen, (3, 3, cs.C, 4 * cs.C), cb, device, bf)
        b = cs._uniform(gen, (4 * cs.C,), cb, device, f32)
        g = cs._uniform(gen, (bsz, 2 * h, 2 * w, cs.C), 1.0, device, bf)
        tag = f'K3 {name} {bsz}x{h}x{w}'
        show(f'{tag} fwd', lambda: k3.upsample_fwd(x, wt, b, 2), smi)
        conv = cs.lib_conv(x, wt, b)
        show(f'{tag} cuDNN reference fwd (F.conv2d + F.pixel_shuffle)',
             lambda: F.pixel_shuffle(conv(), 2), smi)
        if has_dx:
            w_pm = layout.w_pm_hwio(wt, 2).contiguous()
            dx = lambda: k3.upsample_dx(g, w_pm, 2)  # noqa: E731
        else:   # the parent's launch on the transposed phase-major weight
            wtt = layout.w_t(layout.w_pm_hwio(wt, 2)).contiguous()
            out = torch.empty_like(x)

            def dx():
                _build.check(_build.library().srt_upsample_bwd_dx(
                    g.data_ptr(), wtt.data_ptr(), out.data_ptr(), bsz, h, w,
                    cs.C, 2, _build.stream(device)), 'srt_upsample_bwd_dx')
                return out
        show(f'{tag} dx alone', dx, smi)
        show(f'{tag} bwd (dx + weight grads)',
             lambda: k3.upsample_bwd(x, wt, g, 2), smi)
        show(f'{tag} cuDNN reference bwd (convolution_backward)',
             cs.lib_conv_bwd(x, wt, layout.pm_from_fine(g, 2).contiguous()),
             smi)
        del x, g
        torch.cuda.empty_cache()


def main() -> None:
    device, smi = chip_smoke.card()
    print(f'srtpu_torch from {k8a.__file__}')
    # the engines' classes and the other trunks first (timed after a
    # memory-heavy trunk they read 1-3% slow, their code unchanged)
    engine_times(chip_smoke, device, smi)
    epilogue_times(chip_smoke, device, smi)
    trunk_times(chip_smoke, device, smi)
    skip_order(device, smi)
    k8a_times(device, smi)
    k3_times(device, smi)


if __name__ == '__main__':
    main()
