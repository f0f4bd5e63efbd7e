"""Time K7 (WDSR-B's block) and K8c, and the engines they run on, on the card.

For the srtpu_torch of this checkout, or with ``--tree DIR`` of another
(the parent commit unpacked with ``git archive`` into a git-ignored
directory), at WDSR-B's width (C 128, e 768, L 102), res_scale 1:

- K7 at the training shape (batch 16, LR 32x32): one block forward,
  backward (with its weight grads; on trees with the trunk op from the
  block input and h2 its forward saved, as the model runs it, else the
  block call, which recomputes them) and forward (saving) + backward;
  a trunk of 16
  blocks each way (one host call on trees with ``wdsr_trunk_fwd``, else
  16 block calls); one block's forward and the 16-block forward at 1 x
  512 x 352 (predict); each as device time alone (one CUDA graph of the
  calls) and host time a call; on trees with the trunk op, each kernel's
  device time in one block's backward (``torch.profiler``);
- K8c at both shapes, one block, the same two times;
- the cuDNN stock block (chip_smoke's ``stock_block``: 1x1, ReLU, 1x1,
  3x3, skip; bf16, benchmark mode), device time forward and forward +
  backward at the training shape;
- K2's 3x3 at the bottleneck padded to 112 (srtpu's Lp) and to 128 (the
  kernels' since this change), forward 112 -> 128 against 128 -> 128 and
  dx 128 -> 112 against 128 -> 128, device time;
- first, the classes of K2 and W and of the kernels sharing K2's
  engine, K5's and K6's (``tree_timing.engine_times``,
  ``epilogue_times``) and K1's 16-block trunk each way, which a change to
  the engines must leave level.

The weights a tree's wrappers take: Lp 112 on trees without
``kernel_lp``, else the kernels' Lp (128; the model pads once a trunk
call). To compare two trees on one card, run both in one call, in turns
(parent, this, this, parent). Needs a CUDA card::

    python3 tools/k7_plans.py [--tree DIR]
"""

from __future__ import annotations

import argparse
import importlib

import torch
import torch.nn.functional as F

from tree_timing import engine_times, epilogue_times, load_chip_smoke

ARGS = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ARGS.add_argument('--tree', help="time this checkout's srtpu_torch")
chip_smoke = load_chip_smoke(ARGS.parse_args().tree)
k7 = importlib.import_module('srtpu_torch.ops.wdsr')
k8c = importlib.import_module('srtpu_torch.ops.wdsr_block')
conv = importlib.import_module('srtpu_torch.ops.conv')

L_BLOCKS = 16
SHAPES = {'training': (16, 32, 32), 'predict': (1, 512, 352)}


def operands(gen, device, bsz, h, w, lp, n=None):
    """x, the block's weights (stacked n deep when n) at Lp ``lp`` (zero
    padding past L) and a cotangent, srtpu's init bounds."""
    cs = chip_smoke
    bf, f32 = torch.bfloat16, torch.float32
    c, e, lv = cs.WDSR_C, cs.WDSR_E, cs.WDSR_LV
    lead = () if n is None else (n,)

    def u(shape, bound, dt=bf):
        return cs._uniform(gen, (*lead, *shape), bound, device, dt)

    def pad(t, dim):
        return F.pad(t, (0, 0) * (t.dim() - 1 - dim) + (0, lp - lv))
    ax = len(lead)    # the L axis of w2, b2, w3: ax + 1, ax, ax + 2
    wts = (u((c, e), c ** -0.5), u((e,), c ** -0.5, f32),
           pad(u((e, lv), e ** -0.5), ax + 1),
           pad(u((lv,), e ** -0.5, f32), ax),
           pad(u((3, 3, lv, c), (9 * lv) ** -0.5), ax + 2).contiguous(),
           u((c,), (9 * lv) ** -0.5, f32))
    return (cs._uniform(gen, (bsz, h, w, c), 1.0, device, bf), *wts,
            cs._uniform(gen, (bsz, h, w, c), 1.0, device, bf))


def show(tag: str, fn, smi: str, calls: int = 5, per: int = 1) -> float:
    cs = chip_smoke
    dev = cs.graph_ms(fn, calls, 3)
    host = cs.host_ms(fn)
    extra = f' ({dev / per:.5f} a block)' if per > 1 else ''
    print(f'{tag}: device {dev:.4f} ms{extra}, host {host:.4f} ms a call  '
          f'[{smi}]', flush=True)
    return dev


def k7_times(device, smi: str) -> None:
    cs = chip_smoke
    lp = k7.kernel_lp(cs.WDSR_C) if hasattr(k7, 'kernel_lp') else cs.WDSR_LP
    trunk = hasattr(k7, 'wdsr_trunk_fwd')
    print(f'K7 at Lp {lp}; trunk op: {trunk}')
    for name, (bsz, h, w) in SHAPES.items():
        gen = torch.Generator().manual_seed(bsz * 7907 + h)
        x, *prm, g = operands(gen, device, bsz, h, w, lp)
        tag = f'K7 {name} {bsz}x{h}x{w}'
        show(f'{tag} fwd (one block)', lambda: k7.wdsr_fwd(x, *prm, 1.0),
             smi, 10)
        if name == 'training':
            if trunk:       # a trunk of one, as WDSRTrunkFn runs it
                one = [t[None] for t in prm]
                _, xs1, h2s1 = k7.wdsr_trunk_fwd(x, *one, 1.0, save=True)
                bwd1 = lambda: k7.wdsr_trunk_bwd(  # noqa: E731
                    xs1, h2s1, g, *one[:5], 1.0)
                both = lambda: (  # noqa: E731
                    k7.wdsr_trunk_fwd(x, *one, 1.0, save=True), bwd1())
            else:
                bwd1 = lambda: k7.wdsr_bwd(x, g, *prm[:5], 1.0)  # noqa
                both = lambda: (  # noqa: E731
                    k7.wdsr_fwd(x, *prm, 1.0), bwd1())
            show(f'{tag} bwd (one block, with dW1-3)', bwd1, smi, 10)
            show(f'{tag} fwd + bwd (one block)', both, smi, 10)
            if trunk:
                profile_bwd(bwd1, smi)
        gen = torch.Generator().manual_seed(bsz * 7919 + h)
        x, *sp, g = operands(gen, device, bsz, h, w, lp, L_BLOCKS)
        if trunk:
            fwd = lambda: k7.wdsr_trunk_fwd(x, *sp, 1.0)  # noqa: E731
            _, xs, h2s = k7.wdsr_trunk_fwd(x, *sp, 1.0, save=True)
            bwd = lambda: k7.wdsr_trunk_bwd(xs, h2s, g, *sp[:5], 1.0)  # noqa
        else:
            def fwd():
                y = x
                for i in range(L_BLOCKS):
                    y = k7.wdsr_fwd(y, *(t[i] for t in sp), 1.0)
                return y
            ys = [x]
            for i in range(L_BLOCKS - 1):
                ys.append(k7.wdsr_fwd(ys[-1], *(t[i] for t in sp), 1.0))

            def bwd():
                gg = g
                for i in reversed(range(L_BLOCKS)):
                    gg = k7.wdsr_bwd(ys[i], gg, *(t[i] for t in sp[:5]),
                                     1.0)[0]
                return gg
        show(f'{tag} trunk of {L_BLOCKS} fwd', fwd, smi, 3, L_BLOCKS)
        if name == 'training':
            show(f'{tag} trunk of {L_BLOCKS} bwd', bwd, smi, 3, L_BLOCKS)
        del x, sp, g
        torch.cuda.empty_cache()


def profile_bwd(bwd1, smi: str) -> None:
    """Each kernel's device time in one K7 block's backward."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        bwd1()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            bwd1()
        torch.cuda.synchronize()
    rows = chip_smoke._device_us(prof)
    for key, us in sorted(rows.items(), key=lambda kv: -kv[1]):
        print(f'  K7 bwd part {key[:90]}: device {us / 5 / 1e3:.4f} ms a '
              f'call  [{smi}]', flush=True)


def k8c_times(device, smi: str) -> None:
    cs = chip_smoke
    for name, (bsz, h, w) in SHAPES.items():
        gen = torch.Generator().manual_seed(bsz * 7927 + h)
        x, *prm, _ = operands(gen, device, bsz, h, w, cs.WDSR_LV)
        show(f'K8c {name} {bsz}x{h}x{w} (one block)',
             lambda: k8c.wdsr_block_fused_fwd(x, *prm, 1.0), smi, 10)
        del x, prm
        torch.cuda.empty_cache()


def stock_times(device, smi: str) -> None:
    cs = chip_smoke
    bsz, h, w = SHAPES['training']
    gen = torch.Generator().manual_seed(2027)
    x, *prm, g = operands(gen, device, bsz, h, w, cs.WDSR_LV)
    sw = cs.stock_operands(x, *prm)
    gc = g.permute(0, 3, 1, 2)
    mode = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    with torch.no_grad():
        fwd = cs.graph_ms(lambda: cs.stock_block(*sw), 10, 3)
    both = cs.graph_ms(lambda: torch.autograd.grad(cs.stock_block(*sw), sw,
                                                   gc), 10, 3)
    torch.backends.cudnn.benchmark = mode
    print(f'cuDNN stock block (1x1, ReLU, 1x1, 3x3, skip; bf16, benchmark '
          f'mode) {bsz}x{h}x{w}: device fwd {fwd:.4f} ms, fwd + bwd '
          f'{both:.4f} ms  [{smi}]', flush=True)


def lp_times(device, smi: str) -> None:
    """K2's 3x3 at the bottleneck's two paddings, training shape."""
    cs = chip_smoke
    bsz, h, w = SHAPES['training']
    gen = torch.Generator().manual_seed(2028)
    c = cs.WDSR_C
    for lp in (112, 128):
        x = cs._uniform(gen, (bsz, h, w, lp), 1.0, device, torch.bfloat16)
        wt = cs._uniform(gen, (3, 3, lp, c), (9 * lp) ** -0.5, device,
                         torch.bfloat16)
        b = cs._uniform(gen, (c,), 0.1, device, torch.float32)
        gg = cs._uniform(gen, (bsz, h, w, c), 1.0, device, torch.bfloat16)
        fwd = cs.graph_ms(lambda: conv.conv3x3_fwd(x, wt, b))
        dx = cs.graph_ms(lambda: conv.conv3x3_dx(gg, wt))
        print(f'K2 3x3 {lp}->{c} {bsz}x{h}x{w}: device fwd {fwd:.4f} ms, dx '
              f'{c}->{lp} {dx:.4f} ms  [{smi}]', flush=True)


def k1_times(device, smi: str) -> None:
    """K1's 16-block trunk at the training shape, res_scale 1 (K2's engine
    at K1's epilogues, whose code K7's own epilogues sit beside): the
    forward saving and the backward, device time."""
    cs = chip_smoke
    trunk = importlib.import_module('srtpu_torch.ops.trunk')
    bsz, lr = cs.TRAIN_BATCH, cs.TRAIN_PATCH // cs.SCALE
    bf, f32 = torch.bfloat16, torch.float32
    cb = (9 * cs.C) ** -0.5
    gen = torch.Generator().manual_seed(2029)
    args = (cs._uniform(gen, (bsz, lr, lr, cs.C), 1.0, device, bf),
            cs._uniform(gen, (cs.L, 3, 3, cs.C, cs.C), cb, device, bf),
            cs._uniform(gen, (cs.L, cs.C), cb, device, f32),
            cs._uniform(gen, (cs.L, 3, 3, cs.C, cs.C), cb, device, bf),
            cs._uniform(gen, (cs.L, cs.C), cb, device, f32), 1.0)
    g = cs._uniform(gen, (bsz, lr, lr, cs.C), 1.0, device, bf)
    _, xs, h1s = trunk.trunk_fwd(*args, save=True)
    fwd = cs.graph_ms(lambda: trunk.trunk_fwd(*args, save=True), 5, 3)
    bwd = cs.graph_ms(lambda: trunk.trunk_bwd(xs, h1s, g, args[1], args[3],
                                              1.0), 5, 3)
    print(f'K1 trunk of {cs.L} {bsz}x{lr}x{lr}: device fwd (saving) '
          f'{fwd:.4f} ms, bwd {bwd:.4f} ms  [{smi}]', flush=True)


def main() -> None:
    device, smi = chip_smoke.card()
    print(f'srtpu_torch from {k7.__file__}')
    # the engines' classes first: timed after K7's (whose trunk holds
    # more device memory on trees with the trunk op) they read 1-3% slow
    # on such trees, their own code unchanged
    engine_times(chip_smoke, device, smi)
    epilogue_times(chip_smoke, device, smi)
    k1_times(device, smi)
    k7_times(device, smi)
    k8c_times(device, smi)
    stock_times(device, smi)
    lp_times(device, smi)


if __name__ == '__main__':
    main()
