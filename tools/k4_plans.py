"""Time K4 / K4r (SRResNet's and SRGAN's BN block) and K8b on the card.

For the srtpu_torch of this checkout, or with ``--tree DIR`` of another
(the parent commit unpacked with ``git archive`` into a git-ignored
directory), at the training shape (batch 16, LR 32x32, 64 channels):

- first, the classes of K2's and W's engines and of the kernels sharing
  K2's engine, K5's and K6's (``tree_timing.engine_times``,
  ``epilogue_times``), K1's 16-block trunk and K7's (WDSR-B at 128
  features) 16-block trunk each way, which new epilogues must leave
  level;
- each K4 function (F1, F2, F3, B1, B2, B3; chip_smoke's ``bn_case``)
  with SAME boundaries and K4r's four (F1, F2, B2, B3) with REFLECT;
- a 16-block BN trunk and its close, each way, both boundary modes: one
  host call each way on trees with the trunk op (``bn_trunk_fwd``), else
  the per-function wrappers block after block as the model ran them;
- K8b at the training shape, 1 x 128 x 128 and 1 x 512 x 352; on trees
  with ``ca_layer.block_pixels``, also at set block sizes
  (``srt_ca_layer_fwd`` called directly) beside the one the wrapper
  picks;

each as device time alone (one CUDA graph of the calls) and host time a
call, with the card's name and power limit. To compare two trees on one
card, run both in one call, in turns (parent, this, this, parent).
Needs a CUDA card::

    python3 tools/k4_plans.py [--tree DIR]
"""

from __future__ import annotations

import argparse
import importlib

import torch

from tree_timing import (engine_times, epilogue_times, load_chip_smoke,
                         trunk_times as k1_k7_times)

ARGS = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ARGS.add_argument('--tree', help="time this checkout's srtpu_torch")
chip_smoke = load_chip_smoke(ARGS.parse_args().tree)
bn = importlib.import_module('srtpu_torch.ops.bn_block')
k8b = importlib.import_module('srtpu_torch.ops.ca_layer')

K8B_SHAPES = ((16, 32, 32), (1, 128, 128), (1, 512, 352))


def show(tag: str, fn, smi: str, calls: int = 10) -> float:
    cs = chip_smoke
    try:
        dev, how = cs.graph_ms(fn, calls, 3), 'device'
    except RuntimeError as err:  # calls that a CUDA graph cannot capture
        print(f'{tag}: no CUDA graph ({str(err)[:120]}); CUDA events')
        torch.cuda.synchronize()
        dev, how = cs.median_ms(fn, calls, 3), 'events'
    host = cs.host_ms(fn)
    print(f'{tag}: {how} {dev:.4f} ms, host {host:.4f} ms a call  [{smi}]',
          flush=True)
    return dev


def k4_fn_times(device, smi: str) -> None:
    """Each K4 function (SAME) and K4r's four (REFLECT) on chip_smoke's
    bn_case inputs at the training shape."""
    cs = chip_smoke
    bsz, lr = cs.TRAIN_BATCH, cs.TRAIN_PATCH // cs.SCALE
    for rf in (False, True):
        gen = torch.Generator().manual_seed(bsz * 7907 + lr * 103 + rf)
        case = cs.bn_case(gen, device, bsz, lr, lr, reflect=rf)
        for kid, fn in cs.K4_FNS.items():
            if rf and kid not in cs.K4R:
                continue
            args = case[kid][0]
            show(f'{"K4r" if rf else "K4"} {kid} {bsz}x{lr}x{lr}',
                 lambda: fn(*args), smi)


def calls_fwd(k, x, w1s, b1s, g1s, be1s, alphas, w2s, b2s, g2s, be2s, wc,
              bc, gc, bec, rf):
    """A trunk forward as the per-function wrappers of table ``k``, block
    after block (the model's route on trees without the trunk op)."""
    acts, ys, sts, u = [x], [], [], x
    for i in range(w1s.shape[0]):
        y1, st1 = k['f1'](u, w1s[i], b1s[i], g1s[i], be1s[i], rf)
        y2, h1, st2 = k['f2'](y1, st1, alphas[i].reshape(1), w2s[i], b2s[i],
                              g2s[i], be2s[i], rf)
        u = k['f3'](y2, st2, u)
        acts += [h1, u]
        ys += [y1, y2]
        sts += [st1, st2]
    yc, stc = k['f1'](u, wc, bc, gc, bec, rf)
    return k['f3'](yc, stc, x), acts, ys + [yc], sts + [stc]


def calls_bwd(k, acts, ys, sts, g, w1s, w2s, wc, g1s, g2s, gc, alphas, rf):
    """The matching backward, the close first, each conv's weight grads
    as the model's per-block autograd ran them."""
    n = w1s.shape[0]
    c = 2 * n
    sums = k['b1'](g, ys[c], sts[c])
    gcur, dy, _ = k['b3'](g, ys[c], sts[c], gc, sums, wc, None, rf)
    k['wgrad'](acts[c], dy, reflect=rf)
    for i in reversed(range(n)):
        s2 = k['b1'](gcur, ys[2 * i + 1], sts[2 * i + 1])
        dz, dy2, _, _, s1 = k['b2'](gcur, ys[2 * i + 1], sts[2 * i + 1],
                                    g2s[i], s2, ys[2 * i], sts[2 * i],
                                    alphas[i].reshape(1), w2s[i], rf)
        gcur, dy1, _ = k['b3'](dz, ys[2 * i], sts[2 * i], g1s[i], s1,
                               w1s[i], gcur, rf)
        k['wgrad'](acts[2 * i + 1], dy2, reflect=rf)
        k['wgrad'](acts[2 * i], dy1, reflect=rf)
    return gcur + g


def trunk_times(device, smi: str) -> None:
    """A 16-block BN trunk + close each way, SAME and REFLECT."""
    cs = chip_smoke
    bsz, lr = cs.TRAIN_BATCH, cs.TRAIN_PATCH // cs.SCALE
    op = hasattr(bn, 'bn_trunk_fwd')
    print(f'K4 trunk op: {op}')
    for rf in (False, True):
        trunk = cs.create_model(
            'SRResNet', scale_factor=cs.SCALE, n_feats=cs.C,
            n_resblocks=cs.L, dtype=torch.bfloat16, device=device,
            generator=torch.Generator().manual_seed(7)).trunk
        gen = torch.Generator().manual_seed(8)
        x = cs._uniform(gen, (bsz, lr, lr, cs.C), 1.0, device,
                        torch.bfloat16)
        g = cs._uniform(gen, (bsz, lr, lr, cs.C), 1.0, device,
                        torch.bfloat16)
        m = trunk
        prm = [m.w1, m.b1, m.bn1_scale, m.bn1_bias, m.alpha, m.w2, m.b2,
               m.bn2_scale, m.bn2_bias, m.close_w, m.close_b,
               m.close_bn_scale, m.close_bn_bias]
        a = [t.detach().to(torch.bfloat16 if t.dim() >= 4
                           else torch.float32).contiguous() for t in prm]
        if op:
            fwd = lambda: bn.bn_trunk_fwd(x, *a, reflect=rf)  # noqa: E731
            _, acts, ys, sts = fwd()
            bargs = (acts, ys, sts, g, a[0], a[5], a[9], a[2], a[7], a[11],
                     a[4])
            bwd = lambda: bn.bn_trunk_bwd(*bargs, reflect=rf)  # noqa: E731
        else:
            fwd = lambda: calls_fwd(bn.KERNELS, x, *a, rf)  # noqa: E731
            _, acts, ys, sts = fwd()
            bargs = (acts, ys, sts, g, a[0], a[5], a[9], a[2], a[7], a[11],
                     a[4])
            bwd = lambda: calls_bwd(bn.KERNELS, *bargs, rf)  # noqa: E731
        tag = (f'{"K4r" if rf else "K4"} trunk of {cs.L} + close '
               f'{bsz}x{lr}x{lr}')
        show(f'{tag} fwd', fwd, smi, 3)
        show(f'{tag} bwd (with the weight grads)', bwd, smi, 3)
        del acts, ys, sts, bargs
        torch.cuda.empty_cache()


def k8b_sizes(args, smi: str, tag: str, kpixes) -> None:
    """K8b on ``args`` at each block size of ``kpixes`` (pixels a block),
    checked against the plain version."""
    from srtpu_torch.ops import _build
    x, w1, b1, w2, b2 = args
    bsz, h, w, c = x.shape
    dev = x.device
    ref = k8b.ca_layer_plain(*args).float()

    def run(kpix, scratch):
        out = torch.empty_like(x)
        _build.check(_build.library().srt_ca_layer_fwd(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), scratch.data_ptr(), out.data_ptr(), bsz, h * w,
            c, w1.shape[-1], kpix, _build.stream(dev)), 'srt_ca_layer_fwd')
        return out
    for kpix in kpixes:
        scratch = torch.empty((bsz * -(-h * w // kpix) * c,), device=dev)
        name = f'{kpix} pixels a block, {-(-h * w // kpix)} blocks an image'
        err = (run(kpix, scratch).float() - ref).abs().max().item()
        chip_smoke.need(err <= 2.0 ** -7 * ref.abs().max().item(),
                        f'K8b {tag} {name}: {err}')
        dev_ms = chip_smoke.graph_ms(lambda: run(kpix, scratch), 10, 3)
        print(f'{tag} at {name}: device {dev_ms:.5f} ms  [{smi}]',
              flush=True)


def k8b_times(device, smi: str) -> None:
    cs = chip_smoke
    sizes = {(16, 32, 32): (64, 128, 256), (1, 128, 128): (64, 128, 256),
             (1, 512, 352): (352, 704, 1408)}
    new = hasattr(k8b, 'block_pixels')
    for bsz, h, w in K8B_SHAPES:
        gen = torch.Generator().manual_seed(bsz * 7919 + h * 127 + w)
        fn, _, args, _, _ = cs.k8_cases(gen, device, bsz, h, w)['K8b']
        form = (f'{k8b.block_pixels(h, w)} pixels a block' if new else
                'the tree\'s own form')
        tag = f'K8b {bsz}x{h}x{w}x{cs.C}'
        show(f'{tag} ({form})', lambda: fn(*args), smi)
        if new:
            k8b_sizes(args, smi, tag, sizes[bsz, h, w])
        del args
        torch.cuda.empty_cache()


def main() -> None:
    device, smi = chip_smoke.card()
    print(f'srtpu_torch from {bn.__file__}')
    engine_times(chip_smoke, device, smi)
    epilogue_times(chip_smoke, device, smi)
    k1_k7_times(chip_smoke, device, smi, bn_trunk=False)
    k4_fn_times(device, smi)
    trunk_times(device, smi)
    k8b_times(device, smi)


if __name__ == '__main__':
    main()
