"""What the tools that time two trees of srtpu_torch in turns share
(``tools/k1_plans.py``, ``tools/k5_plans.py``, ``tools/k6_plans.py``,
``tools/wgrad_plans.py`` and the other ``tools/*_plans.py``): this
checkout's chip_smoke.py loaded over another tree's srtpu_torch, the
device times of the classes of the two wgmma engines, K2's
(``conv_sm90.cuh``) and W's (``wgrad.cu``), and of the kernels that run
K2's at epilogues of their own, K5's and K6's, and the trunks of K1,
K4, K7 and K8a."""

from __future__ import annotations

import importlib
import importlib.util
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def load_chip_smoke(tree: str | None):
    """This checkout's chip_smoke.py, importing srtpu_torch from ``tree``
    (a checkout, for example the parent commit unpacked with ``git
    archive`` into a git-ignored directory; None: this one)."""
    sys.path.insert(0, str(Path(tree).resolve() if tree else ROOT))
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  ROOT / 'chip_smoke.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def kernels_ms(cs, fn, calls: int = 10) -> dict:
    """Device ms a call of ``fn`` by kernel name (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {k: us / 1e3 / calls for k, us in cs._device_us(prof).items()}


def engine_times(cs, device, smi: str) -> None:
    """Device times of K2's and W's classes at the training shape: K2's
    forward and dx at phase 2k's shapes, at phase 2f's (DDBPN, the x3
    tails) and at K9c's eight dense layers; W at chip_smoke's W cases
    (phase 2l). ``cs``: chip_smoke from :func:`load_chip_smoke`."""
    from srtpu_torch.ops import conv, wgrad
    bsz, lr = cs.TRAIN_BATCH, cs.TRAIN_PATCH // cs.SCALE
    shapes = ([s for v in cs.K2_TRAIN_FWD.values() for s in v]
              + [(k, ci, co, 1) for ci, co, k in cs.K2G_SHAPES]
              + [(3, cs.RDN_G0 * i, cs.RDN_G0, 1) for i in range(1, 9)])
    total = [0.0, 0.0]
    for k, cin, cout, m in shapes:
        hh = lr * m
        gen = torch.Generator().manual_seed(k * 100003 + cin * 101 + cout)
        x = cs._uniform(gen, (bsz, hh, hh, cin), 1.0, device, torch.bfloat16)
        wt = cs._uniform(gen, (k, k, cin, cout), (k * k * cin) ** -0.5,
                         device, torch.bfloat16)
        b = cs._uniform(gen, (cout,), 0.1, device, torch.float32)
        gg = cs._uniform(gen, (bsz, hh, hh, cout), 1.0, device,
                         torch.bfloat16)
        fwd = cs.graph_ms(lambda: conv.conv3x3_fwd(x, wt, b))
        dx = cs.graph_ms(lambda: conv.conv3x3_dx(gg, wt))
        total[0] += fwd
        total[1] += dx
        print(f'K2 {k}x{k} {cin}->{cout} {bsz}x{hh}x{hh}: device fwd '
              f'{fwd:.4f} ms, dx {dx:.4f} ms  [{smi}]', flush=True)
    print(f'K2 classes summed: device fwd {total[0]:.4f} ms, dx '
          f'{total[1]:.4f} ms  [{smi}]')
    w_total = 0.0
    for label, k, cin, cout, r, rf, gs, jobs, x, g in cs.w_cases(
            device, bsz, lr, lr):
        ms = cs.graph_ms(lambda: wgrad.conv_wgrad(x, g, gs, r, k, rf))
        w_total += ms
        print(f'W {label}: device {ms:.4f} ms  [{smi}]', flush=True)
    print(f'W classes summed: device {w_total:.4f} ms  [{smi}]')


def epilogue_times(cs, device, smi: str) -> None:
    """Device times at the training shape of the kernels that run K2's
    engine at epilogues of their own: K5 (one RCAB and a 16-RCAB group,
    forward saving and backward) and K6 (the 16-block forward saving, one
    block's chain and its pair weight grads)."""
    from srtpu_torch.ops import rcab, rdn
    bsz, lr = cs.TRAIN_BATCH, cs.TRAIN_PATCH // cs.SCALE
    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(15)
    prm = cs.rcab_params(gen, device)
    x = cs._uniform(gen, (bsz, lr, lr, cs.C), 1.0, device, bf)
    g = cs._uniform(gen, (bsz, lr, lr, cs.C), 1.0, device, bf)
    _, h1, r2 = rcab.rcab_fwd(x, *prm, save=True)
    gprm = (*cs.rcab_params(gen, device, (cs.RCABS,)),
            *cs.rcab_params(gen, device)[:2])
    _, xs, h1s, r2s = rcab.resgroup_fwd(x, *gprm, save=True)
    gargs = (xs, h1s, r2s, g, gprm[0], gprm[2], *gprm[4:8], gprm[8])
    fns = {'K5 RCAB fwd (saving)': lambda: rcab.rcab_fwd(x, *prm, save=True),
           'K5 RCAB bwd': lambda: rcab.rcab_bwd(x, h1, r2, g, prm[0], prm[2],
                                                *prm[4:]),
           f'K5 group of {cs.RCABS} fwd (saving)':
               lambda: rcab.resgroup_fwd(x, *gprm, save=True),
           f'K5 group of {cs.RCABS} bwd': lambda: rcab.resgroup_bwd(*gargs)}
    args = cs.rdn_case(gen, device, bsz, lr, lr)
    _, bufs = rdn.rdn_fwd(*args, save=True)
    gr = cs._uniform(gen, (bsz, lr, lr, cs.RDN_G0), 1.0, device, bf)
    ct = cs._uniform(gen, (bsz, lr, lr, cs.RDN_D * cs.RDN_G0), 1.0, device,
                     bf)
    l = cs.RDN_D - 1
    bargs = (bufs, l, gr, ct, cs.w_t(args[1]).contiguous(),
             args[3].transpose(1, 2).contiguous())
    dout = rdn.rdb_bwd_chain(*bargs)[1]
    fns.update({
        'K6 fwd (16 blocks, saving)': lambda: rdn.rdn_fwd(*args, save=True),
        'K6 chain (one block)': lambda: rdn.rdb_bwd_chain(*bargs),
        'K6 pair weight grads (one block)':
            lambda: rdn.rdb_bwd_dw(bufs, l, dout)})
    for name, fn in fns.items():
        print(f'{name} {bsz}x{lr}x{lr}: device {cs.graph_ms(fn, 5, 3):.4f} '
              f'ms  [{smi}]', flush=True)


def trunk_times(cs, device, smi: str, bn_trunk: bool = True) -> None:
    """Device times at the training shape of the trunks that run K2's
    engine at epilogues of their own, res_scale 1: K1's and K7's (WDSR-B
    at 128 features) 16 blocks, the forward saving and the backward;
    K8a's 16-block forward saving (the trunk op, on trees that have it);
    with ``bn_trunk``, K4's trunk op (16 BN blocks and the close, SAME)
    each way on trees that have it (``bn_trunk_fwd``)."""
    trunk = importlib.import_module('srtpu_torch.ops.trunk')
    k7 = importlib.import_module('srtpu_torch.ops.wdsr')
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
    k8a = importlib.import_module('srtpu_torch.ops.resblock')
    if hasattr(k8a, 'resblock_trunk_fwd'):
        fwd = cs.graph_ms(lambda: k8a.resblock_trunk_fwd(*args, save=True),
                          5, 3)
        print(f'K8a trunk of {cs.L} {bsz}x{lr}x{lr}: device fwd (saving) '
              f'{fwd:.4f} ms  [{smi}]', flush=True)
    c, e, lv = cs.WDSR_C, cs.WDSR_E, cs.WDSR_LV
    lp = k7.kernel_lp(c) if hasattr(k7, 'kernel_lp') else cs.WDSR_LP
    gen = torch.Generator().manual_seed(2030)

    def u(shape, bound, dt=bf):
        return cs._uniform(gen, (cs.L, *shape), bound, device, dt)
    x = cs._uniform(gen, (bsz, lr, lr, c), 1.0, device, bf)
    pad = torch.nn.functional.pad
    wts = (u((c, e), c ** -0.5), u((e,), c ** -0.5, f32),
           pad(u((e, lv), e ** -0.5), (0, lp - lv)),
           pad(u((lv,), e ** -0.5, f32), (0, lp - lv)),
           pad(u((3, 3, lv, c), (9 * lv) ** -0.5),
               (0, 0, 0, lp - lv)).contiguous(),
           u((c,), (9 * lv) ** -0.5, f32))
    gw = cs._uniform(gen, (bsz, lr, lr, c), 1.0, device, bf)
    _, xs7, h2s = k7.wdsr_trunk_fwd(x, *wts, 1.0, save=True)
    fwd = cs.graph_ms(lambda: k7.wdsr_trunk_fwd(x, *wts, 1.0, save=True),
                      3, 3)
    bwd = cs.graph_ms(lambda: k7.wdsr_trunk_bwd(xs7, h2s, gw, *wts[:5], 1.0),
                      3, 3)
    print(f'K7 trunk of {cs.L} {bsz}x{lr}x{lr} (C {c}): device fwd (saving) '
          f'{fwd:.4f} ms, bwd {bwd:.4f} ms  [{smi}]', flush=True)
    bn = importlib.import_module('srtpu_torch.ops.bn_block')
    if not bn_trunk or not hasattr(bn, 'bn_trunk_fwd'):
        return
    m = cs.create_model('SRResNet', scale_factor=cs.SCALE, n_feats=cs.C,
                        n_resblocks=cs.L, dtype=bf, device=device,
                        generator=torch.Generator().manual_seed(7)).trunk
    a = [t.detach().to(bf if t.dim() >= 4 else f32).contiguous() for t in (
        m.w1, m.b1, m.bn1_scale, m.bn1_bias, m.alpha, m.w2, m.b2,
        m.bn2_scale, m.bn2_bias, m.close_w, m.close_b, m.close_bn_scale,
        m.close_bn_bias)]
    gen = torch.Generator().manual_seed(8)
    x = cs._uniform(gen, (bsz, lr, lr, cs.C), 1.0, device, bf)
    g = cs._uniform(gen, (bsz, lr, lr, cs.C), 1.0, device, bf)
    _, acts, ys, sts = bn.bn_trunk_fwd(x, *a)
    fwd = cs.graph_ms(lambda: bn.bn_trunk_fwd(x, *a), 3, 3)
    bwd = cs.graph_ms(lambda: bn.bn_trunk_bwd(
        acts, ys, sts, g, a[0], a[5], a[9], a[2], a[7], a[11], a[4]), 3, 3)
    print(f'K4 trunk of {cs.L} + close {bsz}x{lr}x{lr}: device fwd '
          f'{fwd:.4f} ms, bwd {bwd:.4f} ms  [{smi}]', flush=True)
