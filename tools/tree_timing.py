"""What the tools that time two trees of srtpu_torch in turns share
(``tools/k1_plans.py``, ``tools/k5_plans.py``, ``tools/k6_plans.py``,
``tools/wgrad_plans.py``): this checkout's chip_smoke.py loaded over
another tree's srtpu_torch, the device times of the classes of the two
wgmma engines, K2's (``conv_sm90.cuh``) and W's (``wgrad.cu``), and of
the kernels that run K2's at epilogues of their own, K5's and K6's."""

from __future__ import annotations

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
