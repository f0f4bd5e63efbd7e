"""What the tools that time two trees of srtpu_torch in turns share
(``tools/k5_plans.py``, ``tools/k6_plans.py``, ``tools/wgrad_plans.py``):
this checkout's chip_smoke.py loaded over another tree's srtpu_torch,
and the device times of the classes of the two wgmma engines, K2's
(``conv_sm90.cuh``) and W's (``wgrad.cu``)."""

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
