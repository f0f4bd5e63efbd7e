"""K1's launch plans cover what EDSR launches, and K1's gs rounds as the
plain backward does.

K1 (``ops.trunk``: ``trunk_fwd`` and ``trunk_bwd``, one host call per
trunk each way) runs each of its convs on K2's engine
(``csrc/conv_sm90.cuh``): conv1 K2's own instance, conv2 at K1's
epilogue, the dx chain's two transposed convs at K5's, and where
res_scale is not 1 a pass making gs = bf16(res_scale * g) before each
block; ``fwd_plan`` and ``chain_plan`` are its
launches in plain Python, as ``csrc/trunk.cu`` makes them. Here, on the
CPU (where the wrappers run their plain versions):

- EDSR-baseline (64 features, 16 resblocks) on a tiny image, in eval
  mode and in train mode (forward and backward), at res_scale 1.0 and
  0.1, and ``resblock_cs`` (K1 at L = 1), record every K1 call; each
  call's plan must be among those of the K1 calls chip_smoke.py's phases
  hold on the card (``chip_smoke.k1_held``).
- Each plan follows the engine's rules: every conv a 3x3 64 -> 64 on
  K2's plan for that class (one N tile of 64); conv1 K2's own instance
  (EPI 0) with ReLU's bias, conv2 K1's epilogue (EPI 6) at the trunk's
  res_scale; the chain transposed at K5's EPI 5; a gs step (a block's)
  only when res_scale is not 1; none of K6's instances (EPI 1-3) or
  K5's forward one (4).
- An f32 emulation of the kernel's gs (the f32 product of g and the f32
  res_scale, rounded to bf16 to nearest even, as the pass computes it;
  at res_scale 1, g itself)
  equals the gs ``trunk_bwd_plain`` computes, bit for bit, for every
  block of a chain and for every finite bf16 value, at res_scale 1.0,
  0.8 and 0.1.

One test per case, so each counts.
"""

import importlib

import numpy as np
import pytest
import torch

import chip_smoke
from srtpu_torch.models import create_model
from srtpu_torch.ops.rdn import engine_bn

k1 = importlib.import_module('srtpu_torch.ops.trunk')
torch.set_num_threads(1)

C = k1.C


def plan(kind: str, n_blocks: int, save: bool, scale: float) -> tuple:
    """One K1 call's launches."""
    if kind == 'fwd':
        return kind, k1.fwd_plan(save, scale, n_blocks)
    return kind, k1.chain_plan(scale, n_blocks)


def held() -> set:
    """The plans of the K1 calls chip_smoke's phases hold on the card."""
    return {plan(*case) for case in chip_smoke.k1_held()}


def record(monkeypatch) -> set:
    """Record each K1 call as (kind, blocks, save, res_scale)."""
    seen = set()
    fwd, bwd = k1.trunk_fwd, k1.trunk_bwd

    def fwd_rec(x, w1s, b1s, w2s, b2s, res_scale, save=False):
        seen.add(('fwd', w1s.shape[0], save, float(res_scale)))
        return fwd(x, w1s, b1s, w2s, b2s, res_scale, save)

    def bwd_rec(xs, h1s, g, w1s, w2s, res_scale):
        seen.add(('chain', w1s.shape[0], False, float(res_scale)))
        return bwd(xs, h1s, g, w1s, w2s, res_scale)

    monkeypatch.setattr(k1, 'trunk_fwd', fwd_rec)
    monkeypatch.setattr(k1, 'trunk_bwd', bwd_rec)
    return seen


def expected(n_blocks: int, scale: float, train: bool) -> set:
    if train:
        return {('fwd', n_blocks, True, scale),
                ('chain', n_blocks, False, scale)}
    return {('fwd', n_blocks, False, scale)}


def check_held(seen: set) -> None:
    plans = held()
    for case in seen:
        assert plan(*case) in plans, case


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('res_scale', [1.0, 0.1])
def test_edsr_k1_plans_are_held_by_chip_smoke(monkeypatch, train, res_scale):
    seen = record(monkeypatch)
    model = create_model('EDSR', scale_factor=4, dtype=torch.bfloat16,
                         res_scale=res_scale,
                         generator=torch.Generator().manual_seed(0))
    lr = torch.rand((1, 6, 6, 3), generator=torch.Generator().manual_seed(1))
    if train:
        model.train()
        y = model(lr)
        y.float().mean().backward()
    else:
        model.eval()
        with torch.no_grad():
            y = model(lr)
    assert y.shape == (1, 24, 24, 3)
    assert seen == expected(chip_smoke.L, res_scale, train), seen
    check_held(seen)


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_resblock_cs_k1_plans_are_held_by_chip_smoke(monkeypatch, train):
    seen = record(monkeypatch)
    gen = torch.Generator().manual_seed(2)
    prm = [torch.empty(s).uniform_(-0.04, 0.04, generator=gen)
           .requires_grad_(train)
           for s in ((3, 3, C, C), (C,), (3, 3, C, C), (C,))]
    x = torch.rand((2, 5, 7, C), generator=gen).to(torch.bfloat16)
    rs = chip_smoke.EDSR86_RS       # phase 2j's and the op run's
    if train:
        k1.resblock_cs(x, *prm, rs).float().square().mean().backward()
    else:
        with torch.no_grad():
            k1.resblock_cs(x, *prm, rs)
    assert seen == expected(1, rs, train), seen
    check_held(seen)


CASES = {'fwd-save-1.0': ('fwd', True, 1.0),
         'fwd-predict-0.1': ('fwd', False, 0.1),
         'chain-1.0': ('chain', False, 1.0),
         'chain-0.1': ('chain', False, 0.1)}


@pytest.mark.parametrize('case', CASES)
def test_k1_plans_follow_the_engine(case):
    kind, save, scale = CASES[case]
    n = 3
    launches = plan(kind, n, save, scale)[1]
    engine = [lc for lc in launches if lc[0] == 'engine']
    assert len(engine) == 2 * n
    for _, epi, k, cin, cout, _, _, _ in engine:
        assert (k, cin, cout) == (3, C, C) and engine_bn(cout) == cout
        assert epi in (0, 5, 6)         # K6's and K5's forward stay theirs
    others = [lc[0] for lc in launches if lc[0] != 'engine']
    if kind == 'fwd':
        assert others == (['copy'] if save else [])
        for conv1, conv2 in zip(engine[0::2], engine[1::2]):
            assert conv1[1:8] == (0, 3, C, C, False, None, ('h1',))
            assert conv2[1:8] == (6, 3, C, C, False, scale, ('out',))
        return
    assert others == ['copy'] + (['gs'] * n if scale != 1.0 else [])
    if scale != 1.0:                    # each block's gs before its dh1
        gs = [i for i, lc in enumerate(launches) if lc[0] == 'gs']
        assert all(launches[i + 1][-1] == ('dh1',) for i in gs)
        assert all(launches[i][6] == scale for i in gs)
    for dh1, dx in zip(engine[0::2], engine[1::2]):
        assert dh1[1:8] == (5, 3, C, C, True, None, ('dh1',))
        assert dx[1:8] == (5, 3, C, C, True, None, ('dx',))


def bf16_rne(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bits (uint16), round to nearest even, as
    ``__floats2bfloat162_rn`` (finite values)."""
    u = x.astype(np.float32).view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def gs_kernel(g: torch.Tensor, scale: float) -> np.ndarray:
    """The kernel's gs from bf16 g as bf16 bits: g itself where the f32
    res_scale is 1 (no pass runs), else bf16(f32(g) * f32(res_scale)),
    the arithmetic of trunk.cu's trunk_gs_kernel."""
    bits = g.view(torch.int16).numpy().view(np.uint16)
    s = np.float32(scale)
    if s == np.float32(1.0):
        return bits
    f = (bits.astype(np.uint32) << 16).view(np.float32)
    return bf16_rne(f * s)


@pytest.mark.parametrize('res_scale', [1.0, 0.8, 0.1])
def test_gs_emulation_matches_trunk_bwd_plain(monkeypatch, res_scale):
    # every finite bf16 value, as the plain backward rounds it
    every = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    every = every.view(torch.bfloat16)
    every = every[torch.isfinite(every.float())]
    plain = (every.float() * res_scale).to(torch.bfloat16)
    ok = torch.isfinite(plain.float())
    assert np.array_equal(gs_kernel(every[ok], res_scale),
                          plain[ok].view(torch.int16).numpy()
                          .view(np.uint16))
    # and each block's gs inside trunk_bwd_plain: the first operand of its
    # first conv, from that block's output cotangent (the stack the
    # weight grads read)
    firsts, stacks = [], []
    conv, wgrad = k1.conv_f32, k1.conv_wgrad_plain

    def conv_rec(x, w, b=None):
        firsts.append(x)
        return conv(x, w, b)

    def wgrad_rec(x, g, **kw):
        stacks.append(g)
        return wgrad(x, g, **kw)

    monkeypatch.setattr(k1, 'conv_f32', conv_rec)
    monkeypatch.setattr(k1, 'conv_wgrad_plain', wgrad_rec)
    gen = torch.Generator().manual_seed(3)
    n, shape = 3, (2, 5, 7, C)

    def u(s, b):
        return torch.empty(s).uniform_(-b, b, generator=gen).to(
            torch.bfloat16)

    xs, h1s = u((n, *shape), 1.0), u((n, *shape), 1.0)
    w1s, w2s = u((n, 3, 3, C, C), 0.05), u((n, 3, 3, C, C), 0.05)
    k1.trunk_bwd_plain(xs, h1s, u(shape, 1.0), w1s, w2s, res_scale)
    gstack = stacks[0]                  # block l's output cotangent, slot l
    for i, l in enumerate(reversed(range(n))):
        gs = firsts[2 * i]              # block l's gs (then its dh1)
        assert np.array_equal(gs_kernel(gstack[l], res_scale),
                              gs.view(torch.int16).numpy().view(np.uint16))
