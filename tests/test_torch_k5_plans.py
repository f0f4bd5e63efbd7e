"""K5's launch plans cover what RCAN-10x16 launches, and conv2's pool
partials sum to the plain mean.

K5 (``ops.rcab``: ``group_fwd`` and ``group_chain``, one host call per
residual group each way, and ``rcab_fwd`` / ``rcab_bwd`` over them at
L = 1) runs its convs on K2's engine (``csrc/conv_sm90.cuh``) and its
pool, MLP, gate and dr2 as ``csrc/rcab.cu``'s passes; ``fwd_plan``,
``chain_plan`` and ``tile_grid`` are its launches in plain Python, as
rcab.cu makes them. Here, on the CPU (where the wrappers run their plain
versions):

- RCAN-10x16 (chip_smoke's configuration) on a tiny image, in eval mode
  and in train mode (forward and backward), records every K5 call; each
  call's plan must be among those of the cases chip_smoke.py's phase 2c
  holds on the card (``K5_GROUPS`` RCABs each way, the forward saving and
  not).
- Each plan follows the engine's rules: every conv a 3x3 64 -> 64 on
  K2's plan for that class (one N tile of 64), K2's own instance (EPI 0)
  for conv1 and K5's epilogues (EPI 4, 5), none of K6's (1-3), for the
  rest, the chain's transposed; and writes what the wrapper returns.
- An f32 emulation of conv2's per-tile pool partials at chip_smoke's K5
  shapes (8 x 16 tiles, the ragged 2 x 67 x 45 among them: each thread
  its two pixels, a butterfly over 8 lanes, the 8 tile rows in order;
  then F2's fixed order over the tiles) equals the plain mean within
  1e-6 of the mean magnitude.

One test per case, so each counts.
"""

import pytest
import torch

import chip_smoke
from srtpu_torch.models import create_model
from srtpu_torch.ops import rcab as k5
from srtpu_torch.ops.conv import conv3x3_plain, conv_f32
from srtpu_torch.ops.rdn import engine_bn

torch.set_num_threads(1)

C = k5.C


def plan(kind: str, n_rcabs: int, save: bool) -> tuple:
    """One K5 call's launches: a group of n_rcabs RCABs."""
    one = k5.fwd_plan(save) if kind == 'fwd' else k5.chain_plan()
    return kind, one * n_rcabs


def held() -> set:
    """The plans of the K5 cases chip_smoke's phase 2c holds on the card."""
    return ({plan('fwd', n, s) for n in chip_smoke.K5_GROUPS
             for s in (True, False)}
            | {plan('chain', n, False) for n in chip_smoke.K5_GROUPS})


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_rcan_k5_plans_are_held_by_chip_smoke(monkeypatch, train):
    seen = set()

    def fwd_rec(fn):
        def wrapped(x, w1s, *rest, save=False, **kw):
            seen.add(('fwd', w1s.shape[0], save))
            return fn(x, w1s, *rest, save=save, **kw)
        return wrapped

    def chain_rec(fn):
        def wrapped(h1s, *rest, **kw):
            seen.add(('chain', h1s.shape[0], False))
            return fn(h1s, *rest, **kw)
        return wrapped

    monkeypatch.setattr(k5, 'group_fwd', fwd_rec(k5.group_fwd))
    monkeypatch.setattr(k5, 'group_chain', chain_rec(k5.group_chain))
    model = create_model('RCAN', scale_factor=4, dtype=torch.bfloat16,
                         n_resgroups=chip_smoke.GROUPS,
                         n_resblocks=chip_smoke.RCABS,
                         reduction=chip_smoke.REDUCTION,
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
    assert seen == ({('fwd', chip_smoke.RCABS, True),
                     ('chain', chip_smoke.RCABS, False)} if train
                    else {('fwd', chip_smoke.RCABS, False)}), seen
    plans = held()
    for kind, n, save in seen:
        assert plan(kind, n, save) in plans


@pytest.mark.parametrize('case', ['fwd-save', 'fwd-predict', 'chain'])
def test_k5_plans_follow_the_engine(case):
    launches = (k5.chain_plan() if case == 'chain'
                else k5.fwd_plan(case == 'fwd-save'))
    engine = [lc for lc in launches if lc[0] == 'engine']
    assert len(engine) == 2
    for _, epi, k, cin, cout, tb, _ in engine:
        assert (k, cin, cout) == (3, C, C) and engine_bn(cout) == cout
        assert epi not in (1, 2, 3)          # K6's instances stay K6's
    epis = [(lc[1], lc[5]) for lc in engine]
    if case == 'chain':
        assert epis == [(5, True), (5, True)]
    else:
        assert epis == [(0, False), (4, False)]
    writes = [w for lc in launches for w in lc[6]]
    assert len(writes) == len(set(writes))    # each written once
    want = {'fwd-save': {'out', 'h1', 'r2'}, 'fwd-predict': {'out'},
            'chain': {'dx', 'dr2', 'dh1', 'dwd', 'dbd', 'dwu', 'dbu'}}[case]
    assert want <= set(writes)
    if case == 'fwd-predict':
        assert 'r2' not in writes


def pool_emulated(r2f: torch.Tensor) -> torch.Tensor:
    """p = mean of r2f (B, H, W, C) f32 over the image, summed as conv2's
    epilogue (EPI 4) and F2 sum it, in f32: per tile and channel, each
    thread adds its pixel columns q and q + 8 of its tile row, the 8
    lanes of a channel (q = 0..7) add theirs in a butterfly, and the 8
    rows are added in order into the tile's slot; F2 adds the slots of an
    image in 16 strided slices, then the slices in order."""
    b, h, w, c = r2f.shape
    _, ty, tx = k5.tile_grid(b, h, w)
    pad = r2f.new_zeros((b, ty * k5.TH, tx * k5.TW, c))
    pad[:, :h, :w] = r2f           # outside the image: left out (adds 0)
    t = pad.reshape(b, ty, k5.TH, tx, k5.TW, c).permute(0, 1, 3, 2, 4, 5)
    lanes = t[..., :8, :] + t[..., 8:, :]        # (b, ty, tx, row, q, c)
    for _ in range(3):                           # the butterfly: q ^ 1, 2, 4
        lanes = lanes[..., 0::2, :] + lanes[..., 1::2, :]
    rows = lanes[..., 0, :]                      # (b, ty, tx, row, c)
    slot = rows[..., 0, :]
    for r in range(1, k5.TH):
        slot = slot + rows[..., r, :]
    slot = slot.reshape(b, ty * tx, c)
    total = torch.zeros((b, c))
    for s in range(16):
        a = torch.zeros((b, c))
        for i in range(s, ty * tx, 16):
            a = a + slot[:, i]
        total = total + a
    return total / (float(h) * float(w))


@pytest.mark.parametrize('shape', chip_smoke.K5_SHAPES,
                         ids=lambda s: 'x'.join(map(str, s)))
def test_pool_partials_sum_to_the_plain_mean(shape):
    bsz, h, w = shape
    gen = torch.Generator().manual_seed(bsz * 31 + h * 7 + w)

    def u(shape, bound):
        return torch.empty(shape).uniform_(-bound, bound, generator=gen)

    cb = (9 * C) ** -0.5
    x = u((bsz, h, w, C), 1.0).to(torch.bfloat16)
    h1 = conv3x3_plain(x, u((3, 3, C, C), cb).to(torch.bfloat16),
                       u((C,), cb), relu=True)
    r2f = conv_f32(h1, u((3, 3, C, C), cb).to(torch.bfloat16), u((C,), cb))
    got = pool_emulated(r2f)
    ref = r2f.mean((1, 2))
    scale = r2f.abs().mean((1, 2))
    assert got.dtype == torch.float32 and got.shape == (bsz, C)
    assert bool(((got - ref).abs() <= 1e-6 * scale).all()), (
        (got - ref).abs().div(scale).max().item())
