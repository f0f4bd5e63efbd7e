"""K6's launch plans cover what RDN-B launches, and the chain's
decomposition sums as its plain version does.

K6 (``ops.rdn``: ``rdn_fwd``, ``rdb_bwd_chain``, ``rdb_bwd_dw``) runs on
K2's engine (``csrc/conv_sm90.cuh``) and W's (``csrc/wgrad.cu``);
``fwd_plan``, ``chain_plan`` and ``dw_plan`` are its launches in plain
Python, as ``csrc/rdn.cu`` makes them. Here, on the CPU (where the
wrappers run their plain versions):

- RDN-B (config B at full width: 16 blocks of 8 dense layers at G0 = 64)
  on a tiny image, in eval mode and in train mode (forward and backward),
  on the grid trunk and on srtpu's 'calls' form (``rdn_trunk_calls``,
  one block a call), records every K6 call; each call's plans must be
  among those of the cases chip_smoke.py holds on the card: its K6
  shapes at ``K6_BLOCKS`` blocks of RDN_C layers (phase 2e's grid trunk,
  phase 2j's calls trunk).
- Each plan is consistent with the engine's rules at 1, 3 and 8 layers:
  the chain's N tiles (the engine's N, ``engine_bn``) cover each
  launch's output channels once, the tile named for a mask holds that
  chunk, every read and write lies inside the buffer's pixel stride, and
  the pair jobs are ``pack``'s pair order.
- An f32 emulation of the chain's decomposition (``chain_plan``: tile by
  tile, every dbuf element written by exactly one tile a launch, each
  mask formed once its layer's dx has landed, dbuf accumulated layer by
  layer, db from per-tile partials added in order) at 2 blocks of 3
  layers and LR 8x8 equals ``rdb_bwd_chain_plain`` bit for bit in dx,
  dout, dwf and dbf, and db within f32 rounding (1e-5 of its largest
  magnitude: sums of 64-pixel partials in another order).

One test per case, so each counts.
"""

import pytest
import torch

import chip_smoke
from srtpu_torch.models import create_model
from srtpu_torch.models import rdn as rdn_model
from srtpu_torch.ops import rdn as k6
from srtpu_torch.ops.conv import conv_f32
from srtpu_torch.ops.layout import w_t

torch.set_num_threads(1)

G = k6.G


def _plans(n_blocks: int, n_layers: int) -> tuple:
    return (k6.fwd_plan(n_blocks, n_layers), k6.chain_plan(n_layers),
            k6.dw_plan(n_layers))


def held() -> set:
    """The plans of the K6 cases chip_smoke holds on the card."""
    return {_plans(d, chip_smoke.RDN_C) for d in chip_smoke.K6_BLOCKS}


# (the calls form, train mode)
CASES = {'grid-eval': (False, False), 'grid-train': (False, True),
         'calls-eval': (True, False), 'calls-train': (True, True)}


@pytest.mark.parametrize('case', sorted(CASES))
def test_rdn_b_k6_plans_are_held_by_chip_smoke(monkeypatch, case):
    calls, train = CASES[case]
    seen = set()

    def fwd_rec(fn):
        def wrapped(x, wpk, b, wf, bf, save=False):
            seen.add(('fwd', b.shape[0], b.shape[1]))
            return fn(x, wpk, b, wf, bf, save)
        return wrapped

    def bwd_rec(fn, kind):
        def wrapped(bufs, l, *rest):
            seen.add((kind, None, bufs.shape[-1] // G - 1))
            return fn(bufs, l, *rest)
        return wrapped

    # the wrappers and the plain versions the CPU's backward takes
    for name in ('rdn_fwd', 'rdn_fwd_plain'):
        monkeypatch.setattr(k6, name, fwd_rec(getattr(k6, name)))
    for name in ('rdb_bwd_chain', 'rdb_bwd_chain_plain'):
        monkeypatch.setattr(k6, name, bwd_rec(getattr(k6, name), 'chain'))
    for name in ('rdb_bwd_dw', 'rdb_bwd_dw_plain'):
        monkeypatch.setattr(k6, name, bwd_rec(getattr(k6, name), 'dw'))
    if calls:
        monkeypatch.setattr(
            rdn_model, 'rdn_trunk',
            lambda *a: torch.cat(k6.rdn_trunk_calls(*a), -1))
    model = create_model('RDN', scale_factor=4, dtype=torch.bfloat16,
                         rdn_config='B', growth0=chip_smoke.RDN_G0,
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
    kinds = {k for k, _, _ in seen}
    assert kinds == ({'fwd', 'chain', 'dw'} if train else {'fwd'}), seen
    fwds = {(d, c) for k, d, c in seen if k == 'fwd'}
    layers = {c for _, _, c in seen}
    assert layers == {chip_smoke.RDN_C}, seen
    plans = held()
    for d, c in fwds:
        assert (k6.fwd_plan(d, c), k6.chain_plan(c), k6.dw_plan(c)) in plans


@pytest.mark.parametrize('n_layers', [1, 3, 8])
def test_k6_plans_follow_the_engines(n_layers):
    c_tot = G * (n_layers + 1)
    fwd = k6.fwd_plan(16, n_layers)
    assert len(fwd) == n_layers + 1
    for i, (k, cin, cout, xps, ops, off) in enumerate(fwd[:-1]):
        # dense layer i: the prefix of chunks 0..i in, chunk i + 1 out
        assert (k, cin, cout, xps, ops, off) == (3, G * (i + 1), G, c_tot,
                                                 c_tot, G * (i + 1))
        assert cin <= off and off + cout <= ops
    assert fwd[-1] == (1, c_tot, G, c_tot, 16 * G, 0)
    chain = k6.chain_plan(n_layers)
    assert [launch[6] for launch in chain] == [
        n_layers, *reversed(range(1, n_layers)), None]
    for k, cin, cout, xps, xoff, tiles, m, owner in chain:
        bn = k6.engine_bn(cout)
        assert bn in (64, 128, 192) and cout % bn == 0
        covered = torch.zeros(cout, dtype=torch.int32)
        for n0, n1 in tiles:
            assert n1 - n0 == bn
            covered[n0:n1] += 1
        assert torch.equal(covered, torch.ones_like(covered))
        assert xoff + cin <= xps and cout <= c_tot
        if m is None:
            assert owner is None and cout == G  # layer 0: dx
        else:
            n0, n1 = tiles[owner]
            assert n0 <= G * m and G * (m + 1) <= n1
    pairs = k6.dw_plan(n_layers)
    assert len(pairs) == k6.n_pairs(n_layers)
    assert [i * (i + 1) // 2 + j for i, j in pairs] == list(
        range(len(pairs)))
    assert all(0 <= j <= i < n_layers for i, j in pairs)


def _emulated_chain(bufs, l, g_run, ct, wtpk, wft):
    """rdb_bwd_chain by chain_plan's launches, each output channel tile
    written by its own step, in f32 as the kernels round."""
    buf = bufs[l]
    dt = buf.dtype
    n_layers = buf.shape[-1] // G - 1
    bsz, h, w, _ = buf.shape
    gf = g_run.float() + ct[..., l * G:(l + 1) * G].float()
    gc = gf.to(dt)
    dwf = torch.einsum('bhwc,bhwo->co', buf.float(), gc.float())
    dbuf = torch.full(buf.shape, float('nan'))
    dout = buf.new_zeros((bsz, h, w, n_layers * G))
    th, tw = k6.TILE_H, k6.TILE_W
    pix_tiles = [(b, y, x) for b in range(bsz) for y in range(0, h, th)
                 for x in range(0, w, tw)]
    db_parts = torch.zeros((n_layers, len(pix_tiles), G))
    dx = None
    for k, cin, cout, xps, xoff, tiles, m, owner in k6.chain_plan(n_layers):
        if k == 1:      # the fusion's backward: dbuf = gc wf^T
            sums, accum = gc.float() @ wft[l].float(), False
        else:           # layer i's dx into chunks 0..i
            i = xoff // G
            sums = conv_f32(dout[..., xoff:xoff + G], k6._layer_t(wtpk[l], i))
            accum = True
        writes = torch.zeros(cout, dtype=torch.int32)
        for t, (n0, n1) in enumerate(tiles):
            writes[n0:n1] += 1
            new = (dbuf[..., n0:n1] + sums[..., n0:n1] if accum
                   else sums[..., n0:n1])
            if m is None:       # layer 0: dx in place of dbuf
                dx = (new + gf).to(dt)
                continue
            dbuf[..., n0:n1] = new
            if t != owner:
                continue
            # the block holding chunk m: dout_{m-1} from the final chunk
            hm = buf[..., G * m:G * (m + 1)].float()
            d = torch.where(hm > 0, dbuf[..., G * m:G * (m + 1)], 0.0)
            dout[..., G * (m - 1):G * m] = d.to(dt)
            for p, (b, y, x) in enumerate(pix_tiles):
                db_parts[m - 1, p] = d[b, y:y + th, x:x + tw].sum((0, 1))
        assert torch.equal(writes, torch.ones_like(writes))
    db = torch.zeros((n_layers, G))
    for p in range(len(pix_tiles)):
        db += db_parts[:, p]
    return dx, dout, dwf, gf.sum((0, 1, 2)), db


@pytest.mark.parametrize('block', [1, 0])
def test_chain_decomposition_matches_plain_bit_for_bit(block):
    gen = torch.Generator().manual_seed(13 + block)
    d, c, bsz, h, w = 2, 3, 2, 8, 8
    c_tot = G * (c + 1)

    def u(shape, bound):
        return torch.empty(shape).uniform_(-bound, bound, generator=gen)

    ws = [u((d, 3, 3, G * (i + 1), G), (9 * G * (i + 1)) ** -0.5).to(
        torch.bfloat16) for i in range(c)]
    x = u((bsz, h, w, G), 1.0).to(torch.bfloat16)
    wpk = k6.pack(ws)
    b = u((d, c, G), 0.05)
    wf = u((d, c_tot, G), c_tot ** -0.5).to(torch.bfloat16)
    bf = u((d, G), c_tot ** -0.5)
    _, bufs = k6.rdn_fwd_plain(x, wpk, b, wf, bf, save=True)
    g = u((bsz, h, w, G), 1.0).to(torch.bfloat16)
    ct = u((bsz, h, w, d * G), 1.0).to(torch.bfloat16)
    args = (bufs, block, g, ct, w_t(wpk).contiguous(),
            wf.transpose(1, 2).contiguous())
    got = _emulated_chain(*args)
    ref = k6.rdb_bwd_chain_plain(*args)
    for name, a, r in zip(('dx', 'dout', 'dwf', 'dbf'), got[:4], ref[:4]):
        assert a.dtype == r.dtype and torch.equal(a, r), name
    top = ref[4].abs().max().item()
    assert (got[4] - ref[4]).abs().max().item() <= 1e-5 * top
