"""chip_smoke.py holds every weight-grad class the port's main paths
launch, and the weight-grad engine's split of the pixels sums each tile
once.

W (``ops.wgrad.conv_wgrad``, ``csrc/wgrad.cu``) takes any k = 3 or 5 conv
whose channel counts are multiples of 16, in several modes: stacked jobs
(J > 1), a scaled cotangent (gscale != 1), the r = 2 gather and REFLECT.
The card check, chip_smoke.py's phase 2l, holds it against its plain
version at a fixed list of classes (``W_CASES``), so a model path that
launched a class outside that list would run unchecked on the card. Here,
on the CPU (where the wrapper runs its plain version), each model at full
width on a tiny image runs a train-mode forward and backward, every (k,
c_in, c_out, r, reflect, gscale != 1, J > 1) reaching ``conv_wgrad`` is
recorded at the kernel path's callers and at the plain paths they take
on the CPU, which make the same calls to ``conv_wgrad_plain`` (K7's dW3
off ``wdsr_trunk_bwd``, whose launches are CUDA-only; its dW1 and dW2 at
k = 1 are K7's own, held by chip_smoke's phase 2g), and each
must be among chip_smoke's W cases, built here with device ``cpu``. One
case per model, so each counts; K9d's (64, 128) from ``ops/resblock.py``.

The split (``wgrad_parts``, ``wgrad_workspace``) is plain Python: with
the kernel's runs of tiles (part p of P sums tiles p T / P to (p + 1) T /
P - 1, ``part_tiles``) every tile of every job is summed once, the workspace is the
partial slots the kernel writes, and an f32 emulation of the kernel's
fixed order (each part's tiles in order, then a cluster's ranks in order,
then the slots in order) equals ``conv_wgrad_plain`` to f32 rounding:
1e-5 of the largest magnitude (sums of up to a few thousand products in
another order). ``conv_wgrad_plain`` is held against srtpu in the modes
``tests/test_torch_ops.py`` does not cover: 5x5 (``conv3x3_cs``, Pallas
in interpret mode), stacked jobs with a scaled cotangent (each job
against ``conv3x3_cs`` fed srtpu's bf16(scale * g), as its trunk forms
gs) and REFLECT (the vjp of srtpu's ``conv3x3_reflect_reference``): 1e-4
of the largest magnitude, f32 sums in another order.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from srtpu.ops import cs_conv
from srtpu_torch.models import create_model

# the modules themselves (srtpu_torch.ops exports functions of some names)
bn_mod, conv_mod, rcab_mod, trunk_mod, ups_mod, wdsr_mod, wgrad = (
    importlib.import_module(f'srtpu_torch.ops.{name}') for name in
    ('bn_block', 'conv', 'rcab', 'trunk', 'upsample', 'wdsr', 'wgrad'))

torch.set_num_threads(1)

# chip_smoke's configurations: full width and depth
MODELS = {
    'EDSR-x4': ('EDSR', 4, {}),
    'EDSR-x3': ('EDSR', 3, {}),
    'SRResNet-x4': ('SRResNet', 4, {}),
    'SRResNet-x3': ('SRResNet', 3, {}),
    'SRGAN': ('SRGAN', 4, dict(ngf=chip_smoke.C, ndf=chip_smoke.C,
                               n_blocks=chip_smoke.L, use_pallas='cs')),
    'RCAN-10x16': ('RCAN', 4, dict(n_resgroups=chip_smoke.GROUPS,
                                   n_resblocks=chip_smoke.RCABS,
                                   reduction=chip_smoke.REDUCTION)),
    'RDN-B': ('RDN', 4, dict(rdn_config='B', growth0=chip_smoke.RDN_G0)),
    'DDBPN-x4': ('DDBPN', 4, dict(n0=chip_smoke.DDBPN_N0,
                                  nr=chip_smoke.DDBPN_NR,
                                  depth=chip_smoke.DDBPN_DEPTH)),
    'WDSR-B': ('WDSR', 4, dict(n_feats=chip_smoke.WDSR_C,
                               n_resblocks=chip_smoke.WDSR_L,
                               use_pallas='cs')),
}
# K9d's weight grads: (64, 128), the [hi | lo] pairs (ops/resblock.py)
K9D = (3, 64, 128, 1, False, False, False)


def _key(k, cin, cout, r, reflect, gscale, jobs) -> tuple:
    return (k, cin, cout, r, bool(reflect), gscale != 1.0, jobs > 1)


@pytest.fixture(scope='module')
def held() -> set:
    """The (k, c_in, c_out, r, reflect, gscale != 1, J > 1) chip_smoke's
    W cases hold the kernel to on the card."""
    return {_key(*case[1:8]) for case in
            chip_smoke.w_cases(torch.device('cpu'), 1, 4, 4)}


@pytest.fixture(autouse=True)
def cs_kernels_interpret(monkeypatch):
    monkeypatch.setenv('SRTPU_CS_OFF_TPU', '1')


@pytest.mark.parametrize('case', sorted(MODELS))
def test_main_path_wgrad_classes_are_held_by_chip_smoke(monkeypatch, held,
                                                        case):
    name, scale, kw = MODELS[case]
    seen = set()

    def recorder(fn):
        def wrapped(x, g, gscale=1.0, r=1, k=3, reflect=False):
            cout = g.shape[-1] * (r * r if r > 1 else 1)
            seen.add(_key(k, x.shape[-1], cout, r, reflect, gscale,
                          math.prod(x.shape[:-4])))
            return fn(x, g, gscale, r, k, reflect)
        return wrapped

    def wdsr_trunk_bwd(xs, h2s, g, w1s, b1s, w2s, b2s, w3s, res_scale):
        # K7's dW3 per block, at the kernels' width (the wrapper pads to it)
        c = wdsr_mod.kernel_c(w3s.shape[-1])
        seen.add(_key(3, c, c, 1, False, res_scale, 1))
        return wdsr_trunk_bwd_orig(xs, h2s, g, w1s, b1s, w2s, b2s, w3s,
                                   res_scale)

    # the kernel path's callers, and the plain paths they take on the CPU
    # (each makes the kernel path's call to conv_wgrad_plain)
    wdsr_trunk_bwd_orig = wdsr_mod.wdsr_trunk_bwd
    for mod in (trunk_mod, rcab_mod, conv_mod, ups_mod):
        monkeypatch.setattr(mod, 'conv_wgrad', recorder(wgrad.conv_wgrad))
        monkeypatch.setattr(mod, 'conv_wgrad_plain',
                            recorder(wgrad.conv_wgrad_plain))
    monkeypatch.setitem(bn_mod.KERNELS, 'wgrad', recorder(wgrad.conv_wgrad))
    monkeypatch.setitem(bn_mod.PLAIN, 'wgrad',
                        recorder(wgrad.conv_wgrad_plain))
    monkeypatch.setattr(wdsr_mod, 'wdsr_trunk_bwd', wdsr_trunk_bwd)
    model = create_model(name, scale_factor=scale, dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(0), **kw)
    lr = torch.rand((1, 8, 8, 3), generator=torch.Generator().manual_seed(1))
    model.train()
    y = model(lr)
    assert y.shape == (1, 8 * scale, 8 * scale, 3)
    y.float().mean().backward()
    assert seen, case
    assert seen <= held, sorted(seen - held)


def test_k9d_wgrad_class_is_held_by_chip_smoke(held):
    assert K9D in held


# ------------------------------------------------------------ the split


def part_tiles(ntiles: int, parts: int) -> list:
    """The tiles each part sums, in order (wgrad.cu: t0 and t1)."""
    return [range(p * ntiles // parts, (p + 1) * ntiles // parts)
            for p in range(parts)]


# (bsz, h, w, c_in, c_out, r, k, jobs): chip_smoke's training-shape
# classes (LR 32x32, batch 16) and small ragged ones
SPLITS = [(16, 32, 32, 64, 64, 1, 3, 16), (16, 32, 32, 64, 64, 1, 3, 86),
          (16, 32, 32, 64, 64, 1, 3, 1), (16, 64, 64, 64, 256, 1, 3, 1),
          (16, 32, 32, 64, 256, 2, 3, 1), (16, 64, 64, 256, 16, 1, 5, 1),
          (16, 32, 32, 512, 48, 1, 3, 1), (16, 32, 32, 576, 32, 1, 5, 1),
          (16, 32, 32, 112, 128, 1, 3, 1), (16, 32, 32, 128, 128, 1, 3, 1),
          (16, 32, 32, 128, 768, 1, 1, 1), (16, 32, 32, 768, 128, 1, 1, 1),
          (2, 67, 45, 64, 64, 1, 3, 1),
          (2, 3, 5, 64, 64, 1, 3, 1), (1, 9, 33, 16, 16, 1, 3, 3)]


@pytest.mark.parametrize('split', SPLITS)
def test_split_sums_every_tile_once_and_sizes_the_workspace(split):
    bsz, h, w, cin, cout, r, k, jobs = split
    cluster, clusters = wgrad.wgrad_parts(bsz, h, w, cin, cout, r, k, jobs)
    assert 1 <= cluster <= 8 and clusters >= 1
    tiles = bsz * -(-h // wgrad.TH) * -(-w // wgrad.TW)
    runs = part_tiles(tiles, cluster * clusters)
    assert [t for run in runs for t in run] == list(range(tiles))
    ws_w, ws_b = wgrad.wgrad_workspace(jobs, cluster, clusters, cin, cout,
                                       k, torch.device('cpu'))
    slots = clusters if clusters > 1 else 0
    assert ws_w.shape == (jobs, slots, k * k * cin * cout)
    assert ws_b.shape == (jobs, slots, cout)
    assert ws_w.dtype == ws_b.dtype == torch.float32


def _tiles_of(bsz, h, w):
    """Pixel indices (into the flattened (B, H, W)) of each TH x TW tile,
    in the kernel's order: image, tile row, tile column."""
    idx = torch.arange(bsz * h * w).reshape(bsz, h, w)
    out = []
    for b in range(bsz):
        for y0 in range(0, h, wgrad.TH):
            for x0 in range(0, w, wgrad.TW):
                out.append(idx[b, y0:y0 + wgrad.TH, x0:x0 + wgrad.TW]
                           .reshape(-1))
    return out


def _emulate(x, g, gscale, r, k, reflect):
    """dW and db summed in the kernel's order, in f32: each part's tiles in
    order, a cluster's ranks in order, the slots in order."""
    lead = x.shape[:-4]
    bsz, h, w, cin = x.shape[-4:]
    jobs = math.prod(lead)
    xs = x.reshape(jobs, bsz, h, w, cin)
    gs = g.reshape(jobs, *g.shape[-4:])
    cout = gs.shape[-1] * (r * r if r > 1 else 1)
    cluster, clusters = wgrad.wgrad_parts(bsz, h, w, cin, cout, r, k, jobs)
    tiles = _tiles_of(bsz, h, w)
    runs = part_tiles(len(tiles), cluster * clusters)
    dws, dbs = [], []
    for xj, gj in zip(xs, gs):
        gj = wgrad._gather(gj, gscale, r).float().reshape(-1, cout)
        xc = xj.permute(0, 3, 1, 2).float()
        if reflect:
            xc = torch.nn.functional.pad(xc, (k // 2,) * 4, mode='reflect')
        cols = torch.nn.functional.unfold(xc, k, padding=0 if reflect
                                          else k // 2)
        cols = cols.permute(0, 2, 1).reshape(-1, cin * k * k)
        parts = []
        for run in runs:
            pw = torch.zeros(cin * k * k, cout)
            pb = torch.zeros(cout)
            for t in run:
                sel = tiles[t]
                pw = pw + cols[sel].T @ gj[sel]
                pb = pb + gj[sel].sum(0)
            parts.append((pw, pb))
        slots = []
        for c in range(clusters):
            sw, sb = parts[c * cluster]
            for q in range(1, cluster):
                sw, sb = sw + parts[c * cluster + q][0], \
                    sb + parts[c * cluster + q][1]
            slots.append((sw, sb))
        dw, db = slots[0]
        for sw, sb in slots[1:]:
            dw, db = dw + sw, db + sb
        dws.append(dw.reshape(cin, k, k, cout).permute(1, 2, 0, 3))
        dbs.append(db)
    return (torch.stack(dws).reshape(*lead, k, k, cin, cout),
            torch.stack(dbs).reshape(*lead, cout))


# (label, jobs, bsz, h, w, c_in, c_out, r, k, gscale, reflect)
EMULATED = [('3x3', 0, 2, 9, 33, 16, 32, 1, 3, 1.0, False),
            ('jobs and gscale', 3, 2, 9, 20, 16, 16, 1, 3, 0.1, False),
            ('r = 2 gather', 0, 2, 9, 17, 16, 64, 2, 3, 1.0, False),
            ('reflect', 0, 2, 9, 17, 64, 64, 1, 3, 1.0, True),
            ('5x5', 0, 1, 17, 33, 32, 16, 1, 5, 1.0, False),
            ('5x5 deep, narrow', 0, 1, 9, 17, 96, 16, 1, 5, 1.0, False)]


@pytest.mark.parametrize('case', EMULATED, ids=[c[0] for c in EMULATED])
def test_fixed_order_partials_equal_the_plain_sums(case):
    _, jobs, bsz, h, w, cin, cout, r, k, gscale, reflect = case
    rng = np.random.default_rng(cin + cout + h)
    lead = (jobs,) if jobs else ()
    gshape = (*lead, bsz, r * h, r * w, cout // (r * r)) if r > 1 else \
        (*lead, bsz, h, w, cout)
    x = torch.from_numpy(rng.uniform(-1, 1, (*lead, bsz, h, w, cin))
                         .astype(np.float32)).to(torch.bfloat16)
    g = torch.from_numpy(rng.uniform(-1, 1, gshape).astype(np.float32)) \
        .to(torch.bfloat16)
    got = _emulate(x, g, gscale, r, k, reflect)
    ref = wgrad.conv_wgrad_plain(x, g, gscale, r, k, reflect)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


# ---------------------------------------------- the plain version vs srtpu

B, H, W, K = 2, 8, 8, 2       # two 8x8 images side by side: S = 128 lanes


def _to_cs(x):
    return cs_conv.nhwc_to_cs(jnp.asarray(x), K)


def _srtpu_dw(x, w, g):
    """srtpu's dW, db of its CS SAME conv (Pallas, interpret mode)."""
    fn = lambda xc, wc, bc: cs_conv.conv3x3_cs(xc, wc, bc, W, K)
    b = jnp.zeros((w.shape[-1],), jnp.float32)
    _, vjp = jax.vjp(fn, _to_cs(x), jnp.asarray(w), b)
    _, dw, db = vjp(_to_cs(g))
    return np.asarray(dw, np.float32), np.asarray(db, np.float32)


def _close(got, ref, rel=1e-4):
    got = got.detach().float().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def test_plain_5x5_matches_srtpu():
    rng = np.random.default_rng(30)
    x = rng.standard_normal((B, H, W, 16)).astype(np.float32)
    g = rng.standard_normal((B, H, W, 16)).astype(np.float32)
    w = (rng.standard_normal((5, 5, 16, 16)) * 0.1).astype(np.float32)
    dw, db = _srtpu_dw(x, w, g)
    got = wgrad.conv_wgrad_plain(torch.from_numpy(x), torch.from_numpy(g),
                                 k=5)
    _close(got[0], dw)
    _close(got[1], db)


def test_plain_jobs_with_scaled_cotangent_match_srtpu():
    """J = 3 stacked jobs at gscale 0.7, bf16: each job's dW is srtpu's
    with its cotangent rounded as its trunk rounds gs, bf16(0.7 * g)."""
    rng = np.random.default_rng(31)
    x = rng.standard_normal((3, B, H, W, 16)).astype(np.float32)
    g = rng.standard_normal((3, B, H, W, 16)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 16, 16)) * 0.1).astype(np.float32)
    xb, gb = (torch.from_numpy(t).to(torch.bfloat16) for t in (x, g))
    got = wgrad.conv_wgrad_plain(xb, gb, gscale=0.7)
    for j in range(3):
        xj = jnp.asarray(xb[j].float().numpy(), jnp.bfloat16)
        gs = (jnp.asarray(gb[j].float().numpy()) * 0.7).astype(jnp.bfloat16)
        fn = lambda xc, wc, bc: cs_conv.conv3x3_cs(xc, wc, bc, W, K)
        # an f32 weight: srtpu returns its f32 dW unrounded
        _, vjp = jax.vjp(fn, cs_conv.nhwc_to_cs(xj, K), jnp.asarray(w),
                         jnp.zeros((16,), jnp.float32))
        _, dw, db = vjp(cs_conv.nhwc_to_cs(gs, K))
        _close(got[0][j], np.asarray(dw, np.float32))
        _close(got[1][j], np.asarray(db, np.float32))


def test_plain_reflect_matches_srtpu():
    """The weight grad of a REFLECT conv: the vjp of srtpu's plain
    reference (ReflectionPad2d(1) + a VALID conv)."""
    rng = np.random.default_rng(32)
    x = rng.standard_normal((B, 5, 7, 16)).astype(np.float32)
    g = rng.standard_normal((B, 5, 7, 16)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 16, 16)) * 0.1).astype(np.float32)
    _, vjp = jax.vjp(cs_conv.conv3x3_reflect_reference, jnp.asarray(x),
                     jnp.asarray(w), jnp.zeros((16,), jnp.float32))
    _, dw, db = vjp(jnp.asarray(g))
    got = wgrad.conv_wgrad_plain(torch.from_numpy(x), torch.from_numpy(g),
                                 reflect=True)
    _close(got[0], np.asarray(dw, np.float32))
    _close(got[1], np.asarray(db, np.float32))
