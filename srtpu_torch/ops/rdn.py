"""K6: RDN's residual dense block trunk, forward and backward.

Replaces ``srtpu/ops/cs_conv.py:rdn_all_fwd`` (body
``_rdn_all_fwd_kernel``), ``rdb_bwd_chain_all``
(``_rdb_bwd_chain_kernel_sp``) and ``rdb_bwd_dw_all``
(``_rdb_bwd_dw_kernel_sp``), behind ``rdn_trunk_cat_cs``. The kernels are
``csrc/rdn.cu``, whose head note says what bounds them on the H100 and
how the design replaces the TPU kernels' VMEM-resident concat buffer:
every product runs on the port's two wgmma engines, K2's
(``csrc/conv_sm90.cuh``: the forward's dense layers and fusion, the
chain's fusion backward and dx per layer) and W's (``csrc/wgrad.cu``:
the fusion's dwf, the pair weight grads). :func:`fwd_plan`,
:func:`chain_plan` and :func:`dw_plan` are those launches' plans in
plain Python; :func:`engine_conv` is K2's engine at K6's strides, which
the card tests hold to K2 on contiguous copies. :func:`rdn_fwd`, :func:`rdb_bwd_chain` and
:func:`rdb_bwd_dw` launch the kernels for CUDA tensors and take the
plain versions only for CPU tensors; :func:`rdn_trunk` is the
differentiable op (:class:`RDNTrunkFn`).

srtpu's two other trunk forms run on the same stored parameters:

* :func:`rdn_trunk_calls` (K9b; srtpu ``rdn_trunk_cs2``, which its RDN
  takes when ``cs_conv._RDN_FWD == 'calls'``): one block per call,
  :func:`rdn_fwd` on that block's slice of the stacks (D = 1: srtpu
  ``rdb_fused_fwd``), its backward K6's per-block chain and pair weight
  grads (srtpu ``rdb_bwd_chain`` / ``rdb_bwd_dw``, which the grid form
  runs per block too), fed the block's cotangent rounded once,
  bf16(f32(g) + f32(ct_l)), as srtpu rounds it. Its launches count on
  K6's wrappers.
* :func:`rdn_trunk_layers` (K9c; srtpu's round-2 ``rdn_trunk_cs``): each
  dense layer one K2 launch with ReLU over the growing concat
  (``conv3x3_cs_fwd_stk`` / ``conv3x3_cs_bwd_stk``), the 1x1 fusion, the
  skip and the backward's sums in stock ops with srtpu's XLA roundings.

Both return the D block outputs, which RDN concatenates.

A trunk is D blocks of C dense layers at growth G = G0. Layer i of a
block reads the concat of the block input and layers 0..i-1, (i + 1) G0
channels, and appends h_i = relu(conv3x3 + b_i); a 1x1 local fusion of
all c_tot = (C + 1) G0 channels, its bias and the block input give the
block output. The D outputs come back concatenated, ``cat`` (B, H, W,
D G0), the input of RDN's global fusion.

Shapes (the port's layout, NHWC activations):
  x (B, H, W, G0); the dense weights packed chunk-major, wpk (D,
  n_pairs, 3, 3, G0, G0), pair i (i + 1) / 2 + j being layer i's HWIO
  sub-kernel on input chunk j (:func:`pack`, srtpu ``w_rdn_chunk_major``);
  b (D, C, G0) f32; the fusion wf (D, c_tot, G0), bf (D, G0) f32; the
  saved concat buffers bufs (D, B, H, W, c_tot). The backward takes the
  pairs' transposed kernels wtpk = ``w_t(wpk)`` (srtpu
  ``w_rdn_chunks_T``) and wft (D, G0, c_tot). Activations and conv
  weights in the compute dtype (bf16 on the card), sums in f32.
"""

from __future__ import annotations

import torch

from . import _build
from .conv import conv3x3_bwd, conv3x3_bwd_plain, conv3x3_fwd, conv3x3_plain
from .conv import conv_f32
from .layout import w_t
from .wgrad import conv_wgrad_plain, wgrad_parts, wgrad_workspace

G = 64                  # the kernels' growth: one 64-channel chunk
TILE_H, TILE_W = 8, 16  # K2's engine's pixel tile (csrc/conv_sm90.cuh)
FUSE_PIX = 64           # pixels per block of the chain's gc kernel


def n_pairs(n_layers: int) -> int:
    """(layer, input chunk) pairs of a block: C (C + 1) / 2."""
    return n_layers * (n_layers + 1) // 2


def pack(ws) -> torch.Tensor:
    """Per-layer HWIO stacks ws[i] (D, 3, 3, (i + 1) G0, G0) -> (D,
    n_pairs, 3, 3, G0, G0), chunk-major: pair i (i + 1) / 2 + j holds
    layer i's input channels [j G0, (j + 1) G0)."""
    parts = []
    for i, w in enumerate(ws):
        d, kh, kw, cin, g = w.shape
        parts.append(w.reshape(d, kh, kw, i + 1, cin // (i + 1), g)
                     .permute(0, 3, 1, 2, 4, 5))
    return torch.cat(parts, 1).contiguous()


def unpack(wpk: torch.Tensor, n_layers: int) -> tuple:
    """Inverse of :func:`pack` (also the dW pairs' layout): (D, n_pairs,
    3, 3, G0, G) -> per-layer (D, 3, 3, (i + 1) G0, G)."""
    out, p = [], 0
    for i in range(n_layers):
        v = wpk[:, p:p + i + 1]
        d, n, kh, kw, g0, g = v.shape
        out.append(v.permute(0, 2, 3, 1, 4, 5).reshape(d, kh, kw, n * g0, g))
        p += i + 1
    return tuple(out)


def engine_bn(cout: int) -> int:
    """K2's engine's N a block (``conv_sm90.cuh:run``): the widest of
    192, 128, 64, 48, 32, 16 that divides cout."""
    return next(n for n in (192, 128, 64, 48, 32, 16) if cout % n == 0)


def fwd_plan(n_blocks: int, n_layers: int) -> tuple:
    """The launches of one block of :func:`rdn_fwd` on K2's engine, each
    (k, cin, cout, input pixel stride, output pixel stride, output
    channel offset): dense layer i reads the buffer's channel prefix [0,
    64 (i + 1)) at pixel stride c_tot and writes chunk i + 1 of it; the
    fusion reads all c_tot channels and writes the block's slice of cat
    (pixel stride 64 D; the block's offset in it apart) and the next
    block's chunk 0."""
    c_tot = G * (n_layers + 1)
    return (*((3, G * (i + 1), G, c_tot, c_tot, G * (i + 1))
              for i in range(n_layers)),
            (1, c_tot, G, c_tot, G * n_blocks, 0))


def chain_plan(n_layers: int) -> tuple:
    """The engine launches of :func:`rdb_bwd_chain` in order: the
    fusion's backward (k = 1, gc -> dbuf's c_tot channels), then layer i
    from C - 1 down to 0 (k = 3, doutb_i -> dbuf's chunks 0..i). Each
    (k, cin, cout, input pixel stride, input channel offset, the N tiles
    (n0, n1) of its blocks, the chunk m whose mask it forms (dout_{m-1};
    None at layer 0, which writes dx), the index of the N tile that holds
    chunk m)."""
    c_tot = G * (n_layers + 1)

    def launch(k, cin, cout, xps, xoff, m):
        bn = engine_bn(cout)
        tiles = tuple((n, n + bn) for n in range(0, cout, bn))
        return (k, cin, cout, xps, xoff, tiles, m,
                None if m is None else G * m // bn)
    return (launch(1, G, c_tot, G, 0, n_layers),
            *(launch(3, G, G * (i + 1), G * n_layers, G * i, i or None)
              for i in reversed(range(n_layers))))


def dw_plan(n_layers: int) -> tuple:
    """The jobs of :func:`rdb_bwd_dw`'s one launch (W's pairs mode), in
    job order, which is :func:`pack`'s pair order: (layer i, chunk j),
    the buffer's chunk j against dout's chunk i, 64 -> 64 each."""
    return tuple((i, j) for i in range(n_layers) for j in range(i + 1))


def _layer_t(wtpk_l: torch.Tensor, i: int) -> torch.Tensor:
    """Layer i's transposed kernel from one block's wtpk (n_pairs, 3, 3,
    G, G0): (3, 3, G, (i + 1) G0), so that conv(dout_i, it) is the
    gradient of layer i's conv w.r.t. chunks 0..i."""
    p = n_pairs(i)
    return wtpk_l[p:p + i + 1].permute(1, 2, 3, 0, 4).reshape(
        3, 3, wtpk_l.shape[3], -1)


def rdn_fwd_plain(x, wpk, b, wf, bf, save: bool = False):
    """Plain version, rounding where ``_rdn_all_fwd_kernel`` does: each
    dense layer sums its input chunks in f32, adds the f32 bias, applies
    ReLU and rounds h to x's dtype into the block's buffer; the fusion
    takes wf against the buffer in f32 plus bf, and out = x.dtype(f32(x)
    + fused). Returns cat (B, H, W, D G0) and, with ``save``, the buffer
    stack (D, B, H, W, c_tot) (without it one buffer serves every
    block)."""
    d, n_layers, g0 = b.shape
    ws = unpack(wpk, n_layers)
    bsz, h, w, _ = x.shape
    bufs = x.new_empty((d if save else 1, bsz, h, w, wf.shape[1]))
    cat = x.new_empty((bsz, h, w, d * g0))
    xrun = x
    for l in range(d):
        buf = bufs[l if save else 0]
        buf[..., :g0] = xrun
        for i in range(n_layers):
            lo = g0 * (i + 1)
            buf[..., lo:lo + g0] = conv_f32(buf[..., :lo], ws[i][l],
                                            b[l, i]).clamp_min(0.0)
        fused = buf.float() @ wf[l].float() + bf[l].float()
        xrun = (xrun.float() + fused).to(x.dtype)
        cat[..., l * g0:(l + 1) * g0] = xrun
    return (cat, bufs) if save else cat


def rdb_bwd_chain_plain(bufs, l: int, g_run, ct, wtpk, wft):
    """Plain backward chain of block ``l``, rounding where
    ``_rdb_bwd_chain_kernel_sp`` does: gf = f32(g_run) + f32(ct's block
    slice), gc = gf in the buffer's dtype; dwf = buf^T gc, dbf = sum gf;
    dbuf = gc wf^T in f32; then per layer in reverse dout = (h > 0 ?
    dbuf_i : 0) on the stored h, db_i = sum dout in f32, doutb = dout
    rounded (saved), dbuf_0..i += convT(doutb); dx = bf16(dbuf_0 + gf).
    Returns dx (B, H, W, G0), dout (B, H, W, C G0), and the f32 dwf
    (c_tot, G0), dbf (G0,), db (C, G0)."""
    buf = bufs[l]
    dt = buf.dtype
    g0 = g_run.shape[-1]
    n_layers = buf.shape[-1] // g0 - 1
    gf = g_run.float() + ct[..., l * g0:(l + 1) * g0].float()
    gc = gf.to(dt)
    dwf = torch.einsum('bhwc,bhwo->co', buf.float(), gc.float())
    dbuf = gc.float() @ wft[l].float()
    dout = buf.new_empty((*g_run.shape[:3], n_layers * g0))
    db = gf.new_empty((n_layers, g0))
    for i in reversed(range(n_layers)):
        lo = g0 * (i + 1)
        d_i = torch.where(buf[..., lo:lo + g0].float() > 0,
                          dbuf[..., lo:lo + g0], 0.0)
        db[i] = d_i.sum((0, 1, 2))
        doutb = d_i.to(dt)
        dout[..., g0 * i:g0 * (i + 1)] = doutb
        dbuf[..., :lo] += conv_f32(doutb, _layer_t(wtpk[l], i))
    dx = (dbuf[..., :g0] + gf).to(dt)
    return dx, dout, dwf, gf.sum((0, 1, 2)), db


def rdb_bwd_dw_plain(bufs, l: int, dout):
    """Plain per-(layer, chunk) 3x3 weight grads of block ``l``
    (``_rdb_bwd_dw_kernel_sp``): layer i's grad on chunk j sums the
    bf16 doutb_i against chunk j of the bf16 buffer in f32. Returns
    (n_pairs, 3, 3, G0, G0) f32 in :func:`pack`'s pair order."""
    buf = bufs[l]
    g0 = buf.shape[-1] - dout.shape[-1]
    out = []
    for i in range(dout.shape[-1] // g0):
        dw = conv_wgrad_plain(buf[..., :g0 * (i + 1)],
                              dout[..., g0 * i:g0 * (i + 1)])[0]
        out.append(dw.reshape(3, 3, i + 1, g0, -1).permute(2, 0, 1, 3, 4))
    return torch.cat(out)


def _check(name: str, t: torch.Tensor) -> None:
    if t.device.type != 'cuda':
        raise ValueError(f'{name}: no kernel for device {t.device}')
    if t.shape[-1] != G:
        raise ValueError(f'{name}: no kernel for G0={t.shape[-1]}')


def rdn_fwd(x, wpk, b, wf, bf, save: bool = False):
    """As :func:`rdn_fwd_plain`. On CUDA: G0 = G = 64, bf16 activations
    and weights; one call is D (C + 1) launches of K2's engine
    (:func:`fwd_plan`) plus one copy of x into the first buffer (without
    ``save`` the blocks share one buffer, the fusion writing the next
    block's input in place). The registered operator ``srtpu::rdn_fwd``
    (:mod:`._library`)."""
    op = (torch.ops.srtpu.rdn_fwd.default
          if x.device.type in _build.OP_DEVICES else rdn_fwd_cuda)
    got = op(x, wpk, b, wf, bf, save)
    return tuple(got) if save else got[0]


def rdn_fwd_cuda(x, wpk, b, wf, bf, save: bool) -> list:
    """``srtpu::rdn_fwd`` on CUDA: the checks, the buffers, one
    ``srt_rdn_fwd`` call, the count."""
    _check('rdn_fwd', x)
    bsz, h, w, _ = x.shape
    d, n_layers, _ = b.shape
    c_tot = G * (n_layers + 1)
    dev = x.device
    bf16 = torch.bfloat16
    _build.expect(x, 'x', bf16, (bsz, h, w, G), dev)
    _build.expect(wpk, 'wpk', bf16, (d, n_pairs(n_layers), 3, 3, G, G), dev)
    _build.expect(b, 'b', torch.float32, (d, n_layers, G), dev)
    _build.expect(wf, 'wf', bf16, (d, c_tot, G), dev)
    _build.expect(bf, 'bf', torch.float32, (d, G), dev)
    bufs = torch.empty((d if save else 1, bsz, h, w, c_tot), dtype=bf16,
                       device=dev)
    cat = torch.empty((bsz, h, w, d * G), dtype=bf16, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().srt_rdn_fwd(
            x.data_ptr(), wpk.data_ptr(), b.data_ptr(), wf.data_ptr(),
            bf.data_ptr(), bufs.data_ptr(), cat.data_ptr(), int(save), bsz,
            h, w, d, n_layers, _build.stream(dev))
    _build.check(err, 'srt_rdn_fwd')
    rdn_fwd.launches += 1
    return [cat, bufs] if save else [cat]


def _tiles(bsz: int, h: int, w: int) -> int:
    """K2's engine's pixel tiles over the images."""
    return bsz * -(-h // TILE_H) * -(-w // TILE_W)


def _expect_bufs(bufs, l: int, dev):
    if bufs.dim() != 5 or not 0 <= l < bufs.shape[0]:
        raise ValueError(f'rdb_bwd: block {l} of bufs {tuple(bufs.shape)}')
    c_tot = bufs.shape[-1]
    if c_tot % G or c_tot < 2 * G:
        raise ValueError(f'rdb_bwd: no kernel for c_tot={c_tot}')
    _build.expect(bufs, 'bufs', torch.bfloat16, bufs.shape, dev)
    return c_tot // G - 1


def rdb_bwd_chain(bufs, l: int, g_run, ct, wtpk, wft):
    """As :func:`rdb_bwd_chain_plain`. On CUDA: G0 = 64, bf16 buffers,
    cotangents and weights; one call is C + 5 launches (gc and dbf's
    partials, dwf on W's engine (and its slots' sum where the split has
    them), the fusion's backward and one dx per layer on K2's engine
    (:func:`chain_plan`), the bias grads' reductions)."""
    if g_run.device.type == 'cpu':
        return rdb_bwd_chain_plain(bufs, l, g_run, ct, wtpk, wft)
    _check('rdb_bwd_chain', g_run)
    dev = g_run.device
    n_layers = _expect_bufs(bufs, l, dev)
    d, bsz, h, w, c_tot = bufs.shape
    bf16 = torch.bfloat16
    _build.expect(g_run, 'g_run', bf16, (bsz, h, w, G), dev)
    _build.expect(ct, 'ct', bf16, (bsz, h, w, d * G), dev)
    _build.expect(wtpk, 'wtpk', bf16, (d, n_pairs(n_layers), 3, 3, G, G),
                  dev)
    _build.expect(wft, 'wft', bf16, (d, G, c_tot), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    part = torch.empty((-(-bsz * h * w // FUSE_PIX)
                        + n_layers * _tiles(bsz, h, w)) * G, **f32)
    cluster, clusters = wgrad_parts(bsz, h, w, c_tot, G, 1, 1)
    ws_w, ws_b = wgrad_workspace(1, cluster, clusters, c_tot, G, 1, dev)
    dbuf = torch.empty((bsz, h, w, c_tot), **f32)
    gc = torch.empty_like(g_run)
    dx = torch.empty_like(g_run)
    dout = torch.empty((bsz, h, w, n_layers * G), dtype=bf16, device=dev)
    dwf = torch.empty((c_tot, G), **f32)
    dbf = torch.empty((G,), **f32)
    db = torch.empty((n_layers, G), **f32)
    with torch.cuda.device(dev):
        err = _build.library().srt_rdb_bwd_chain(
            bufs[l].data_ptr(), g_run.data_ptr(), ct.data_ptr(), l, d,
            wtpk[l].data_ptr(), wft[l].data_ptr(), dbuf.data_ptr(),
            gc.data_ptr(), part.data_ptr(), dout.data_ptr(), dx.data_ptr(),
            dwf.data_ptr(), dbf.data_ptr(), db.data_ptr(), ws_w.data_ptr(),
            ws_b.data_ptr(), bsz, h, w, n_layers, cluster, clusters,
            _build.stream(dev))
    _build.check(err, 'srt_rdb_bwd_chain')
    rdb_bwd_chain.launches += 1
    return dx, dout, dwf, dbf, db


def rdb_bwd_dw(bufs, l: int, dout):
    """As :func:`rdb_bwd_dw_plain`. On CUDA: G0 = 64, bf16; one call is
    one launch of W's engine over the n_pairs jobs of :func:`dw_plan`
    (and its slots' sum where the split, :func:`~.wgrad.wgrad_parts` of
    n_pairs jobs of 64 -> 64, has them)."""
    if dout.device.type == 'cpu':
        return rdb_bwd_dw_plain(bufs, l, dout)
    dev = dout.device
    if dev.type != 'cuda':
        raise ValueError(f'rdb_bwd_dw: no kernel for device {dev}')
    n_layers = _expect_bufs(bufs, l, dev)
    _, bsz, h, w, _ = bufs.shape
    _build.expect(dout, 'dout', torch.bfloat16, (bsz, h, w, n_layers * G),
                  dev)
    jobs = n_pairs(n_layers)
    cluster, clusters = wgrad_parts(bsz, h, w, G, G, 1, 3, jobs)
    ws = wgrad_workspace(jobs, cluster, clusters, G, G, 3, dev)[0]
    dw = torch.empty((jobs, 3, 3, G, G), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().srt_rdb_bwd_dw(
            bufs[l].data_ptr(), dout.data_ptr(), ws.data_ptr(),
            dw.data_ptr(), bsz, h, w, n_layers, cluster, clusters,
            _build.stream(dev))
    _build.check(err, 'srt_rdb_bwd_dw')
    rdb_bwd_dw.launches += 1
    return dw


def engine_conv(x, x_off: int, cin: int, w, pack: int, b, out,
                out_off: int, relu: bool = False) -> None:
    """K2's engine as :func:`rdn_fwd` runs it, on CUDA tensors, for the
    card tests: the 3x3 conv of x's channels [x_off, x_off + cin) (x (B,
    H, W, Cx) bf16, read at its pixel stride Cx) with w, one HWIO weight
    (pack 0: (3, 3, cin, cout)) or pairs (pack 1: a layer's pairs of
    :func:`pack`, (i + 1, 3, 3, 64, 64), K in 64-channel groups; 2: their
    transposed pairs, N in groups), plus b (cout,) f32 (ReLU with
    ``relu``), written in place into out's channels [out_off, out_off +
    cout) (out (B, H, W, Co) bf16)."""
    dev = x.device
    if dev.type != 'cuda':
        raise ValueError(f'engine_conv: no kernel for device {dev}')
    bsz, h, w_, cx = x.shape
    cout = b.shape[0]
    _build.expect(x, 'x', torch.bfloat16, x.shape, dev)
    _build.expect(out, 'out', torch.bfloat16, (bsz, h, w_, out.shape[-1]),
                  dev)
    _build.expect(b, 'b', torch.float32, (cout,), dev)
    w_shape = ((3, 3, cin, cout), (cin // G, 3, 3, G, cout),
               (cout // G, 3, 3, cin, G))[pack]
    _build.expect(w, 'w', torch.bfloat16, w_shape, dev)
    if (x_off % 8 or out_off % 8 or x_off + cin > cx
            or out_off + cout > out.shape[-1]):
        raise ValueError('engine_conv: channels outside x or out')
    with _build.on(dev):
        err = _build.library().srt_rdn_conv(
            x.data_ptr() + 2 * x_off, cx, w.data_ptr(), pack, b.data_ptr(),
            out.data_ptr() + 2 * out_off, out.shape[-1], bsz, h, w_, cin,
            cout, int(relu), _build.stream(dev))
    _build.check(err, 'srt_rdn_conv')
    engine_conv.launches += 1


rdn_fwd.launches = 0
rdb_bwd_chain.launches = 0
rdb_bwd_dw.launches = 0
engine_conv.launches = 0


def rdn_trunk_bwd(bufs, ct, wpk, wf, plain: bool = False):
    """Backward of the trunk (srtpu ``_rdn3_vjp_bwd``) from the saved
    buffers, the cotangent ct of cat and the forward's packed weights:
    blocks in reverse, each chain fed the running g and its slice of ct,
    then its weight grads. Returns dx and the f32 grads (dwpk (D,
    n_pairs, 3, 3, G0, G0), db (D, C, G0), dwf (D, c_tot, G0), dbf (D,
    G0))."""
    kernel = not plain and ct.device.type != 'cpu'
    chain = rdb_bwd_chain if kernel else rdb_bwd_chain_plain
    dw_fn = rdb_bwd_dw if kernel else rdb_bwd_dw_plain
    d, bsz, h, w, c_tot = bufs.shape
    g0 = wf.shape[-1]
    wtpk = w_t(wpk).contiguous()
    wft = wf.transpose(1, 2).contiguous()
    f32 = dict(dtype=torch.float32, device=ct.device)
    dwpk = torch.empty(wpk.shape, **f32)
    db = torch.empty((d, c_tot // g0 - 1, g0), **f32)
    dwf = torch.empty((d, c_tot, g0), **f32)
    dbf = torch.empty((d, g0), **f32)
    g = ct.new_zeros((bsz, h, w, g0))
    for l in reversed(range(d)):
        g, dout, dwf[l], dbf[l], db[l] = chain(bufs, l, g, ct, wtpk, wft)
        dwpk[l] = dw_fn(bufs, l, dout)
    return g, dwpk, db, dwf, dbf


def _cast(x, ws, bs, wf, bf):
    """The kernels' operands from the parameters (srtpu ``_rdn3_fwd``):
    dense and fusion weights in x's dtype (the dense ones packed),
    biases f32 and stacked."""
    wpk = pack([w.to(x.dtype) for w in ws])
    b = torch.stack([t.float() for t in bs], 1).contiguous()
    return (wpk, b, wf.to(x.dtype).contiguous(), bf.float().contiguous())


class RDNTrunkFn(torch.autograd.Function):
    """Differentiable K6 trunk (srtpu ``rdn_trunk_cat_cs``): x, the
    fusion wf, bf, ``plain``, then the C dense weights and the C dense
    biases. f32 parameters in, cast inside; saves the buffer stack;
    returns f32 grads."""

    @staticmethod
    def forward(ctx, x, wf, bf, plain: bool, *wbs):
        n = len(wbs) // 2
        wpk, b, wfd, bff = _cast(x, wbs[:n], wbs[n:], wf, bf)
        cat, bufs = (rdn_fwd_plain if plain else rdn_fwd)(
            x, wpk, b, wfd, bff, save=True)
        ctx.save_for_backward(bufs, wpk, wfd)
        ctx.plain = plain
        ctx.dtypes = tuple(t.dtype for t in (wf, bf, *wbs))
        return cat

    @staticmethod
    def backward(ctx, ct):
        bufs, wpk, wfd = ctx.saved_tensors
        return _param_grads(ctx, *rdn_trunk_bwd(
            bufs, ct.contiguous(), wpk, wfd, ctx.plain))


def rdn_trunk(x, ws, bs, wf, bf, plain: bool = False) -> torch.Tensor:
    """The D dense blocks in x's dtype from f32 (or any) parameters: ws
    and bs the C per-layer stacks (D, 3, 3, (i + 1) G0, G0) and (D, G0),
    wf (D, c_tot, G0), bf (D, G0). Returns cat (B, H, W, D G0): the
    autograd op when a gradient is wanted, else the forward alone (one
    buffer, no saved stack). ``plain`` runs the plain versions on any
    device."""
    params = (wf, bf, *ws, *bs)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *params)):
        return RDNTrunkFn.apply(x, wf, bf, plain, *ws, *bs)
    return (rdn_fwd_plain if plain else rdn_fwd)(x, *_cast(x, ws, bs, wf, bf))


# ------------------------------------------- K9b: srtpu's 'calls' trunk

def _block_ops(wpk, b, wf, bf, l: int) -> tuple:
    """Block l's operands of the packed stacks, as (1, ...) slices."""
    return wpk[l:l + 1], b[l:l + 1], wf[l:l + 1], bf[l:l + 1]


def rdn_calls_fwd(x, wpk, b, wf, bf, plain: bool = False,
                  save: bool = True):
    """The D blocks one :func:`rdn_fwd` call each (srtpu ``_rdn2_fwd``)
    from :func:`_cast`'s operands: returns the D block outputs and, with
    ``save``, the D blocks' buffers, each (1, B, H, W, c_tot)."""
    fwd = rdn_fwd_plain if plain else rdn_fwd
    outs, bufs = [], []
    for l in range(b.shape[0]):
        ops = _block_ops(wpk, b, wf, bf, l)
        if save:
            x, buf = fwd(x, *ops, save=True)
            bufs.append(buf)
        else:
            x = fwd(x, *ops)
        outs.append(x)
    return (outs, bufs) if save else outs


def rdn_calls_bwd(bufs, cts, wpk, wf, plain: bool = False):
    """Backward of the 'calls' trunk (srtpu ``_rdn2_vjp_bwd``): blocks in
    reverse, each chain fed gl = bf16(f32(g) + f32(ct_l)), the running
    g and block l's output cotangent rounded once as srtpu rounds them
    (the grid form's chain adds them in f32 inside), then the block's
    pair weight grads in one call (srtpu splits its pairs into calls of
    ``_DW_PAIRS_PER_CALL`` for VMEM; each pair's sum is the same). cts:
    the D output cotangents (None for an unused output); bufs: the D
    blocks' buffers of :func:`rdn_calls_fwd`. Returns dx and the f32
    grads as :func:`rdn_trunk_bwd`."""
    kernel = not plain and bufs[0].device.type != 'cpu'
    chain = rdb_bwd_chain if kernel else rdb_bwd_chain_plain
    dw_fn = rdb_bwd_dw if kernel else rdb_bwd_dw_plain
    d = len(bufs)
    _, bsz, h, w, c_tot = bufs[0].shape
    g0 = wf.shape[-1]
    wtpk = w_t(wpk).contiguous()
    wft = wf.transpose(1, 2).contiguous()
    f32 = dict(dtype=torch.float32, device=bufs[0].device)
    dwpk = torch.empty(wpk.shape, **f32)
    db = torch.empty((d, c_tot // g0 - 1, g0), **f32)
    dwf = torch.empty((d, c_tot, g0), **f32)
    dbf = torch.empty((d, g0), **f32)
    zero = bufs[0].new_zeros((bsz, h, w, g0))
    g = zero
    for l in reversed(range(d)):
        ct = zero if cts[l] is None else cts[l]
        gl = (g.float() + ct.float()).to(zero.dtype).contiguous()
        g, dout, dwf[l], dbf[l], db[l] = chain(
            bufs[l], 0, gl, zero, wtpk[l:l + 1], wft[l:l + 1])
        dwpk[l] = dw_fn(bufs[l], 0, dout)
    return g, dwpk, db, dwf, dbf


class RDNCallsFn(torch.autograd.Function):
    """Differentiable K9b trunk (srtpu ``rdn_trunk_cs2``): arguments as
    :class:`RDNTrunkFn`'s; returns the D block outputs; saves the D
    blocks' buffers; f32 grads."""

    @staticmethod
    def forward(ctx, x, wf, bf, plain: bool, *wbs):
        n = len(wbs) // 2
        wpk, b, wfd, bff = _cast(x, wbs[:n], wbs[n:], wf, bf)
        outs, bufs = rdn_calls_fwd(x, wpk, b, wfd, bff, plain)
        ctx.save_for_backward(wpk, wfd, *bufs)
        ctx.plain = plain
        ctx.dtypes = tuple(t.dtype for t in (wf, bf, *wbs))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *cts):
        wpk, wfd, *bufs = ctx.saved_tensors
        dx, dwpk, db, dwf, dbf = rdn_calls_bwd(
            bufs, [None if c is None else c.contiguous() for c in cts], wpk,
            wfd, ctx.plain)
        return _param_grads(ctx, dx, dwpk, db, dwf, dbf)


def _param_grads(ctx, dx, dwpk, db, dwf, dbf) -> tuple:
    """The autograd grads of (x, wf, bf, plain, *ws, *bs) from the packed
    f32 grads, in the parameters' dtypes."""
    n = db.shape[1]
    grads = (dwf, dbf, *unpack(dwpk, n), *db.unbind(1))
    return (dx, grads[0].to(ctx.dtypes[0]), grads[1].to(ctx.dtypes[1]),
            None, *(g.to(t) for g, t in zip(grads[2:], ctx.dtypes[2:])))


def rdn_trunk_calls(x, ws, bs, wf, bf, plain: bool = False) -> tuple:
    """The D dense blocks in srtpu's 'calls' form, in x's dtype from f32
    (or any) parameters laid out as :func:`rdn_trunk`'s: returns the D
    block outputs (B, H, W, G0) (the autograd op when a gradient is
    wanted, else the forward alone). ``plain`` runs the plain versions
    on any device."""
    params = (wf, bf, *ws, *bs)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *params)):
        return RDNCallsFn.apply(x, wf, bf, plain, *ws, *bs)
    return tuple(rdn_calls_fwd(x, *_cast(x, ws, bs, wf, bf), plain,
                               save=False))


# ------------------------------------ K9c: srtpu's round-2 per-layer trunk

def rdn_layers_fwd(x, wsd, bsf, wfd, bff, plain: bool = False):
    """srtpu ``_rdn_fwd``: per block, each dense layer i one K2 launch
    with ReLU (``conv3x3_cs_fwd_stk``) on the concat so far, appended to
    it; the fusion a product rounded to x's dtype, plus its bias rounded
    to x's dtype, plus the block input, each add rounded (srtpu's bf16
    einsum and adds). wsd: the C per-layer HWIO stacks in x's dtype; bsf
    their f32 biases (D, G0); wfd (D, c_tot, G0) in x's dtype, bff (D,
    G0). Returns the D outputs and the D concat buffers."""
    conv = conv3x3_plain if plain else conv3x3_fwd
    dt = x.dtype
    outs, bufs = [], []
    for l in range(wfd.shape[0]):
        buf = x
        for w, b in zip(wsd, bsf):
            buf = torch.cat([buf, conv(buf, w[l], b[l], relu=True)], -1)
        fused = (buf.float() @ wfd[l].float()).to(dt) + bff[l].to(dt)
        x = fused + x
        outs.append(x)
        bufs.append(buf)
    return outs, bufs


def rdn_layers_bwd(bufs, cts, wsd, wfd, plain: bool = False):
    """srtpu ``_rdn_vjp_bwd`` from the saved buffers and the D output
    cotangents, with its roundings: g = g + ct_l in x's dtype; dwf and
    dbf f32 sums of g against the buffer; dbuf = g wf^T rounded to x's
    dtype; per layer in reverse the dout masked from the buffer, K2's
    backward (``conv3x3_cs_bwd_stk``) on the concat it read, its dx
    added into dbuf in x's dtype; the block's dx = dbuf's first G0
    channels + g in x's dtype. Returns dx, the per-layer f32 dW (D, 3,
    3, (i + 1) G0, G0) and db (D, G0), dwf (D, c_tot, G0), dbf (D, G0)."""
    bwd = conv3x3_bwd_plain if plain else conv3x3_bwd
    d, n_layers = len(bufs), len(wsd)
    g0 = wfd.shape[-1]
    dws = [[None] * d for _ in range(n_layers)]
    dbs = [[None] * d for _ in range(n_layers)]
    dwf, dbf = [None] * d, [None] * d
    g = bufs[0].new_zeros((*bufs[0].shape[:3], g0))
    for l in reversed(range(d)):
        if cts[l] is not None:
            g = g + cts[l]
        buf = bufs[l]
        gf, buff = g.float(), buf.float()
        dwf[l] = torch.einsum('bhwc,bhwo->co', buff, gf)
        dbf[l] = gf.sum((0, 1, 2))
        dbuf = (gf @ wfd[l].float().t()).to(g.dtype)
        for i in reversed(range(n_layers)):
            lo = g0 * (i + 1)
            do = torch.where(buff[..., lo:lo + g0] > 0, dbuf[..., lo:lo + g0],
                             0.0).to(g.dtype).contiguous()
            dxp, dws[i][l], dbs[i][l] = bwd(buf[..., :lo].contiguous(),
                                            wsd[i][l], do)
            dbuf[..., :lo] += dxp
        g = dbuf[..., :g0] + g
    return (g, [torch.stack(t) for t in dws], [torch.stack(t) for t in dbs],
            torch.stack(dwf), torch.stack(dbf))


class RDNLayersFn(torch.autograd.Function):
    """Differentiable K9c trunk (srtpu ``rdn_trunk_cs``): arguments as
    :class:`RDNTrunkFn`'s; returns the D block outputs; saves the D
    concat buffers; f32 grads."""

    @staticmethod
    def forward(ctx, x, wf, bf, plain: bool, *wbs):
        n = len(wbs) // 2
        wsd = [w.to(x.dtype).contiguous() for w in wbs[:n]]
        bsf = [b.float().contiguous() for b in wbs[n:]]
        wfd = wf.to(x.dtype).contiguous()
        outs, bufs = rdn_layers_fwd(x, wsd, bsf, wfd, bf.float(), plain)
        ctx.save_for_backward(wfd, *wsd, *bufs)
        ctx.plain, ctx.n = plain, n
        ctx.dtypes = tuple(t.dtype for t in (wf, bf, *wbs))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *cts):
        wfd, *rest = ctx.saved_tensors
        wsd, bufs = rest[:ctx.n], rest[ctx.n:]
        dx, dws, dbs, dwf, dbf = rdn_layers_bwd(
            bufs, [None if c is None else c.contiguous() for c in cts], wsd,
            wfd, ctx.plain)
        grads = (dwf, dbf, *dws, *dbs)
        return (dx, grads[0].to(ctx.dtypes[0]), grads[1].to(ctx.dtypes[1]),
                None, *(g.to(t) for g, t in zip(grads[2:], ctx.dtypes[2:])))


def rdn_trunk_layers(x, ws, bs, wf, bf, plain: bool = False) -> tuple:
    """The D dense blocks in srtpu's round-2 per-layer form (K9c), in x's
    dtype from f32 (or any) parameters laid out as :func:`rdn_trunk`'s:
    returns the D block outputs (the autograd op when a gradient is
    wanted, else the forward alone). On CUDA every dense layer is a K2
    launch (G0 = 64: c_in 64 (i + 1) -> 64); ``plain`` runs K2's plain
    version on any device."""
    params = (wf, bf, *ws, *bs)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *params)):
        return RDNLayersFn.apply(x, wf, bf, plain, *ws, *bs)
    return tuple(rdn_layers_fwd(
        x, [w.to(x.dtype).contiguous() for w in ws],
        [b.float().contiguous() for b in bs], wf.to(x.dtype).contiguous(),
        bf.float(), plain)[0])
