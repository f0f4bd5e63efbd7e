"""``python -m srtpu_torch export`` (srtpu's ``export``) and the ``srtpu::``
operators on the CPU, where each operator runs its kernel's plain
version.

* every family (EDSR, RCAN, SRResNet, RDN-B, DDBPN, WDSR-B, SRCNN,
  SRGAN; EDSR's, RCAN's and WDSR-B's ``use_pallas=True`` routes; the
  XLA routes of SRResNet and DDBPN and RDN's config A, which hold no
  ``srtpu::`` operator) at 2 blocks or groups and 16-32 features (RDN
  at srtpu's configs B and A): a checkpoint written by the port, exported by
  the CLI with ``--device cpu``, loaded in this process with
  ``srtpu_torch.export.load``, equals the eager eval forward bit for
  bit, and holds the ``srtpu::`` operators the route launches on a card
  (the same nodes there);
* EDSR x4 against srtpu's own artifact (``srtpu.cli.cli_main(['export',
  ...])``, ``jax.export.deserialize(...).call``) from one srtpu
  checkpoint, converted with ``python -m srtpu_torch.convert --state``:
  the full-image forward within ``tests/test_cli.py``'s ``atol=5e-3``
  (both compute in bf16 and round at other places), the tiled one
  (``--tile 16 --tile-overlap 4``) within that file's seam bounds
  (``atol=2e-2``, mean below 2e-3) of srtpu's tiled artifact;
* each operator's fake implementation gives the plain version's output
  shapes and dtypes under ``FakeTensorMode``, for CPU and CUDA fake
  tensors (the card's saved stacks at the kernels' widths);
* ``--platforms`` takes one of ``cuda`` and ``cpu``: ``tpu`` and a list
  raise.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from srtpu_torch import cli, convert
from srtpu_torch.checkpoint import CheckpointManager
from srtpu_torch.export import ServingForward, load, srtpu_ops
from srtpu_torch.models import SRGAN, create_model
from srtpu_torch.optim import build_optimizer
from srtpu_torch.ops import _library
from srtpu_torch.train import TrainState, create_gan_state

torch.set_num_threads(1)

# name, model keywords, LR side, the srtpu:: nodes of the eval graph
FAMILIES = {
    'EDSR': ('EDSR', dict(n_feats=16, n_resblocks=2), 8,
             {'srtpu::trunk_fwd': 1, 'srtpu::conv_fwd': 3,
              'srtpu::upsample_fwd': 1}),
    'EDSR_TRUE': ('EDSR', dict(n_feats=16, n_resblocks=2, use_pallas=True),
                  8, {'srtpu::resblock_trunk_fwd': 1}),
    'RCAN': ('RCAN', dict(n_feats=16, n_resgroups=2, n_resblocks=2,
                          reduction=4), 8,
             {'srtpu::rcab_group_fwd': 2, 'srtpu::conv_fwd': 3}),
    'RCAN_TRUE': ('RCAN', dict(n_feats=16, n_resgroups=2, n_resblocks=2,
                               reduction=4, use_pallas=True), 8,
                  {'srtpu::ca_layer_fwd': 4}),
    'SRResNet': ('SRResNet', dict(n_feats=16, n_resblocks=2), 8,
                 {'srtpu::conv_fwd': 2, 'srtpu::upsample_fwd': 1}),
    'RDN': ('RDN', dict(rdn_config='B', growth0=64), 6,
            {'srtpu::rdn_fwd': 1, 'srtpu::conv_fwd': 2}),
    'DDBPN': ('DDBPN', dict(n0=32, nr=16, depth=2), 8,
              {'srtpu::conv_fwd': 11}),
    'WDSR': ('WDSR', dict(n_feats=16, n_resblocks=2, use_pallas='cs'), 8,
             {'srtpu::wdsr_trunk_fwd': 1}),
    'WDSR_TRUE': ('WDSR', dict(n_feats=16, n_resblocks=2, use_pallas=True),
                  8, {'srtpu::wdsr_block_fwd': 2}),
    'SRCNN': ('SRCNN', {}, 8, {}),
    'SRGAN': ('SRGAN', dict(ngf=16, ndf=8, n_blocks=2), 8, {}),
    # srtpu's XLA routes: stock ops, no srtpu:: operator
    'SRRESNET_FALSE': ('SRResNet', dict(n_feats=16, n_resblocks=2,
                                        use_pallas=False), 8, {}),
    'RDN_A': ('RDN', dict(rdn_config='A', growth0=64), 6, {}),
    'DDBPN_FALSE': ('DDBPN', dict(n0=32, nr=16, depth=2, use_pallas=False),
                    8, {}),
}


def _checkpoint(root, name: str, kw: dict, seed: int = 3):
    """A port checkpoint (``last`` and ``hparams.json``) of ``name`` drawn
    from ``seed``, bf16; returns the model."""
    model = create_model(name, scale_factor=4, dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(seed), **kw)
    if isinstance(model, SRGAN):
        state = create_gan_state(model)
    else:
        state = TrainState(model, build_optimizer('ADAM', [],
                                                  model.parameters()))
    hp = {'model': name, 'init_args': dict(kw, scale_factor=4),
          'data': {'scale_factor': 4}, 'precision': 'bf16', 'seed': seed}
    CheckpointManager(root, monitor='', hparams=hp).save(1, state, {})
    return model


@pytest.mark.parametrize('family', sorted(FAMILIES))
def test_export_cli_equals_eager(tmp_path, family, capsys):
    name, kw, side, nodes = FAMILIES[family]
    model = _checkpoint(tmp_path / 'ckpt', name, kw)
    out = tmp_path / 'model.pt2'
    graph = tmp_path / 'graph.txt'
    assert cli.main(['export', '--checkpoint', str(tmp_path / 'ckpt'),
                     '--out', str(out), '--size', f'{side}x{side}',
                     '--device', 'cpu', '--mlir', str(graph)]) == 0
    line = capsys.readouterr().out
    assert f'exported {name} x4: LR (1, {side}, {side}, 3)' in line
    program = load(out)
    assert srtpu_ops(program) == nodes
    for op in nodes:
        assert op.replace('srtpu::', 'srtpu.') in graph.read_text()
    lr = torch.from_numpy(np.random.default_rng(1).random(
        (1, side, side, 3), dtype=np.float32))
    got = program.module()(lr)
    with torch.no_grad():
        want = ServingForward(model.eval())(lr)
    assert got.shape == (1, 4 * side, 4 * side, 3)
    assert torch.equal(got, want)


def test_export_tiled_cli_equals_eager_tiled(tmp_path):
    model = _checkpoint(tmp_path / 'ckpt', 'EDSR', FAMILIES['EDSR'][1])
    out = tmp_path / 'tiled.pt2'
    assert cli.main(['export', '--checkpoint', str(tmp_path / 'ckpt'),
                     '--out', str(out), '--size', '20x28', '--tile', '12',
                     '--tile-overlap', '2', '--platforms', 'cpu']) == 0
    program = load(out)
    # 2 x 3 anchors, one batch of 6 tiles: one launch of each
    assert srtpu_ops(program) == FAMILIES['EDSR'][3]
    lr = torch.from_numpy(np.random.default_rng(2).random(
        (1, 20, 28, 3), dtype=np.float32))
    with torch.no_grad():
        want = ServingForward(model.eval(), tile=12, overlap=2)(lr)
    assert torch.equal(program.module()(lr), want)


# ------------------------------------------------ against srtpu's export

def _srtpu_checkpoint(tmp_path):
    """srtpu's checkpoint of a tiny bf16 EDSR x4 (its 'cs' route) with
    hparams.json, and the same state converted for the port."""
    from srtpu.checkpoint import CheckpointManager as JaxCheckpointManager
    from srtpu.checkpoint import _state_to_tree
    from srtpu.models import create_model as jax_create_model
    from srtpu.optim import build_optimizer as jax_build_optimizer
    from srtpu.train import create_train_state
    from test_torch_resume import _npz
    hp = {'model': 'EDSR', 'init_args': {'scale_factor': 4, 'n_feats': 16,
                                         'n_resblocks': 2,
                                         'use_pallas': 'cs'},
          'data': {'scale_factor': 4, 'patch_size': 32},
          'optimizer': 'ADAM', 'optimizer_params': [], 'precision': 'bf16',
          'monitor': None}
    jm = jax_create_model('EDSR', dtype=jnp.bfloat16, **hp['init_args'])
    state = create_train_state(jm, jax_build_optimizer('ADAM', []),
                               jax.random.PRNGKey(7),
                               jnp.zeros((1, 8, 8, 3)))
    # biases off their zero init, so that every parameter shows
    state = state.replace(params=jax.tree_util.tree_map(
        lambda a: a + 0.01 * jnp.sin(jnp.arange(a.size).reshape(a.shape)),
        state.params))
    jdir = tmp_path / 'jax' / 'checkpoints'
    mngr = JaxCheckpointManager(jdir, monitor='', hparams=hp)
    try:
        mngr.save(1, state, {})
    finally:
        mngr.close()
    _npz(tmp_path / 'state.npz', _state_to_tree(state))
    (tmp_path / 'hp.json').write_text(json.dumps(hp))
    pdir = tmp_path / 'port'
    assert convert.main(['--state', str(tmp_path / 'state.npz'), str(pdir),
                         '--hparams', str(tmp_path / 'hp.json')]) == 0
    return jdir, pdir


def test_export_matches_srtpu_artifact(tmp_path):
    from jax import export as jax_export
    from srtpu.cli import cli_main
    jdir, pdir = _srtpu_checkpoint(tmp_path)
    lr = np.random.default_rng(3).random((1, 32, 32, 3), dtype=np.float32)
    got, want = {}, {}
    for tile in (0, 16):
        extra = ['--tile', '16', '--tile-overlap', '4'] if tile else []
        jout, pout = tmp_path / f'm{tile}.jaxexp', tmp_path / f'm{tile}.pt2'
        assert cli_main(['export', '--checkpoint', str(jdir), '--out',
                         str(jout), '--batch', '1', '--size', '32x32',
                         *extra]) == 0
        assert cli.main(['export', '--checkpoint', str(pdir), '--out',
                         str(pout), '--size', '32x32', '--device', 'cpu',
                         *extra]) == 0
        want[tile] = np.asarray(jax_export.deserialize(
            jout.read_bytes()).call(jnp.asarray(lr)))
        with torch.no_grad():
            got[tile] = load(pout).module()(torch.from_numpy(lr)).numpy()
        assert got[tile].shape == want[tile].shape == (1, 128, 128, 3)
    np.testing.assert_allclose(got[0], want[0], atol=5e-3)
    np.testing.assert_allclose(got[16], want[16], atol=2e-2)
    assert float(np.abs(got[16] - want[16]).mean()) < 2e-3


# ------------------------------------------------- the fake implementations

def _operands(device: str):
    """Each operator's arguments at small shapes: (name, args, the plain
    version's outputs as the operator returns them)."""
    from srtpu_torch.ops import (ca_layer_plain, conv3x3_plain,
                                 resblock_trunk_plain, trunk_plain,
                                 upsample_plain)
    from srtpu_torch.ops.rcab import group_fwd_cpu
    from srtpu_torch.ops.rdn import n_pairs, rdn_fwd_plain
    from srtpu_torch.ops.wdsr import wdsr_trunk_plain
    from srtpu_torch.ops.wdsr_block import wdsr_block_fused_plain
    g = torch.Generator().manual_seed(0)

    def t(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g).to(dtype)
    f32 = torch.float32
    x, x16 = t(2, 5, 7, 64), t(2, 5, 7, 16)
    w, b = t(3, 3, 64, 64), t(64, dtype=f32)
    ws, bs = t(2, 3, 3, 64, 64), t(2, 64, dtype=f32)
    rc = [t(2, 3, 3, 64, 64), t(2, 64, dtype=f32), t(2, 3, 3, 64, 64),
          t(2, 64, dtype=f32), t(2, 64, 4, dtype=f32), t(2, 4, dtype=f32),
          t(2, 4, 64, dtype=f32), t(2, 64, dtype=f32)]
    rdn = [t(2, n_pairs(3), 3, 3, 64, 64), t(2, 3, 64, dtype=f32),
           t(2, 256, 64), t(2, 64, dtype=f32)]
    wd = [t(2, 16, 96), t(2, 96, dtype=f32), t(2, 96, 16), t(2, 16, dtype=f32),
          t(2, 3, 3, 16, 16), t(2, 16, dtype=f32)]
    wb = [a[0] for a in wd]
    ca = [a[0] for a in rc[4:8]]        # one gate's MLP
    w5, wu, bu = t(5, 5, 64, 32), t(3, 3, 64, 256), t(256, dtype=f32)
    ys = x.new_empty((2, *x.shape))
    cases = [
        ('conv_fwd', (x, w, b, True), [conv3x3_plain(x, w, b, True)]),
        ('conv_fwd', (x, w5, None, False), [conv3x3_plain(x, w5, None)]),
        ('trunk_fwd', (x, ws, bs, ws, bs, 1.0, False),
         [trunk_plain(x, ws, bs, ws, bs, 1.0)]),
        ('trunk_fwd', (x, ws, bs, ws, bs, 0.1, True),
         list(trunk_plain(x, ws, bs, ws, bs, 0.1, True))),
        ('upsample_fwd', (x, wu, bu, 2), [upsample_plain(x, wu, bu, 2)]),
        ('rcab_group_fwd', (x, *rc, None), group_fwd_cpu(x, *rc, None)),
        ('rcab_group_fwd', (x, *rc, ys), group_fwd_cpu(x, *rc, ys)),
        ('rdn_fwd', (x, *rdn, False), [rdn_fwd_plain(x, *rdn)]),
        ('rdn_fwd', (x, *rdn, True), list(rdn_fwd_plain(x, *rdn, True))),
        ('wdsr_trunk_fwd', (x16, *wd, 1.0, False),
         [wdsr_trunk_plain(x16, *wd, 1.0)]),
        ('wdsr_trunk_fwd', (x16, *wd, 1.0, True),
         list(wdsr_trunk_plain(x16, *wd, 1.0, True))),
        ('resblock_trunk_fwd', (x, ws, bs, ws, bs, 1.0, False),
         [resblock_trunk_plain(x, ws, bs, ws, bs, 1.0)]),
        ('resblock_trunk_fwd', (x, ws, bs, ws, bs, 1.0, True),
         list(resblock_trunk_plain(x, ws, bs, ws, bs, 1.0, True))),
        ('ca_layer_fwd', (x, *ca), [ca_layer_plain(x, *ca)]),
        ('wdsr_block_fwd', (x16, *wb, 1.0),
         [wdsr_block_fused_plain(x16, *wb, 1.0)]),
    ]
    if device == 'cuda':    # the card saves K7's stacks at its width, 64
        for name, args, outs in cases:
            if name == 'wdsr_trunk_fwd' and args[-1]:
                outs[1:] = [o.new_empty((*o.shape[:-1], 64)) for o in outs[1:]]
    return cases


@pytest.mark.parametrize('device', ['cpu', 'cuda'])
def test_fake_implementations_give_the_plain_shapes(device):
    cases = _operands(device)
    assert {name for name, _, _ in cases} == set(_library.NAMES)
    for name, args, want in cases:
        with FakeTensorMode():
            fake = [torch.empty(a.shape, dtype=a.dtype, device=device)
                    if torch.is_tensor(a) else a for a in args]
            got = _library.operator(name)(*fake)
        got = got if isinstance(got, list) else [got]
        assert [(tuple(g.shape), g.dtype, g.device.type) for g in got] == \
            [(tuple(w.shape), w.dtype, device) for w in want], name


def test_operators_on_the_cpu_are_the_plain_versions():
    """The CPU implementation of each operator is its plain version (and
    writes ``ys`` where it is handed one)."""
    for name, args, want in _operands('cpu'):
        got = _library.operator(name)(*args)
        got = got if isinstance(got, list) else [got]
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert torch.equal(g, w), name


@pytest.mark.parametrize('platforms', [['tpu'], ['cuda', 'cpu'],
                                       ['tpu', 'cpu']])
def test_platforms_takes_one_device(platforms):
    args = cli.build_parser().parse_args(
        ['export', '--checkpoint', 'c', '--out', 'o', '--platforms',
         *platforms])
    with pytest.raises(ValueError, match='one device|cuda .*or cpu'):
        cli.export_device(args)


def test_platforms_sets_the_device():
    parse = cli.build_parser().parse_args
    assert cli.export_device(parse(['export', '--checkpoint', 'c', '--out',
                                    'o', '--platforms', 'CPU'])) == 'cpu'
    assert cli.export_device(parse(['export', '--checkpoint', 'c', '--out',
                                    'o', '--device', 'cpu'])) == 'cpu'
    assert cli.export_device(parse(['export', '--checkpoint', 'c',
                                    '--out', 'o'])) == 'cuda'


def test_export_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this host has a card: the no-card error cannot show')
    _checkpoint(tmp_path / 'ckpt', 'SRCNN', {})
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        cli.main(['export', '--checkpoint', str(tmp_path / 'ckpt'), '--out',
                  str(tmp_path / 'm.pt2'), '--platforms', 'cuda'])
    assert not (tmp_path / 'm.pt2').exists()
