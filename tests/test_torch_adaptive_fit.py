"""The trainable adaptive loss in ``Trainer.fit``, its state and
checkpoints, and the losses without a gradient, against srtpu on the
CPU: a tiny EDSR x4 (16 features, 2 resblocks, f32; srtpu on its XLA
path, the port on the kernels' plain versions) from the same initial
weights, on the same .npy sets (10 train images of 64 x 80, batch 2,
patch 32: 5 steps an epoch; 2 eval images, one bucket-padded).

* ``0.5 * l1 + 0.5 * adaptive``, 5 steps (one epoch), with and without
  ``gradient_clip_val`` (small enough that every step clips, the norm
  over the model's and the loss's gradients): each step's loss within
  1e-4 relative, the model's parameters and the loss's latents within
  1e-4 of each tensor's largest magnitude;
* the checkpoint holds ``loss_params`` and their Adam state; a crash
  and ``ckpt_path='last'`` give the uninterrupted run bit for bit;
  ``state_from_jax`` carries srtpu's ``loss_params`` and their moments,
  and the port resumes srtpu's state to srtpu's uninterrupted result;
  a checkpoint without ``loss_params`` loads for a DSL without a
  trainable loss, and refuses one that has it;
* ``--losses edge_loss`` alone: srtpu applies zero gradients, so the
  parameters stay as they were bit for bit and Adam's count moves to 5,
  as in srtpu's state; with ``edge_loss`` and ``pencil_sketch`` in the
  DSL and val images, the ``_edges`` and ``_sketch`` PNGs srtpu writes.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srtpu.checkpoint import CheckpointManager as JaxCheckpointManager
from srtpu.data import SRData as JaxSRData
from srtpu.losses import parse_losses as jax_parse_losses
from srtpu.models import create_model as jax_create_model
from srtpu.optim import build_optimizer as jax_build_optimizer
from srtpu.train import Trainer as JaxTrainer
from srtpu.train import TrainerConfig as JaxTrainerConfig
from srtpu.train import create_train_state
from srtpu.train.loop import _clip_chain
from srtpu_torch import convert
from srtpu_torch.data import SRData
from srtpu_torch.train import Trainer, TrainerConfig

from test_torch_fit_val import (KW, OPT, SEED, assert_params_close,
                                port_model, write_sets)
from test_torch_resume import _crashing, _npz

torch.set_num_threads(1)

DSL = '0.5 * l1 + 0.5 * adaptive'
ONE_EPOCH = dict(max_epochs=1, num_sanity_val_steps=0, log_every_n_steps=1)
CASES = {'default': {}, 'clip_norm': dict(gradient_clip_val=0.02)}


def jax_state(losses=DSL, **cfg):
    """srtpu's tiny EDSR and its state with the DSL's loss parameters,
    Adam (OPT) under srtpu's clip chain for ``cfg``."""
    jm = jax_create_model('EDSR', scale_factor=4, use_pallas=False, **KW)
    tx = _clip_chain(jax_build_optimizer('ADAM', OPT),
                     JaxTrainerConfig(**cfg))
    state = create_train_state(jm, tx, jax.random.PRNGKey(3),
                               jnp.zeros((1, 8, 8, 3)),
                               jax_parse_losses(losses))
    return jm, state


def jax_run(root, datasets, jm, state, losses=DSL, **cfg):
    trainer = JaxTrainer(JaxTrainerConfig(default_root_dir=str(root),
                                          seed=SEED, **cfg))
    try:
        return trainer.fit(jm, JaxSRData(
            batch_size=2, datasets_dir=str(datasets), eval_datasets=['Val'],
            patch_size=32, scale_factor=4, train_datasets=['Train'],
            seed=SEED, num_workers=1), losses=losses, optimizer_name='ADAM',
            optimizer_params=OPT, state=state)
    finally:
        trainer.close()


def port_run(root, datasets, model, losses=DSL, **cfg):
    trainer = Trainer(TrainerConfig(default_root_dir=str(root), **cfg))
    try:
        return trainer.fit(model, SRData(
            datasets_dir=str(datasets), train_datasets=['Train'],
            eval_datasets=['Val'], batch_size=2, patch_size=32,
            scale_factor=4, seed=SEED), losses=losses, optimizer_name='ADAM',
            optimizer_params=OPT)
    finally:
        trainer.close()


def train_losses(root) -> dict[int, float]:
    return {r['step']: r['train/loss'] for r in (
        json.loads(ln) for ln in (root / 'metrics.jsonl').read_text()
        .splitlines()) if 'train/loss' in r}


def latents(loss_params) -> dict[str, np.ndarray]:
    """{'{i}_{name}.{latent}': array} of srtpu's or the port's."""
    if isinstance(loss_params, torch.nn.Module):
        return {k: v.detach().numpy() for k, v in
                loss_params.state_dict().items()}
    return {f'{k}.{n}': np.asarray(v) for k, sub in loss_params.items()
            for n, v in sub.items()}


def assert_latents_close(got, want, rel=1e-4):
    got, want = latents(got), latents(want)
    assert got.keys() == want.keys() == {'1_adaptive.latent_alpha',
                                         '1_adaptive.latent_scale'}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=rel * np.abs(want[k]).max(),
                                   err_msg=k)


@pytest.mark.parametrize('case', sorted(CASES))
def test_adaptive_fit_matches_srtpu(tmp_path, case):
    datasets = write_sets(tmp_path, n_train=10)
    cfg = {**ONE_EPOCH, **CASES[case]}
    jm, state0 = jax_state(**CASES[case])
    ref = jax_run(tmp_path / 'jax', datasets, jm, state0, **cfg)
    model = port_model(state0.params)
    state = port_run(tmp_path / 'port', datasets, model, **cfg)
    want, got = train_losses(tmp_path / 'jax'), train_losses(tmp_path /
                                                              'port')
    assert sorted(got) == sorted(want) == [1, 2, 3, 4, 5]
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]), (k, got, want)
    assert int(ref.step) == state.step == 5
    assert_params_close(model.state_dict(), ref.params)
    assert_latents_close(state.loss_params, ref.loss_params)
    # the latents moved, and are in the one optimizer with the model
    init = latents(jax_state()[1].loss_params)
    assert any(np.abs(v - init[k]).max() > 0
               for k, v in latents(state.loss_params).items())
    opt_params = {id(p) for g in state.optimizer.param_groups
                  for p in g['params']}
    assert all(id(p) in opt_params for p in state.loss_params.parameters())


def test_adaptive_checkpoint_and_resume(tmp_path, monkeypatch):
    """The checkpoint's loss_params and their Adam state; a crash at the
    start of epoch 2 (step 2) and ckpt_path='last' against the
    uninterrupted 2 epochs, bit for bit (model and latents)."""
    datasets = write_sets(tmp_path, n_train=4)
    _, state0 = jax_state()
    cfg = dict(max_epochs=2, num_sanity_val_steps=0)
    whole = port_model(state0.params)
    s_whole = port_run(tmp_path / 'whole', datasets, whole, **cfg)
    tree = torch.load(tmp_path / 'whole' / 'checkpoints' / 'last' /
                      'state.pt', weights_only=True)
    assert set(tree['loss_params']) == {'1_adaptive.latent_alpha',
                                        '1_adaptive.latent_scale'}
    opt = tree['opt_state']['model']['state']
    assert float(opt['loss_params.1_adaptive.latent_alpha']['step']) == 4
    with monkeypatch.context() as m:
        _crashing(m, 'make_train_step', 2)
        with pytest.raises(RuntimeError, match='planted fault'):
            port_run(tmp_path / 'run', datasets, port_model(state0.params),
                     **cfg)
    resumed = port_model(state0.params)
    s_res = port_run(tmp_path / 'run', datasets, resumed, ckpt_path='last',
                     **cfg)
    for k, v in whole.state_dict().items():
        assert torch.equal(v, resumed.state_dict()[k]), k
    for k, v in s_whole.loss_params.state_dict().items():
        assert torch.equal(v, s_res.loss_params.state_dict()[k]), k


def test_adaptive_state_from_jax(tmp_path):
    """srtpu trains 1 epoch, its state is converted (loss_params and the
    'loss' half of Adam's moments) and the port resumes it for a second:
    the model and latents within 1e-4 of srtpu's uninterrupted 2 epochs."""
    from srtpu.checkpoint import _state_to_tree
    datasets = write_sets(tmp_path, n_train=10)
    cfg = dict(num_sanity_val_steps=0)
    jm, state0 = jax_state()
    ref = jax_run(tmp_path / 'jax2', datasets, jm, state0, max_epochs=2,
                  **cfg)
    jax_run(tmp_path / 'jax1', datasets, jm, state0, max_epochs=1, **cfg)
    mngr = JaxCheckpointManager(tmp_path / 'jax1' / 'checkpoints',
                                monitor='')
    try:
        state1 = mngr.restore_last(state0)
    finally:
        mngr.close()
    _npz(tmp_path / 'state.npz', _state_to_tree(state1))
    tree = convert.state_from_jax(convert.load_npz(tmp_path / 'state.npz'))
    np.testing.assert_array_equal(
        tree['loss_params']['1_adaptive.latent_scale'].numpy(),
        np.asarray(state1.loss_params['1_adaptive']['latent_scale']))
    opt = tree['opt_state']['model']['state']
    mu = opt['loss_params.1_adaptive.latent_alpha']['exp_avg'].numpy()
    assert np.abs(mu).max() > 0 and float(
        opt['loss_params.1_adaptive.latent_alpha']['step']) == 5
    hp = {'model': 'EDSR', 'init_args': dict(KW, use_pallas=False,
                                             scale_factor=4, channels=3),
          'data': {'scale_factor': 4}, 'optimizer': 'ADAM',
          'optimizer_params': OPT, 'precision': '32', 'monitor': None,
          'losses': DSL}
    (tmp_path / 'hp.json').write_text(json.dumps(hp))
    out = tmp_path / 'converted'
    assert convert.main(['--state', str(tmp_path / 'state.npz'), str(out),
                         '--hparams', str(tmp_path / 'hp.json')]) == 0
    model = port_model(state0.params)
    state = port_run(tmp_path / 'port', datasets, model, max_epochs=2,
                     ckpt_path=str(out), **cfg)
    assert state.step == 10
    assert_params_close(model.state_dict(), ref.params)
    assert_latents_close(state.loss_params, ref.loss_params)


def test_checkpoint_without_loss_params(tmp_path):
    """A checkpoint written before the loss parameters existed (no
    ``loss_params`` entry) loads for an l1 run, and a run with a
    trainable loss refuses it, naming the losses."""
    from srtpu_torch.optim import build_optimizer
    from srtpu_torch.losses import parse_losses
    from srtpu_torch.train import TrainState, loss_parameters
    from srtpu_torch.train.state import state_to_tree, tree_to_state
    _, state0 = jax_state()
    model = port_model(state0.params)
    st = TrainState(model, build_optimizer('ADAM', OPT, model.parameters()))
    tree = state_to_tree(st)
    assert tree['loss_params'] == {}
    del tree['loss_params']
    tree_to_state(st, tree)
    lp = loss_parameters(parse_losses(DSL))
    st2 = TrainState(model, build_optimizer(
        'ADAM', OPT, list(model.parameters()) + list(lp.parameters())),
        loss_params=lp)
    with pytest.raises(ValueError, match='another --losses'):
        tree_to_state(st2, tree)


def test_edge_loss_alone_matches_srtpu(tmp_path):
    """No term carries a gradient: the parameters stay put bit for bit
    and Adam's count moves, in srtpu and the port."""
    datasets = write_sets(tmp_path, n_train=10)
    jm, state0 = jax_state('edge_loss')
    ref = jax_run(tmp_path / 'jax', datasets, jm, state0, 'edge_loss',
                  **ONE_EPOCH)
    model = port_model(state0.params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = port_run(tmp_path / 'port', datasets, model, 'edge_loss',
                     **ONE_EPOCH)
    assert_params_close(before, state0.params, rel=0)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for a, b in zip(jax.tree_util.tree_leaves(ref.params),
                    jax.tree_util.tree_leaves(state0.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    counts = [int(np.asarray(x)) for x in jax.tree_util.tree_leaves(
        ref.opt_state) if np.asarray(x).dtype.kind == 'i' and
        np.asarray(x).ndim == 0]
    assert 5 in counts
    steps = {float(s['step']) for s in state.optimizer.state.values()}
    assert steps == {5.0}
    want, got = train_losses(tmp_path / 'jax'), train_losses(tmp_path /
                                                              'port')
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4, (k, got[k], want[k])


def test_edge_and_sketch_val_images(tmp_path):
    """``edge_loss`` and ``pencil_sketch`` in the DSL with val images
    every epoch: the files srtpu writes (the SR, its _edges and _sketch
    maps, the HR's once per image and op; no centre crops under 96 px),
    the maps' PNGs within one 8-bit step of srtpu's."""
    from PIL import Image

    def decode_png(path):
        return np.asarray(Image.open(path))
    datasets = write_sets(tmp_path, n_train=2)
    dsl = '0.5 * l1 + 0.25 * edge_loss + 0.25 * pencil_sketch'
    jm, state0 = jax_state(dsl)
    cfg = dict(max_epochs=2, check_val_every_n_epoch=1,
               num_sanity_val_steps=0, save_results_from_epoch='all')
    jax_run(tmp_path / 'jax', datasets, jm, state0, dsl, **cfg)
    port_run(tmp_path / 'port', datasets, port_model(state0.params), dsl,
             **cfg)
    for name in ('000', '001'):
        want = sorted(p.name for p in (tmp_path / 'jax' / 'Val' / name)
                      .iterdir())
        got = sorted(p.name for p in (tmp_path / 'port' / 'Val' / name)
                     .iterdir())
        assert got == want
        assert 'epoch_00001_hr_edges.png' in got and \
            'epoch_00002_hr_sketch.png' not in got
        for f in got:
            if f.endswith(('edges.png', 'sketch.png')):
                a = decode_png(tmp_path / 'port' / 'Val' / name / f)
                b = decode_png(tmp_path / 'jax' / 'Val' / name / f)
                a, b = a.astype(int), b.astype(int)
                assert np.abs(a - b).max() <= 1, f
