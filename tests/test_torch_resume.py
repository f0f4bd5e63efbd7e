"""Crash, crash checkpoint and resume (``ckpt_path``) in the port's
``Trainer.fit`` on the CPU, and a resume from an srtpu training state.

(a) in the port, a tiny EDSR x4 (16 features, 2 resblocks, f32, with
    validation every 2 epochs): 4 uninterrupted epochs against 2 epochs,
    a step that raises at the start of epoch 3 (the crash checkpoint
    ``last`` is saved, the traceback is in ``run.log``, the error is
    raised on) and ``ckpt_path='last'`` from freshly drawn weights to
    epoch 4: the final parameters and the last val line bit for bit;
(b) srtpu trains its ``use_pallas='cs'`` EDSR (the CS-stacked trunk and
    the phase-major tail) 2 epochs and saves; srtpu's
    ``CheckpointManager`` restores that state, it is written as ``.npz``
    and converted (``python -m srtpu_torch.convert --state``), and the
    port resumes it for 2 epochs: its final params within 1e-4 of each
    tensor's largest magnitude of srtpu's uninterrupted 4 epochs;
(c) SRGAN (ngf = ndf = 16, 2 blocks; G, D, both optimizers and their
    schedules in the checkpoint), in the port only: as (a), bit for bit.
"""

import json

import jax
import numpy as np
import pytest
import torch

from srtpu.checkpoint import CheckpointManager as JaxCheckpointManager
from srtpu_torch import convert
from srtpu_torch.data import SRData
from srtpu_torch.models import create_model
from srtpu_torch.train import Trainer, TrainerConfig
from srtpu_torch.train import loop as loop_mod

from test_torch_fit_val import (KW, OPT, SEED, assert_params_close,
                                jax_fit, jax_initial, jsonl, write_sets)

torch.set_num_threads(1)

VAL = dict(check_val_every_n_epoch=2, num_sanity_val_steps=1, save_top_k=2)


def _crashing(monkeypatch, name, at_step):
    """``loop.<name>`` (a step factory) made to raise on the step whose
    state enters at ``at_step``, before the step does anything."""
    real = getattr(loop_mod, name)

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def crashing(state, lr, hr):
            if state.step == at_step:
                raise RuntimeError('planted fault')
            return step(state, lr, hr)
        return crashing
    monkeypatch.setattr(loop_mod, name, make)


def _fit(root, datasets, model, eval_sets=('Val',), **cfg):
    trainer = Trainer(TrainerConfig(default_root_dir=str(root), **cfg))
    try:
        trainer.fit(model, SRData(
            datasets_dir=str(datasets), train_datasets=['Train'],
            eval_datasets=list(eval_sets), batch_size=2, patch_size=32,
            scale_factor=4, seed=SEED), losses='l1', optimizer_name='ADAM',
            optimizer_params=OPT)
    finally:
        trainer.close()
    return trainer


def _edsr(seed):
    return create_model('EDSR', generator=torch.Generator().manual_seed(
        seed), **KW)


def _crash_and_resume(tmp_path, monkeypatch, make, factory, at_step,
                      epochs=4):
    """The uninterrupted model, the resumed one, and their run roots."""
    datasets = write_sets(tmp_path)
    whole = make(0)
    _fit(tmp_path / 'whole', datasets, whole, max_epochs=epochs, **VAL)
    with monkeypatch.context() as m:
        _crashing(m, factory, at_step)
        with pytest.raises(RuntimeError, match='planted fault'):
            _fit(tmp_path / 'run', datasets, make(0), max_epochs=epochs,
                 **VAL)
    log = (tmp_path / 'run' / 'run.log').read_text()
    assert 'saving last checkpoint' in log and 'fit crashed' in log \
        and 'RuntimeError: planted fault' in log
    resumed = make(1)           # other weights: all must come from 'last'
    trainer = _fit(tmp_path / 'run', datasets, resumed, max_epochs=epochs,
                   ckpt_path='last', **VAL)
    assert trainer.global_step == epochs * 3
    return whole, resumed


def _same(a: torch.nn.Module, b: torch.nn.Module) -> None:
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_resume_in_port_is_bit_for_bit(tmp_path, monkeypatch):
    whole, resumed = _crash_and_resume(tmp_path, monkeypatch, _edsr,
                                       'make_train_step', at_step=6)
    _same(whole, resumed)
    want, got = jsonl(tmp_path / 'whole'), jsonl(tmp_path / 'run')
    assert got[-1] == want[-1] and 'Val/PSNR' in got[-1]


def _npz(path, tree):
    def key(k):
        return str(getattr(k, 'key', getattr(k, 'name', getattr(k, 'idx',
                                                                   k))))
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    np.savez(path, **{'/'.join(key(k) for k in p): np.asarray(v)
                      for p, v in flat})


def test_resume_from_srtpu_state(tmp_path):
    from srtpu.checkpoint import _state_to_tree
    datasets = write_sets(tmp_path)
    jm, state0 = jax_initial(use_pallas='cs')
    cfg = dict(num_sanity_val_steps=0)
    ref = jax_fit(tmp_path / 'jax4', datasets, jm, state0, max_epochs=4,
                  **cfg)
    jax_fit(tmp_path / 'jax2', datasets, jm, state0, max_epochs=2, **cfg)
    mngr = JaxCheckpointManager(tmp_path / 'jax2' / 'checkpoints',
                                monitor='')
    try:
        state2 = mngr.restore_last(state0)
    finally:
        mngr.close()
    assert int(state2.step) == 6
    _npz(tmp_path / 'state.npz', _state_to_tree(state2))
    hp = {'model': 'EDSR', 'init_args': dict(KW, use_pallas='cs',
                                             scale_factor=4, channels=3),
          'data': {'scale_factor': 4}, 'optimizer': 'ADAM',
          'optimizer_params': OPT, 'precision': '32', 'monitor': None}
    (tmp_path / 'hp.json').write_text(json.dumps(hp))
    out = tmp_path / 'converted'
    assert convert.main(['--state', str(tmp_path / 'state.npz'), str(out),
                         '--hparams', str(tmp_path / 'hp.json')]) == 0
    assert json.loads((out / 'hparams.json').read_text()) == hp
    model = _edsr(1)
    trainer = _fit(tmp_path / 'port', datasets, model, eval_sets=(),
                   max_epochs=4, ckpt_path=str(out), **cfg)
    assert trainer.global_step == 12
    assert_params_close(model.state_dict(), ref.params)


def _srgan(seed):
    return create_model('SRGAN', ngf=16, ndf=16, n_blocks=2,
                        generator=torch.Generator().manual_seed(seed))


def test_srgan_resume_in_port_is_bit_for_bit(tmp_path, monkeypatch):
    whole, resumed = _crash_and_resume(tmp_path, monkeypatch, _srgan,
                                       'make_gan_train_step', at_step=6)
    _same(whole, resumed)
    state = torch.load(tmp_path / 'run' / 'checkpoints' / 'last' /
                       'state.pt', weights_only=True)
    assert set(state['opt_state']) == {'g', 'd'} and state['step'] == 12
    assert state['opt_state']['g']['schedule']['last_epoch'] == 12
