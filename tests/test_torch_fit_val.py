"""``Trainer.fit`` with validation and checkpoints against srtpu's on the
CPU: a tiny EDSR x4 (16 features, 2 resblocks, f32; srtpu on its
``use_pallas=False`` XLA path, the port on the kernels' plain versions)
from the same initial weights (srtpu's init through
``srtpu_torch.convert``), on the same .npy train set (6 images of 64 x 80,
batch 2, patch 32: 3 steps an epoch) and eval set (2 images, one
bucket-padded), for 3 epochs with ``check_val_every_n_epoch=2``,
``num_sanity_val_steps=1`` and ``save_top_k=2``. Held:

* every ``metrics.jsonl`` line but the clock (the val passes' means and,
  at the last epoch, the per-image metrics with their images): the same
  keys and steps, each value within 1e-4;
* the epochs kept under ``checkpoints/top`` and ``last``;
* the final params within 1e-4 of each tensor's largest magnitude;
* the val images' files;

as cases of one test: the defaults, ``accumulate_grad_batches=2``
(optax's MultiSteps: 9 mini-steps, 4 updates), ``gradient_clip_val``
with ``norm`` and with ``value`` (small enough that every update
clips), and ``overfit_batches=1``. Plus the refusal of an unknown clip
algorithm, srtpu's ``ValueError``.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from srtpu.data import SRData as JaxSRData
from srtpu.models import create_model as jax_create_model
from srtpu.optim import build_optimizer as jax_build_optimizer
from srtpu.train import Trainer as JaxTrainer
from srtpu.train import TrainerConfig as JaxTrainerConfig
from srtpu.train import create_train_state
from srtpu.train.loop import _clip_chain
from srtpu_torch.convert import params_from_jax
from srtpu_torch.data import SRData
from srtpu_torch.models import create_model
from srtpu_torch.train import Trainer, TrainerConfig

torch.set_num_threads(1)

KW = dict(n_feats=16, n_resblocks=2)
OPT = ['lr=1e-3', 'eps=1e-4']
SEED = 5
BASE = dict(max_epochs=3, check_val_every_n_epoch=2, num_sanity_val_steps=1,
            save_top_k=2)
CASES = {'default': {}, 'accumulate2': dict(accumulate_grad_batches=2),
         'clip_norm': dict(gradient_clip_val=0.02),
         'clip_value': dict(gradient_clip_val=2e-4,
                            gradient_clip_algorithm='value'),
         'overfit1': dict(overfit_batches=1)}


def write_sets(root, n_train=6, seed=0):
    """Train (n_train HR 64 x 80) and Val (HR 64 x 80 and 72 x 56) .npy
    sets with their LR at X4; returns the datasets directory."""
    rng = np.random.default_rng(seed)
    for name, sizes in (('Train', [(64, 80)] * n_train),
                        ('Val', [(64, 80), (72, 56)])):
        hr_dir = root / 'datasets' / name / 'HR'
        lr_dir = root / 'datasets' / name / 'LR' / 'X4'
        hr_dir.mkdir(parents=True)
        lr_dir.mkdir(parents=True)
        for i, (h, w) in enumerate(sizes):
            lo = rng.random((h // 8 + 1, w // 8 + 1, 3))
            hr = (np.kron(lo, np.ones((8, 8, 1)))[:h, :w] * 0.8
                  + rng.random((h, w, 3)) * 0.2).astype(np.float32)
            np.save(hr_dir / f'{i:03d}.npy', hr)
            lr = hr.reshape(h // 4, 4, w // 4, 4, 3).mean((1, 3))
            np.save(lr_dir / f'{i:03d}.npy', lr.astype(np.float32))
    return root / 'datasets'


def jax_initial(use_pallas=False, seed=3, **cfg):
    """srtpu's tiny EDSR and its initial train state: Adam (OPT) wrapped
    as srtpu's ``fit`` wraps it for ``cfg`` (its clip chain, then
    MultiSteps; ``fit`` keeps the tx of a state it is given)."""
    jm = jax_create_model('EDSR', scale_factor=4, use_pallas=use_pallas,
                          **KW)
    tx = _clip_chain(jax_build_optimizer('ADAM', OPT),
                     JaxTrainerConfig(**cfg))
    if cfg.get('accumulate_grad_batches', 1) > 1:
        tx = optax.MultiSteps(tx, cfg['accumulate_grad_batches'])
    state = create_train_state(jm, tx, jax.random.PRNGKey(seed),
                               jnp.zeros((1, 8, 8, 3)))
    return jm, state


def tree_np(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  {'params': params})


def port_model(params):
    model = create_model('EDSR', scale_factor=4,
                         generator=torch.Generator().manual_seed(0), **KW)
    model.load_state_dict(params_from_jax(tree_np(params)))
    return model


def jax_fit(root, datasets, jm, state, **cfg):
    trainer = JaxTrainer(JaxTrainerConfig(default_root_dir=str(root),
                                          seed=SEED, **cfg))
    try:
        return trainer.fit(jm, JaxSRData(
            batch_size=2, datasets_dir=str(datasets), eval_datasets=['Val'],
            patch_size=32, scale_factor=4, train_datasets=['Train'],
            seed=SEED, num_workers=1), losses='l1', optimizer_name='ADAM',
            optimizer_params=OPT, state=state)
    finally:
        trainer.close()


def port_fit(root, datasets, model, **cfg):
    trainer = Trainer(TrainerConfig(default_root_dir=str(root), **cfg))
    try:
        return trainer.fit(model, SRData(
            datasets_dir=str(datasets), train_datasets=['Train'],
            eval_datasets=['Val'], batch_size=2, patch_size=32,
            scale_factor=4, seed=SEED), losses='l1', optimizer_name='ADAM',
            optimizer_params=OPT)
    finally:
        trainer.close()


def jsonl(root):
    lines = [json.loads(ln) for ln in
             (root / 'metrics.jsonl').read_text().splitlines()]
    for rec in lines:
        rec.pop('time')
    return lines


def kept(root):
    top = root / 'checkpoints' / 'top'
    return sorted(int(d.name) for d in top.iterdir())


def assert_params_close(got: dict, jax_params, rel=1e-4):
    want = params_from_jax(tree_np(jax_params))
    assert got.keys() == want.keys()
    for k, ref in want.items():
        np.testing.assert_allclose(got[k].numpy(), ref.numpy(), rtol=0,
                                   atol=rel * ref.abs().max().item(),
                                   err_msg=k)


@pytest.mark.parametrize('case', sorted(CASES))
def test_fit_with_val_matches_srtpu(tmp_path, case):
    datasets = write_sets(tmp_path)
    cfg = {**BASE, **CASES[case]}
    jm, state = jax_initial(**cfg)
    model = port_model(state.params)
    ref = jax_fit(tmp_path / 'jax', datasets, jm, state, **cfg)
    port_fit(tmp_path / 'port', datasets, model, **cfg)

    want, got = jsonl(tmp_path / 'jax'), jsonl(tmp_path / 'port')
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert any('Val/PSNR' in r for r in got)
    for g, w in zip(got, want):
        assert g['step'] == w['step']
        for k, v in w.items():
            assert abs(g[k] - v) <= 1e-4, (case, k, g[k], v)
    assert kept(tmp_path / 'port') == kept(tmp_path / 'jax')
    assert (tmp_path / 'port' / 'checkpoints' / 'last' / 'state.pt').is_file()
    for name in ('000', '001'):
        files = sorted(p.name for p in (tmp_path / 'jax' / 'Val' / name)
                       .iterdir())
        assert sorted(p.name for p in (tmp_path / 'port' / 'Val' / name)
                      .iterdir()) == files
    assert_params_close(model.state_dict(), ref.params)


def test_unknown_clip_algorithm_raises(tmp_path):
    datasets = write_sets(tmp_path, n_train=2)
    _, state = jax_initial()
    with pytest.raises(ValueError, match="'norm' or 'value'"):
        port_fit(tmp_path / 'port', datasets, port_model(state.params),
                 gradient_clip_val=1.0, gradient_clip_algorithm='l2')


def test_checkpoint_cli_round_trip(tmp_path, capsys, monkeypatch):
    """``fit`` through the CLI writes srtpu's snapshot (and runs
    ``$SRTPU_NOTIFY_CMD``); ``validate --checkpoint`` and ``predict
    --checkpoint`` rebuild the model from ``hparams.json`` alone: the
    kept epoch's val pass within 1e-6, and the PNGs of ``predict
    --weights`` on that state, byte for byte."""
    from srtpu_torch.cli import main
    note = tmp_path / 'notified'
    monkeypatch.setenv('SRTPU_NOTIFY_CMD', f'sh -c \'echo "$0" > {note}\'')
    datasets = write_sets(tmp_path, n_train=4)
    run = tmp_path / 'run'
    net = ['--n_feats', '16', '--n_resblocks', '2']
    assert main(['fit', '--datasets_dir', str(datasets), '--train_datasets',
                 'Train', '--eval_datasets', 'Val', '--batch_size', '2',
                 '--patch_size', '32', *net, '--max_epochs', '3',
                 '--check_val_every_n_epoch', '1', '--save_top_k', '1',
                 '--precision', '32', '--device', 'cpu', '--optimizer_params',
                 *OPT, '--default_root_dir', str(run)]) == 0
    assert note.read_text().startswith('srtpu_torch fit EDSR finished in')
    ckpts = run / 'checkpoints'
    hp = json.loads((ckpts / 'hparams.json').read_text())
    assert hp['model'] == 'EDSR' and hp['monitor'] == 'Val/PSNR'
    assert hp['init_args'] == {'scale_factor': 4, 'channels': 3, **KW}
    vals = {r['step'] // 2: r for r in jsonl(run) if 'Val/PSNR' in r}
    best = max(vals, key=lambda e: (vals[e]['Val/PSNR'], e))
    assert kept(run) == [best]
    assert main(['validate', '--checkpoint', str(ckpts), '--device', 'cpu',
                 '--default_root_dir', str(tmp_path / 'v'),
                 f'data.datasets_dir={datasets}']) == 0
    printed = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(': ')[0] for ln in printed] == ['Val/PSNR', 'Val/SSIM']
    got = jsonl(tmp_path / 'v')[-1]
    for k in ('Val/PSNR', 'Val/SSIM'):
        assert abs(got[k] - vals[best][k]) <= 1e-6, k
    state = torch.load(ckpts / 'top' / str(best) / 'state.pt',
                       weights_only=True)
    torch.save(state['model'], tmp_path / 'w.pt')
    pred = ['predict', '--datasets_dir', str(datasets), '--predict_datasets',
            'Val', '--device', 'cpu']
    assert main(pred + ['--checkpoint', str(ckpts), '--default_root_dir',
                        str(tmp_path / 'pc')]) == 0
    assert main(pred + ['--weights', str(tmp_path / 'w.pt'), *net,
                        '--precision', '32', '--default_root_dir',
                        str(tmp_path / 'pw')]) == 0
    names = sorted(p.name for p in (tmp_path / 'pw' / 'Val').iterdir())
    assert names and all((tmp_path / 'pc' / 'Val' / n).read_bytes()
                         == (tmp_path / 'pw' / 'Val' / n).read_bytes()
                         for n in names)
    with pytest.raises(ValueError, match='not both'):
        main(pred + ['--checkpoint', str(ckpts), '--weights',
                     str(tmp_path / 'w.pt')])


def test_trackers_match_srtpu(tmp_path, caplog):
    """metrics.jsonl, params.json and assets.json as srtpu's JSONL
    tracker writes them; a failing backend warns and never raises."""
    from srtpu.utils.tracking import MultiTracker as JaxMultiTracker
    from srtpu_torch.utils.tracking import MultiTracker
    trackers = {'jax': JaxMultiTracker(tmp_path / 'jax', None),
                'port': MultiTracker(tmp_path / 'port')}
    for t in trackers.values():
        t.params({'model': 'EDSR', 'init_args': KW})
        t.scalars({'Val/PSNR': 20.5, 'loss/l1': np.float32(0.25)}, 7)
        t.image('Val/a', np.zeros((4, 4, 3)), 7)
        t.asset(tmp_path / 'run.log')
        t.close()
    for name in ('params.json', 'assets.json'):
        assert (tmp_path / 'port' / name).read_text() == \
            (tmp_path / 'jax' / name).read_text()
    assert jsonl(tmp_path / 'port') == jsonl(tmp_path / 'jax')

    class Broken:
        def scalars(self, values, step):
            raise OSError('disk full')
    t = MultiTracker(tmp_path / 'broken')
    t._backends.append(Broken())
    t.scalars({'a': 1.0}, 0)
    t.close()
    assert 'tracker Broken.scalars failed' in caplog.text
    assert jsonl(tmp_path / 'broken') == [{'step': 0, 'a': 1.0}]


def test_comet_unavailable_warns_and_jsonl_stays(tmp_path, caplog,
                                                monkeypatch):
    """``COMET_API_KEY`` set but ``comet_ml`` not importable: one warning,
    and the always-on backends, TensorBoard and JSONL, are the only ones."""
    from srtpu_torch.utils.tensorboard import EventWriter
    from srtpu_torch.utils.tracking import JsonlTracker, MultiTracker
    monkeypatch.setenv('COMET_API_KEY', 'unused')
    monkeypatch.setitem(sys.modules, 'comet_ml', None)
    t = MultiTracker(tmp_path)
    t.scalars({'Val/PSNR': 20.5}, 3)
    t.close()
    assert [type(b) for b in t._backends] == [EventWriter, JsonlTracker]
    assert caplog.text.count('Comet tracking disabled') == 1
    assert jsonl(tmp_path) == [{'step': 3, 'Val/PSNR': 20.5}]
