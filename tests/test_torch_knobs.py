"""srtpu's Trainer knobs in the port, on the CPU (the kernels' plain
versions), against srtpu where srtpu has the behaviour to hold:

* ``remat``: the train step under ``torch.utils.checkpoint`` gives the
  gradients and parameters of the step without it bit for bit (EDSR
  and RCAN, 2 blocks or groups, 16 features, bf16 compute on f32
  params); ``Trainer.fit`` takes it for EDSR and ignores it, as srtpu
  does, for SRResNet (batch norm) and in the GAN fit; 5 remat steps
  match srtpu's ``make_train_step(..., remat=True)`` within
  ``tests/test_torch_train.py``'s step tolerance (loss 1e-5 relative,
  params 1e-4 of each tensor's largest magnitude; f32, srtpu's XLA path);
* ``deterministic``: two fits are equal bit for bit; the weights come
  from seed 0 whatever ``--seed`` (and ``seed`` in a config) says, as
  srtpu's state does under its knob (two srtpu fits with seeds 0 and 7
  start from one state);
* ``detect_anomaly``: a NaN weight raises ``FloatingPointError`` in
  srtpu's fit (``jax_debug_nans``, reset after) and in the port's, naming
  the module; a NaN that shows only in the backward raises it too; off,
  no hook is installed and the fit runs through;
* ``profiler_dir``: the fit writes a trace that names the ``srtpu::``
  operators;
* the run assets: ``model_summary.txt``, ``source_snapshot.zip`` and
  ``model_graph.txt`` in the root and in ``assets.json``; a failure there
  is a warning, and training goes on.
"""

import json
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srtpu.losses import parse_losses as jax_parse_losses
from srtpu.train import Trainer as JaxTrainer
from srtpu.train import TrainerConfig as JaxTrainerConfig
from srtpu.train import make_train_step as jax_make_train_step
from srtpu_torch import cli
from srtpu_torch.data import SRData
from srtpu_torch.losses import parse_losses
from srtpu_torch.models import create_model
from srtpu_torch.optim import build_optimizer
from srtpu_torch.train import Trainer, TrainerConfig, TrainState
from srtpu_torch.train import loop as loop_mod
from srtpu_torch.train import make_train_step

from test_torch_fit_val import KW, OPT, SEED, write_sets
from test_torch_train import (_assert_params_close, _batches, _jax_state,
                              _port_state)

torch.set_num_threads(1)

MODELS = {'EDSR': dict(n_feats=16, n_resblocks=2),
          'RCAN': dict(n_feats=16, n_resgroups=2, n_resblocks=2,
                       reduction=4),
          'SRResNet': dict(n_feats=16, n_resblocks=2),
          'SRGAN': dict(ngf=16, ndf=8, n_blocks=2)}


def _model(name, seed=0, dtype=torch.bfloat16):
    return create_model(name, scale_factor=4, dtype=dtype,
                        generator=torch.Generator().manual_seed(seed),
                        **MODELS[name])


def _dm(datasets, **kw):
    return SRData(datasets_dir=str(datasets), train_datasets=['Train'],
                  batch_size=2, patch_size=32, scale_factor=4, seed=SEED,
                  **kw)


def _fit(root, datasets, model, eval_sets=(), **cfg):
    trainer = Trainer(TrainerConfig(default_root_dir=str(root),
                                    num_sanity_val_steps=0, **cfg))
    try:
        trainer.fit(model, _dm(datasets, eval_datasets=list(eval_sets)),
                    optimizer_params=OPT)
    finally:
        trainer.close()
    return trainer


# --------------------------------------------------------------- remat

@pytest.mark.parametrize('name', ['EDSR', 'RCAN'])
def test_remat_step_is_the_plain_step_bit_for_bit(name):
    batches = list(_batches(2, 2, 8, 4, seed=1))
    states = {}
    for remat in (False, True):
        model = _model(name)
        states[remat] = (make_train_step(parse_losses('l1'), remat=remat),
                         TrainState(model, build_optimizer(
                             'ADAM', OPT, model.parameters())))
    for i, (lr, hr) in enumerate(batches):
        logs = {remat: step(st, torch.from_numpy(lr), torch.from_numpy(hr))
                for remat, (step, st) in states.items()}
        assert torch.equal(logs[False]['loss'], logs[True]['loss'])
        if i == 0:
            grads = [{n: p.grad for n, p in st.model.named_parameters()}
                     for _, st in states.values()]
            for n, g in grads[0].items():
                assert torch.equal(g, grads[1][n]), n
    a, b = (st.model.state_dict() for _, st in states.values())
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize('name,taken', [('EDSR', True), ('SRResNet', False),
                                        ('SRGAN', False)])
def test_fit_takes_remat_where_srtpu_does(tmp_path, monkeypatch, name,
                                          taken):
    """srtpu remats the forward of a model without batch statistics, and
    never in its GAN fit."""
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(torch.utils.checkpoint, 'checkpoint', counted)
    datasets = write_sets(tmp_path, n_train=2)
    trainer = _fit(tmp_path / 'run', datasets, _model(name), max_epochs=2,
                   remat=True)
    assert trainer.global_step == 2
    assert len(calls) == (2 if taken else 0)


def test_remat_step_matches_srtpu_remat_step():
    batches = list(_batches(5, 2, 8, 4, seed=4))
    jstate = _jax_state(4, None, batches[0][0], seed=8)
    pstate = _port_state(4, jstate.params, None)
    jstep = jax_make_train_step(jax_parse_losses('l1'), donate=False,
                                remat=True)
    pstep = make_train_step(parse_losses('l1'), remat=True)
    for lr, hr in batches:
        jstate, jlogs = jstep(jstate, jnp.asarray(lr), jnp.asarray(hr))
        plogs = pstep(pstate, torch.from_numpy(lr), torch.from_numpy(hr))
        np.testing.assert_allclose(float(plogs['loss']), float(jlogs['loss']),
                                   rtol=1e-5)
    _assert_params_close(pstate.model, jstate.params)


# ------------------------------------------------------- deterministic

def test_deterministic_fits_are_equal(tmp_path):
    datasets = write_sets(tmp_path, n_train=4)
    models = [_model('EDSR', seed=2) for _ in range(2)]
    for i, model in enumerate(models):
        _fit(tmp_path / f'run{i}', datasets, model, max_epochs=2,
             deterministic=True)
    a, b = (m.state_dict() for m in models)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.are_deterministic_algorithms_enabled()


@pytest.mark.parametrize('deterministic', [False, True])
def test_deterministic_draws_the_weights_from_seed_0(tmp_path,
                                                     deterministic):
    """``fit --deterministic true --seed 7`` (and ``trainer.deterministic``
    in a config) draws the model from seed 0, its loader from seed 7."""
    from srtpu_torch.config import build_all, load_config
    datasets = write_sets(tmp_path, n_train=2)
    args = cli.build_parser().parse_args(
        ['fit', '--train_datasets', 'Train', '--datasets_dir',
         str(datasets), '--n_feats', '16', '--n_resblocks', '2', '--seed',
         '7', '--device', 'cpu', '--deterministic', str(deterministic)])
    model, dm, tcfg, _ = cli._flag_config(args)
    cfg = load_config(None, [
        'model.class_path=EDSR', 'model.init_args.n_feats=16',
        'model.init_args.n_resblocks=2', 'seed=7',
        f'trainer.deterministic={deterministic}'])
    from_config = build_all(cfg)[0]
    want = create_model('EDSR', scale_factor=4, dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(
                            0 if deterministic else 7),
                        n_feats=16, n_resblocks=2).state_dict()
    assert tcfg.deterministic == deterministic and dm.seed == 7
    for k, v in want.items():
        assert torch.equal(model.state_dict()[k], v), k
        assert torch.equal(from_config.state_dict()[k], v), k


def test_srtpu_deterministic_state_comes_from_seed_0(tmp_path):
    """srtpu's own rule, which the port's draw follows: under
    ``deterministic`` its state does not depend on ``seed``."""
    from srtpu.data import SRData as JaxSRData
    from srtpu.models import create_model as jax_create_model
    datasets = write_sets(tmp_path, n_train=2)
    params = {}
    for seed, det in ((0, True), (7, True), (7, False)):
        trainer = JaxTrainer(JaxTrainerConfig(
            default_root_dir=str(tmp_path / f'j{seed}{det}'), seed=seed,
            deterministic=det, fast_dev_run=True, num_sanity_val_steps=0))
        try:
            state = trainer.fit(
                jax_create_model('EDSR', scale_factor=4, **KW),
                JaxSRData(batch_size=2, datasets_dir=str(datasets),
                          patch_size=32, scale_factor=4,
                          train_datasets=['Train'], eval_datasets=['Val'],
                          seed=SEED, num_workers=1), losses='l1',
                optimizer_params=OPT)
        finally:
            trainer.close()
        params[seed, det] = jax.tree_util.tree_leaves(state.params)
    same = [np.array_equal(a, b) for a, b in zip(params[0, True],
                                                 params[7, True])]
    other = [np.array_equal(a, b) for a, b in zip(params[0, True],
                                                  params[7, False])]
    assert all(same) and not all(other)


# ------------------------------------------------------ detect_anomaly

def _nan_model(name='EDSR'):
    model = _model(name, dtype=None)
    with torch.no_grad():
        model.head.weight[0, 0, 0, 0] = float('nan')
    return model


def test_nan_raises_in_srtpu_and_in_the_port(tmp_path):
    from srtpu.data import SRData as JaxSRData
    from test_torch_fit_val import jax_initial
    datasets = write_sets(tmp_path, n_train=2)
    jm, state = jax_initial()
    params = jax.tree_util.tree_map(lambda a: a, state.params)
    params['Conv2d_0']['kernel'] = params['Conv2d_0']['kernel'].at[
        0, 0, 0, 0].set(jnp.nan)
    trainer = JaxTrainer(JaxTrainerConfig(
        default_root_dir=str(tmp_path / 'jax'), detect_anomaly=True,
        max_epochs=1, num_sanity_val_steps=0))
    try:
        with pytest.raises(FloatingPointError):
            trainer.fit(jm, JaxSRData(
                batch_size=2, datasets_dir=str(datasets), patch_size=32,
                scale_factor=4, train_datasets=['Train'],
                eval_datasets=['Val'], seed=SEED, num_workers=1),
                losses='l1', optimizer_params=OPT,
                state=state.replace(params=params))
    finally:
        trainer.close()
        jax.config.update('jax_debug_nans', False)
    with pytest.raises(FloatingPointError, match='forward output of head'):
        _fit(tmp_path / 'port', datasets, _nan_model(), max_epochs=1,
             detect_anomaly=True)


def test_nan_in_the_backward_raises(tmp_path, monkeypatch):
    """A loss whose forward is finite and whose gradient is NaN: the
    forward hooks pass it, autograd's anomaly mode names the node."""
    from srtpu_torch import losses as losses_mod
    real = losses_mod.parse_losses

    def nan_grad(dsl):
        composite = real(dsl)

        def loss(sr, hr):
            total, parts = composite(sr, hr)
            total = total + 0.0 * torch.sqrt(sr - sr).sum()   # d/dx: NaN
            return total, parts
        loss.names = composite.names
        return loss
    monkeypatch.setattr(loop_mod, 'parse_losses', nan_grad)
    datasets = write_sets(tmp_path, n_train=2)
    with pytest.raises(FloatingPointError, match='NaN in the backward'):
        _fit(tmp_path / 'run', datasets, _model('EDSR', dtype=None),
             max_epochs=1, detect_anomaly=True)


def test_anomaly_off_installs_nothing(tmp_path):
    datasets = write_sets(tmp_path, n_train=2)
    model = _nan_model()
    trainer = _fit(tmp_path / 'run', datasets, model, max_epochs=1)
    assert trainer.global_step == 1
    assert not any(m._forward_hooks for m in model.modules())


# ------------------------------------------------ profiler and assets

def test_profiler_dir_writes_a_trace(tmp_path):
    datasets = write_sets(tmp_path, n_train=2)
    _fit(tmp_path / 'run', datasets, _model('EDSR'), max_epochs=1,
         profiler_dir=str(tmp_path / 'prof'))
    traces = list((tmp_path / 'prof').glob('*.pt.trace.json'))
    assert len(traces) == 1
    text = traces[0].read_text()
    for op in ('srtpu::trunk_fwd', 'srtpu::conv_fwd', 'srtpu::upsample_fwd'):
        assert op in text, op


def test_run_assets_are_written(tmp_path):
    datasets = write_sets(tmp_path, n_train=2)
    model = _model('EDSR')
    _fit(tmp_path / 'run', datasets, model, max_epochs=1)
    root = tmp_path / 'run'
    summary = (root / 'model_summary.txt').read_text().splitlines()
    n = len(list(model.named_parameters()))
    total = sum(p.numel() for p in model.parameters())
    assert summary[0] == 'model: EDSR' and len(summary) == n + 4
    assert summary[2].startswith('head.weight') and \
        summary[-1].startswith(f'total parameters: {total:,}')
    names = zipfile.ZipFile(root / 'source_snapshot.zip').namelist()
    assert {'srtpu_torch/train/loop.py', 'srtpu_torch/ops/_library.py',
            'srtpu_torch/ops/csrc/conv.cu'} <= set(names)
    graph = (root / 'model_graph.txt').read_text()
    for op in ('srtpu.trunk_fwd', 'srtpu.conv_fwd', 'srtpu.upsample_fwd'):
        assert op in graph, op
    assets = json.loads((root / 'assets.json').read_text())
    for name in ('model_summary.txt', 'source_snapshot.zip',
                 'model_graph.txt'):
        assert str(root / name) in assets


def test_run_asset_failure_is_a_warning(tmp_path, monkeypatch, caplog):
    import srtpu_torch.export as export_mod

    def broken(*args, **kwargs):
        raise RuntimeError('planted export fault')
    monkeypatch.setattr(export_mod, 'export_serving', broken)
    datasets = write_sets(tmp_path, n_train=2)
    trainer = _fit(tmp_path / 'run', datasets, _model('EDSR'), max_epochs=1)
    assert trainer.global_step == 1
    assert 'run-asset logging failed' in caplog.text
    assert (tmp_path / 'run' / 'model_summary.txt').is_file()
