"""``steps_per_execution`` (srtpu's ``make_multi_train_step`` and its
window loop) in the port, on the CPU.

(a) the window loop against one step a dispatch in the port, bit for
    bit: k 2 and 3 on 5 batches an epoch (a remainder each epoch, run
    through the single step), 2 epochs: the parameters, the step count,
    the progress lines at srtpu's global-step cadence (at window
    boundaries) and each window's last loss; ``make_multi_train_step``
    alone against k single steps; ``fast_dev_run`` forces one step; the
    GAN fit takes the key and runs one step a dispatch; with
    ``detect_anomaly`` each window runs eagerly, with one warning;
(b) the port's ``fit`` at k 2 against srtpu's ``Trainer.fit`` at k 2 from
    the same initial weights (srtpu's init through
    ``srtpu_torch.convert``) on the same data: SRCNN on srtpu's own
    ``test_steps_per_execution_matches_single`` recipe and a tiny EDSR
    (srtpu's XLA path, the port's plain kernels), and the EDSR with
    ``accumulate_grad_batches`` 3: the final parameters within 1e-4 of
    each tensor's largest magnitude (test_torch_train.py's tolerance:
    the two sides sum in another order), the step count equal;
(c) a fit at k 2 stopped after its first epoch and resumed from its
    checkpoint equals the uninterrupted fit bit for bit, with Adam and
    with RangerVA;
(d) what a CUDA graph of the step cannot capture: every family's train
    step, on each of its routes, and every loss of the DSL read nothing
    from the device on the host (no ``item``, ``bool``, ``float``,
    ``tolist``, ``cpu``, boolean-mask indexing, ``nonzero``) and make no
    tensor from host data (``torch.tensor``) once warmed up: a
    ``TorchFunctionMode`` around the second step raises at the first.
"""

import logging
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.overrides import TorchFunctionMode

from srtpu.data import SRData as JaxSRData
from srtpu.models import create_model as jax_create_model
from srtpu.optim import build_optimizer as jax_build_optimizer
from srtpu.train import Trainer as JaxTrainer
from srtpu.train import TrainerConfig as JaxTrainerConfig
from srtpu.train import create_train_state
from srtpu_torch.convert import params_from_jax
from srtpu_torch.data import SRData
from srtpu_torch.losses import parse_losses
from srtpu_torch.models import create_model
from srtpu_torch.train import (Trainer, TrainerConfig, TrainState, Updater,
                               make_train_step)
from srtpu_torch.train.steps import make_multi_train_step

torch.set_num_threads(1)

KW = dict(n_feats=16, n_resblocks=2)
OPT = ['lr=1e-3', 'eps=1e-4']
SEED = 5


def write_sets(root, n_train=10, hr=(64, 80), scale=4, seed=0):
    """Train (``n_train`` HR images) and Val (2 images) .npy sets with
    their LR at ``scale``; returns the datasets directory."""
    rng = np.random.default_rng(seed)
    h, w = hr
    for name, n in (('Train', n_train), ('Val', 2)):
        hr_dir = root / 'datasets' / name / 'HR'
        lr_dir = root / 'datasets' / name / 'LR' / f'X{scale}'
        hr_dir.mkdir(parents=True)
        lr_dir.mkdir(parents=True)
        for i in range(n):
            lo = rng.random((h // 8 + 1, w // 8 + 1, 3))
            img = (np.kron(lo, np.ones((8, 8, 1)))[:h, :w] * 0.8
                   + rng.random((h, w, 3)) * 0.2).astype(np.float32)
            np.save(hr_dir / f'{i:03d}.npy', img)
            lr = img.reshape(h // scale, scale, w // scale, scale, 3)
            np.save(lr_dir / f'{i:03d}.npy', lr.mean((1, 3)))
    return root / 'datasets'


def port_model(name='EDSR', seed=0, **kw):
    return create_model(name, scale_factor=4,
                        generator=torch.Generator().manual_seed(seed),
                        **{**KW, **kw})


def port_fit(root, datasets, model, optimizer='ADAM', opt=OPT, scale=4,
             patch=32, eval_sets=(), **cfg):
    """(the final state, the trainer, the progress lines' global steps,
    the train losses the trackers got {step: loss})."""
    base = dict(max_epochs=2, num_sanity_val_steps=0,
                enable_checkpointing=False, log_weights_every_n_epochs=0,
                log_every_n_steps=2)
    trainer = Trainer(TrainerConfig(default_root_dir=str(root),
                                    **{**base, **cfg}))
    lines = []
    real = trainer._step_progress

    def progress(i, n_batches, items, t0, logs, keys):
        before = trainer._last_progress_step
        real(i, n_batches, items, t0, logs, keys)
        if trainer._last_progress_step != before:
            lines.append((trainer.global_step, float(logs['loss'])))
    trainer._step_progress = progress
    try:
        state = trainer.fit(model, SRData(
            datasets_dir=str(datasets), train_datasets=['Train'],
            eval_datasets=list(eval_sets), batch_size=2, patch_size=patch,
            scale_factor=scale, seed=SEED), losses='l1',
            optimizer_name=optimizer, optimizer_params=opt)
    finally:
        trainer.close()
    return state, trainer, lines


def assert_same_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for (_, st_a), (_, st_b) in zip(a.optimizer.state.items(),
                                    b.optimizer.state.items()):
        for k, v in st_a.items():
            if torch.is_tensor(v):
                assert torch.equal(v, st_b[k]), k
    assert a.step == b.step


# ------------------------------------------------- (a) the window loop

def _cadence(steps_per_epoch, epochs, k, n):
    """srtpu's progress steps: checked after each window (each batch at
    k 1), shown where the global step is ``n`` past the last shown."""
    out, step, last = [], 0, 0
    for _ in range(epochs):
        windows = steps_per_epoch // k if k > 1 else steps_per_epoch
        for _ in range(windows):
            step += k
            if step - last >= n:
                out.append(step)
                last = step
        step += steps_per_epoch - windows * k
    return out


@pytest.mark.parametrize('k', [2, 3])
def test_window_loop_equals_single_steps(tmp_path, k):
    data = write_sets(tmp_path)
    ref, tr1, lines1 = port_fit(tmp_path / 'k1', data, port_model())
    got, trk, linesk = port_fit(tmp_path / f'k{k}', data, port_model(),
                                steps_per_execution=k)
    assert tr1.global_step == trk.global_step == got.step == 10
    assert_same_state(ref, got)
    assert [s for s, _ in lines1] == _cadence(5, 2, 1, 2)
    assert [s for s, _ in linesk] == _cadence(5, 2, k, 2)
    # each window's last loss is the single step's at that step
    losses = dict(port_fit(tmp_path / 'all', data, port_model(),
                           log_every_n_steps=1)[2])
    assert all(loss == losses[s] for s, loss in linesk)


def test_make_multi_train_step_is_k_single_steps():
    gen = torch.Generator().manual_seed(1)
    lr, hr = torch.rand(3, 2, 8, 8, 3, generator=gen), \
        torch.rand(3, 2, 32, 32, 3, generator=gen)
    comp = parse_losses('l1')
    states = [TrainState.create(port_model(), comp, 'ADAM', OPT,
                                Updater(2)) for _ in range(2)]
    step = make_train_step(comp)
    for i in range(3):
        want = step(states[0], lr[i], hr[i])
    got = make_multi_train_step(comp, 3)(states[1], lr, hr)
    assert_same_state(states[0], states[1])
    assert torch.equal(got['loss'], want['loss'])
    assert states[1].updater.mini_step == 1
    with pytest.raises(ValueError, match=r'\(k, B, \.\.\.\)'):
        make_multi_train_step(comp, 2)(states[1], lr, hr)


def test_fast_dev_run_forces_one_step(tmp_path):
    data = write_sets(tmp_path)
    state, trainer, _ = port_fit(tmp_path / 'r', data, port_model(),
                                 steps_per_execution=4, fast_dev_run=True)
    assert trainer.global_step == state.step == 1


def test_gan_fit_takes_the_key(tmp_path):
    """srtpu's ``_fit_gan`` never reads ``steps_per_execution``: one step
    a dispatch, the same result as k 1."""
    data = write_sets(tmp_path, n_train=4)
    kw = dict(ngf=16, ndf=16, n_blocks=2)
    runs = []
    for k in (1, 2):
        m = create_model('SRGAN', scale_factor=4,
                         generator=torch.Generator().manual_seed(0), **kw)
        trainer = Trainer(TrainerConfig(
            default_root_dir=str(tmp_path / f'g{k}'), max_epochs=1,
            num_sanity_val_steps=0, enable_checkpointing=False,
            log_weights_every_n_epochs=0, steps_per_execution=k))
        try:
            trainer.fit(m, SRData(datasets_dir=str(data),
                                  train_datasets=['Train'], batch_size=2,
                                  patch_size=32, scale_factor=4, seed=SEED))
        finally:
            trainer.close()
        assert trainer.global_step == 2 and trainer.step_graph is None
        runs.append(m.state_dict())
    for key in runs[0]:
        assert torch.equal(runs[0][key], runs[1][key]), key


def test_detect_anomaly_runs_windows_eagerly_with_a_warning(tmp_path,
                                                           caplog):
    data = write_sets(tmp_path)
    ref = port_fit(tmp_path / 'k1', data, port_model(),
                   detect_anomaly=True)[0]
    with caplog.at_level(logging.WARNING, 'srtpu_torch.train.loop'):
        got = port_fit(tmp_path / 'k2', data, port_model(),
                       detect_anomaly=True, steps_per_execution=2)[0]
    warned = [r for r in caplog.records
              if 'steps_per_execution=2 with detect_anomaly' in r.message]
    assert len(warned) == 1 and 'CUDA graph' in warned[0].message
    assert_same_state(ref, got)


# ------------------------------------------------------ (b) vs srtpu

def _tree_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  tree)


def _jax_fit(root, datasets, jm, state, scale, patch, **cfg):
    trainer = JaxTrainer(JaxTrainerConfig(
        default_root_dir=str(root), seed=SEED, num_sanity_val_steps=0,
        enable_checkpointing=False, log_weights_every_n_epochs=0,
        check_val_every_n_epoch=5, **cfg))
    try:
        return trainer.fit(jm, JaxSRData(
            batch_size=2, datasets_dir=str(datasets), eval_datasets=['Val'],
            patch_size=patch, scale_factor=scale, train_datasets=['Train'],
            seed=SEED, num_workers=1), losses='l1', optimizer_name='ADAM',
            optimizer_params=OPT, state=state), trainer.global_step
    finally:
        trainer.close()


@pytest.mark.parametrize('name,scale,patch,acc', [
    ('SRCNN', 2, 16, 1), ('EDSR', 4, 32, 1), ('EDSR', 4, 32, 3)])
def test_fit_k2_matches_srtpu(tmp_path, name, scale, patch, acc):
    data = write_sets(tmp_path, n_train=8, hr=(48, 64), scale=scale)
    kw = {} if name == 'SRCNN' else dict(KW, use_pallas=False)
    jm = jax_create_model(name, scale_factor=scale, **kw)
    tx = jax_build_optimizer('ADAM', OPT)
    if acc > 1:
        tx = optax.MultiSteps(tx, acc)
    state = create_train_state(jm, tx, jax.random.PRNGKey(3),
                               jnp.zeros((1, 8, 8, 3)))
    model = create_model(name, scale_factor=scale,
                         generator=torch.Generator().manual_seed(0),
                         **({} if name == 'SRCNN' else KW))
    model.load_state_dict(params_from_jax(_tree_np({'params':
                                                    state.params})))
    cfg = dict(max_epochs=2, steps_per_execution=2,
               accumulate_grad_batches=acc)
    jstate, jsteps = _jax_fit(tmp_path / 'jax', data, jm, state, scale,
                              patch, **cfg)
    got, trainer, _ = port_fit(tmp_path / 'port', data, model, scale=scale,
                               patch=patch, eval_sets=['Val'],
                               check_val_every_n_epoch=5, **cfg)
    assert trainer.global_step == jsteps == int(jstate.step) == 8
    want = params_from_jax(_tree_np({'params': jstate.params}))
    for key, ref in want.items():
        np.testing.assert_allclose(
            got.model.state_dict()[key].numpy(), ref.numpy(), rtol=0,
            atol=1e-4 * ref.abs().max().item(), err_msg=key)


# ------------------------------------------------------- (c) resume

@pytest.mark.parametrize('optimizer', ['ADAM', 'RangerVA'])
def test_resume_with_k2_is_bit_for_bit(tmp_path, optimizer):
    data = write_sets(tmp_path)
    ckpt = dict(enable_checkpointing=True, check_val_every_n_epoch=1,
                steps_per_execution=2)
    whole = port_fit(tmp_path / 'whole', data, port_model(), optimizer,
                     **ckpt)[0]
    port_fit(tmp_path / 'cut', data, port_model(), optimizer,
             **{**ckpt, 'max_epochs': 1})
    resumed, trainer, _ = port_fit(tmp_path / 'cut', data, port_model(),
                                   optimizer, ckpt_path='last', **ckpt)
    assert trainer.global_step == 10
    assert_same_state(whole, resumed)


# ------------------------------------- (d) nothing a graph cannot take

HOST_READS = {'__bool__', '__float__', '__int__', '__index__', 'item',
              'tolist', 'numpy', 'cpu', 'nonzero', 'argwhere',
              'masked_select', 'unique', 'tensor', 'as_tensor'}


class HostReads(TorchFunctionMode):
    """Raise at a torch call a CUDA graph could not capture: a read of
    the device on the host, or a tensor made from host data. One read is
    let through: ``torch.optim.Adam``'s count, which the CPU keeps on the
    host by design (the card's Adam is ``capturable``: its count lives
    there and nothing reads it)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, '__name__', '')
        masked = name in ('__getitem__', '__setitem__') and any(
            torch.is_tensor(a) and a.dtype == torch.bool
            for a in (args[1] if isinstance(args[1], tuple)
                      else (args[1],)))
        caller = sys._getframe(1).f_code
        adam_count = name == 'item' and caller.co_name == '_get_value' \
            and 'torch/optim' in caller.co_filename.replace('\\', '/')
        if (name in HOST_READS and not adam_count) or masked:
            raise AssertionError(f'host read in the step: {name}')
        return func(*args, **(kwargs or {}))


ROUTES = {
    'EDSR cs': ('EDSR', {}), 'EDSR True': ('EDSR', dict(use_pallas=True)),
    'EDSR False': ('EDSR', dict(use_pallas=False)),
    'RCAN cs': ('RCAN', dict(n_resgroups=2, reduction=4)),
    'RCAN True': ('RCAN', dict(n_resgroups=2, reduction=4,
                               use_pallas=True)),
    'SRResNet': ('SRResNet', {}),
    'RDN': ('RDN', {}),
    'DDBPN': ('DDBPN', dict(n0=32, nr=16, depth=2)),
    'WDSR cs': ('WDSR', dict(use_pallas='cs')),
    'WDSR True': ('WDSR', dict(use_pallas=True)),
    'SRCNN': ('SRCNN', {})}
LOSSES = ('l1', '0.3 * l1 + 0.7 * mse', '0.5 * l1 + 0.5 * adaptive',
          'flip', 'haarpsi', '0.5 * l1 + 0.5 * edge_loss',
          '0.5 * l1 + 0.5 * pencil_sketch', 'edge_loss', 'lpips', 'dists',
          'pieapp', '0.5 * l2 + 0.5 * mae')


def _two_steps(model, losses, optimizer='ADAM', every=1):
    comp = parse_losses(losses)
    state = TrainState.create(model, comp, optimizer, ['lr=1e-4'],
                              Updater(every))
    step = make_train_step(comp)
    gen = torch.Generator().manual_seed(2)
    # PieAPP takes HR images of at least 64 x 64
    lr, hr = torch.rand(2, 16, 16, 3, generator=gen), \
        torch.rand(2, 64, 64, 3, generator=gen)
    for _ in range(every):      # the warm-up: constants, Adam's state
        step(state, lr, hr)
    with HostReads():
        for _ in range(every):
            step(state, lr, hr)


@pytest.mark.parametrize('route', sorted(ROUTES))
def test_train_step_reads_nothing_from_the_host(route):
    name, kw = ROUTES[route]
    model = create_model(name, scale_factor=4,
                         generator=torch.Generator().manual_seed(0),
                         **{**KW, **kw})
    _two_steps(model, 'l1', every=2)


@pytest.mark.parametrize('losses', LOSSES)
def test_losses_read_nothing_from_the_host(losses):
    _two_steps(port_model(), losses)


@pytest.mark.parametrize('optimizer', ['RMSprop', 'Ranger', 'RangerVA',
                                       'RangerQH', 'SGD'])
def test_optimizers_read_nothing_from_the_host(optimizer):
    _two_steps(port_model(), 'l1', optimizer)


def test_the_detector_catches_a_host_read():
    x = torch.ones(3)
    with pytest.raises(AssertionError, match='__float__'):
        with HostReads():
            float(x.sum())
    with pytest.raises(AssertionError, match='__getitem__'):
        with HostReads():
            x[x > 0]


FAMILIES = {'RCAN': dict(n_resgroups=2, reduction=4),
            'SRResNet': {}, 'RDN': {}, 'DDBPN': dict(n0=32, nr=16, depth=2),
            'WDSR': dict(use_pallas='cs'), 'SRCNN': {},
            'EDSR': dict(use_pallas=True)}


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_every_family_fits_at_k2(tmp_path, name):
    """``fit`` at k 2 (a window and a remainder step an epoch) equals k 1
    bit for bit for every family (EDSR on its True route; its 'cs' route
    is (a)'s); SRResNet's batch statistics too."""
    data = write_sets(tmp_path, n_train=6)
    runs = [port_fit(tmp_path / f'k{k}', data,
                     port_model(name, **FAMILIES[name]), max_epochs=1,
                     steps_per_execution=k)
            for k in (1, 2)]
    assert runs[0][1].global_step == runs[1][1].global_step == 3
    assert_same_state(runs[0][0], runs[1][0])
