"""The port's checkpoints (srtpu_torch/checkpoint.py, train/state.py)
against srtpu's on the CPU.

(a) top-k retention and its mode rule: the same metric sequences (with
    ties, rising and falling) through srtpu's Orbax ``CheckpointManager``
    and the port's keep the same steps after every save and give the
    same ``best_step``, in ``max`` and ``min`` mode and with
    ``save_top_k`` 0 (keep all); a step not past the latest is not kept;
(b) a state round trip is bit for bit (model, Adam's state, the
    accumulator, the step); a parameter set that does not match the
    model raises srtpu's named error; another optimizer structure is
    left fresh with srtpu's warning;
(c) ``load_hparams`` finds ``hparams.json`` in a parent directory;
(d) ``state_from_jax``: srtpu's optimizer structures (ADAM bare, under
    the clip chain, SGD's trace, inside MultiSteps) convert, others raise
    naming their ROADMAP item, and a conversion that is not a pure
    relayout raises;
(e) srtpu's SRGAN state, converted, resumes in the port: its next step
    matches srtpu's.
"""

import json
import logging
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from srtpu.checkpoint import CheckpointManager as JaxCheckpointManager
from srtpu.checkpoint import load_hparams as jax_load_hparams
from srtpu.models import create_model as jax_create_model
from srtpu.optim import build_optimizer as jax_build_optimizer
from srtpu.train import create_train_state
from srtpu_torch import convert
from srtpu_torch.checkpoint import CheckpointManager, load_hparams
from srtpu_torch.models import create_model
from srtpu_torch.optim import build_optimizer
from srtpu_torch.train import TrainState
from srtpu_torch.train.state import Updater, state_to_tree

torch.set_num_threads(1)

KW = dict(n_feats=16, n_resblocks=2)
SEQUENCES = {
    'rising': [10.0, 11.0, 12.0, 13.0, 14.0],
    'ties': [12.0, 11.0, 12.0, 12.0, 10.0, 13.0, 13.0],
    'falling': [14.0, 13.0, 12.0, 12.5, 11.0],
}


def _jax_state():
    leaf = np.zeros((2,), np.float32)
    return SimpleNamespace(step=0, params={'w': leaf}, batch_stats={},
                           loss_params={}, opt_state={'m': leaf})


def _port_state(seed=0, **kw):
    model = create_model('EDSR', generator=torch.Generator().manual_seed(
        seed), **{**KW, **kw})
    return TrainState(model, build_optimizer('ADAM', [], model.parameters()))


def _kept(path):
    top = path / 'top'
    return sorted(int(d.name) for d in top.iterdir()) if top.is_dir() else []


@pytest.mark.parametrize('seq', sorted(SEQUENCES))
@pytest.mark.parametrize('mode,top_k', [('max', 2), ('min', 2), ('max', 1),
                                        ('min', 3), ('max', 0)])
def test_top_k_matches_srtpu(tmp_path, seq, mode, top_k):
    values = SEQUENCES[seq]
    ref = JaxCheckpointManager(tmp_path / 'jax', monitor='Val/PSNR',
                               mode=mode, save_top_k=top_k, hparams={})
    got = CheckpointManager(tmp_path / 'port', monitor='Val/PSNR', mode=mode,
                            save_top_k=top_k, hparams={})
    jstate, state = _jax_state(), _port_state()
    try:
        for epoch, v in enumerate(values, 1):
            ref.save(epoch, jstate, {'Val/PSNR': v})
            got.save(epoch, state, {'Val/PSNR': v})
            assert _kept(tmp_path / 'port') == _kept(tmp_path / 'jax'), \
                (epoch, v)
            assert got.best_step() == ref.best_step(), (epoch, v)
        # no monitored metric (the crash save), and a step not past the
        # latest: 'last' alone
        ref.save(len(values) + 1, jstate, {})
        got.save(len(values) + 1, state, {})
        ref.save(1, jstate, {'Val/PSNR': 99.0})
        got.save(1, state, {'Val/PSNR': 99.0})
        assert _kept(tmp_path / 'port') == _kept(tmp_path / 'jax')
        assert got.best_step() == ref.best_step()
        assert (tmp_path / 'port' / 'last' / 'state.pt').is_file()
    finally:
        ref.close()
    # a manager on the same directory reads what is kept, as Orbax's does
    again = CheckpointManager(tmp_path / 'port', monitor='Val/PSNR',
                              mode=mode, save_top_k=top_k)
    again_ref = JaxCheckpointManager(tmp_path / 'jax', monitor='Val/PSNR',
                                     mode=mode, save_top_k=top_k)
    try:
        assert again.best_step() == again_ref.best_step()
    finally:
        again_ref.close()


def _step_once(state, accumulate=1):
    gen = torch.Generator().manual_seed(1)
    x = torch.rand(2, 8, 8, 3, generator=gen)
    for _ in range(accumulate + 1):
        state.optimizer.zero_grad(set_to_none=True)
        state.model(x).square().mean().backward()
        state.updater.apply(state.optimizer)
        state.step += 1


def test_round_trip_is_bit_for_bit(tmp_path):
    state = _port_state(1)
    state.updater = Updater(every=2)
    _step_once(state, accumulate=2)         # 3 mini-steps: one pending
    assert state.updater.mini_step == 1
    mngr = CheckpointManager(tmp_path, monitor='Val/PSNR')
    mngr.save(1, state, {'Val/PSNR': 1.0})
    fresh = _port_state(2)
    fresh.updater = Updater(every=2)
    mngr.restore(fresh)
    a, b = state_to_tree(state), state_to_tree(fresh)
    assert a['step'] == b['step'] == 3
    for k, v in a['model'].items():
        assert torch.equal(v, b['model'][k]), k
    sa, sb = a['opt_state']['model'], b['opt_state']['model']
    assert sa['mini_step'] == sb['mini_step'] == 1
    for name, st in sa['state'].items():
        for k, v in st.items():
            assert torch.equal(v, sb['state'][name][k]), (name, k)
        assert torch.equal(sa['acc_grads'][name], sb['acc_grads'][name])


def test_mismatch_raises_and_fresh_optimizer_warns(tmp_path, caplog):
    mngr = CheckpointManager(tmp_path, monitor='')
    mngr.save(1, _port_state(), {})
    with pytest.raises(ValueError, match="does not match the model's"):
        mngr.restore_last(_port_state(n_resblocks=3))
    rcan = create_model('RCAN', n_feats=16, n_resgroups=1, n_resblocks=1,
                        reduction=4, generator=torch.Generator())
    with pytest.raises(ValueError, match='checkpoint lacks e.g.'):
        mngr.restore_last(TrainState(rcan, build_optimizer(
            'ADAM', [], rcan.parameters())))
    # another optimizer: the weights restore, the optimizer stays fresh
    sgd = _port_state(5)
    sgd.optimizer = build_optimizer('SGD', ['momentum=0.9'],
                                    sgd.model.parameters())
    with caplog.at_level(logging.WARNING):
        mngr.restore_last(sgd)
    assert 'optimizer state structure mismatch' in caplog.text
    assert not sgd.optimizer.state
    ref = _port_state()
    for k, v in ref.model.state_dict().items():
        assert torch.equal(v, sgd.model.state_dict()[k]), k


def test_load_hparams_searches_parents(tmp_path):
    hp = {'model': 'EDSR', 'init_args': KW}
    (tmp_path / 'hparams.json').write_text(json.dumps(hp))
    deep = tmp_path / 'top' / '3'
    deep.mkdir(parents=True)
    assert load_hparams(deep) == jax_load_hparams(deep) == hp
    assert load_hparams(tmp_path) == hp


def _flat(tree):
    def key(k):
        return str(getattr(k, 'key', getattr(k, 'name', getattr(k, 'idx',
                                                                   k))))
    return {'/'.join(key(k) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _nested(flat):
    tree = {}
    for key, v in flat.items():
        *parents, leaf = key.split('/')
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def _srtpu_tree(tx, use_pallas='cs'):
    from srtpu.checkpoint import _state_to_tree
    jm = jax_create_model('EDSR', scale_factor=4, use_pallas=use_pallas, **KW)
    state = create_train_state(jm, tx, jax.random.PRNGKey(0),
                               jnp.zeros((1, 8, 8, 3)))
    # give the moments values of their own
    state = state.replace(step=jnp.asarray(3, jnp.int32),
                          opt_state=jax.tree_util.tree_map(
        lambda a: a + 0.5 if a.dtype == jnp.float32 else a + 2,
        state.opt_state))
    return _nested(_flat(_state_to_tree(state)))


@pytest.mark.parametrize('tx,kind', [
    (lambda: jax_build_optimizer('ADAM', ['lr=1e-3']), 'Adam'),
    (lambda: optax.chain(optax.clip_by_global_norm(1.0),
                         jax_build_optimizer('ADAM', [])), 'Adam'),
    (lambda: jax_build_optimizer('SGD', ['momentum=0.9']), 'SGD'),
    (lambda: optax.MultiSteps(jax_build_optimizer('ADAM', []), 2), 'Adam')])
def test_state_from_jax_structures(tx, kind):
    tree = _srtpu_tree(tx())
    out = convert.state_from_jax(tree)
    opt = out['opt_state']['model']
    assert opt['type'] == kind
    assert out['step'] == 3
    sd = convert.params_from_jax(tree)
    assert set(opt['params']) == set(sd)
    mu = convert.params_from_jax({'params': _first(tree['opt_state'],
                                                   ('mu', 'trace'))})
    st = opt['state']['trunk.w1']
    got = st['exp_avg'] if kind == 'Adam' else st['momentum_buffer']
    assert torch.equal(got, mu['trunk.w1'])
    if kind == 'Adam':
        assert float(st['step']) == 2.0       # Adam's count
    # the port restores it into a live state of that optimizer
    state = _port_state()
    if kind == 'SGD':
        state.optimizer = build_optimizer('SGD', ['momentum=0.9'],
                                          state.model.parameters())
    from srtpu_torch.train.state import tree_to_state
    tree_to_state(state, out)
    assert state.step == 3 and len(state.optimizer.state) == len(sd)


def _first(node, names):
    """The first subtree under one of ``names`` (its 'model' entry)."""
    for k, v in node.items():
        if k in names:
            return v['model']
        if isinstance(v, dict):
            found = _first(v, names)
            if found is not None:
                return found
    return None


def test_state_from_jax_refuses():
    """Only an optimizer srtpu does not build raises (Adagrad's state);
    RMSprop's and Ranger's, refused before item 16, convert to the
    port's optimizer of that name."""
    from srtpu.optim import build_optimizer as jbo
    for name in ('Ranger', 'RMSprop'):
        out = convert.state_from_jax(_srtpu_tree(jbo(name, [])))
        assert out['opt_state']['model']['type'] == name
    with pytest.raises(ValueError, match='unknown srtpu optimizer'):
        convert.state_from_jax(_srtpu_tree(optax.adagrad(1e-2)))


def test_relayout_check_catches_a_padding_map(monkeypatch):
    tree = _srtpu_tree(jax_build_optimizer('ADAM', []))
    convert.check_relayout(tree['params'], {})
    real = convert.w_ps_hwio

    def padded(w, n, r):     # the tail's map with a zero phase
        out = real(w, n, r).clone()
        out[..., :n] = 0
        return out
    monkeypatch.setattr(convert, 'w_ps_hwio', padded)
    with pytest.raises(ValueError, match='not a pure relayout'):
        convert.state_from_jax(tree)


def test_srgan_state_from_jax_resumes_in_port():
    """(e) srtpu's SRGAN state after 2 adversarial steps (its combined
    view: G and D parameters and batch statistics, the optimizers ``g``
    and ``d``, the step), flattened to ``.npz`` and converted, loaded into
    a port SRGAN drawn from other weights: the third step's logs match
    srtpu's third step within ``tests/test_torch_srgan.py``'s step
    tolerance (1e-5 relative, vgg_loss 2^-8), and the converted Adam
    counts and schedules stand at 2."""
    from srtpu.losses.vgg import VGGLoss as JaxVGGLoss
    from srtpu.train.gan import GANTrainState as JaxGANTrainState
    from srtpu.train.gan import make_gan_train_step as jax_gan_step
    from srtpu_torch.losses import VGGLoss
    from srtpu_torch.train import GANTrainState, make_gan_train_step
    from srtpu_torch.train.state import tree_to_state
    from test_torch_resume import _npz
    from test_torch_srgan import (ADAM_EPS, B, H, KW, LR, W, JaxD, JaxG,
                                  _jax_gan)
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(3):
        hr = rng.random((B, 4 * H, 4 * W, 3), np.float32)
        batches.append((hr.reshape(B, H, 4, W, 4, 3).mean((2, 4))
                        .astype(np.float32), hr))
    gen = JaxG(scale_factor=4, channels=3, ngf=KW['ngf'],
               n_blocks=KW['n_blocks'], use_pallas='cs', dtype=None)
    disc = JaxD(ndf=KW['ndf'])
    _, v = _jax_gan(4, 'cs')
    p, bs = v['params'], v['batch_stats']

    def tx():
        return optax.adam(optax.exponential_decay(LR, 100_000, 0.1,
                                                  staircase=True),
                          eps=ADAM_EPS)
    g_tx, d_tx = tx(), tx()
    jstate = JaxGANTrainState(
        step=jnp.zeros([], jnp.int32),
        g_params=jax.tree_util.tree_map(jnp.asarray, p['generator']),
        d_params=jax.tree_util.tree_map(jnp.asarray, p['discriminator']),
        g_batch_stats=jax.tree_util.tree_map(jnp.asarray, bs['generator']),
        d_batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                             bs['discriminator']),
        g_opt_state=g_tx.init(p['generator']),
        d_opt_state=d_tx.init(p['discriminator']),
        g_apply=gen.apply, d_apply=disc.apply, g_tx=g_tx, d_tx=d_tx)
    jstep = jax_gan_step(vgg_loss=JaxVGGLoss('vgg19', 'relu5_4'))
    for lr, hr in batches[:2]:
        jstate, _ = jstep(jstate, jnp.asarray(lr), jnp.asarray(hr))
    view = {'step': jstate.step,
            'params': {'generator': jstate.g_params,
                       'discriminator': jstate.d_params},
            'batch_stats': {'generator': jstate.g_batch_stats,
                            'discriminator': jstate.d_batch_stats},
            'opt_state': {'g': jstate.g_opt_state, 'd': jstate.d_opt_state}}
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        _npz(f'{tmp}/gan.npz', view)
        tree = convert.state_from_jax(convert.load_npz(f'{tmp}/gan.npz'))
    assert tree['step'] == 2 and set(tree['opt_state']) == {'g', 'd'}
    for key, part in (('g', 'generator.'), ('d', 'discriminator.')):
        opt = tree['opt_state'][key]
        assert opt['params'] and all(n.startswith(part)
                                     for n in opt['params'])
        assert opt['schedule'] == {'last_epoch': 2, '_step_count': 3}
        assert all(float(s['step']) == 2 for s in opt['state'].values())

    model = create_model('SRGAN', scale_factor=4, use_pallas='cs',
                         generator=torch.Generator().manual_seed(9), **KW)
    model.train()

    def opt(params):
        o = build_optimizer('ADAM', {'lr': LR, 'eps': ADAM_EPS}, params)
        return o, torch.optim.lr_scheduler.StepLR(o, 100_000, 0.1)
    (go, gs), (do, ds) = (opt(model.generator.parameters()),
                          opt(model.discriminator.parameters()))
    pstate = tree_to_state(GANTrainState(model.generator,
                                         model.discriminator, go, do, gs,
                                         ds), tree)
    assert pstate.step == 2 and gs.last_epoch == 2
    lr, hr = batches[2]
    jstate, jlogs = jstep(jstate, jnp.asarray(lr), jnp.asarray(hr))
    plogs = make_gan_train_step(vgg_loss=VGGLoss())(
        pstate, torch.from_numpy(lr), torch.from_numpy(hr))
    assert pstate.step == int(jstate.step) == 3
    for k, ref in jlogs.items():
        np.testing.assert_allclose(
            plogs[k].item(), float(ref),
            rtol=2.0 ** -8 if k == 'vgg_loss' else 1e-5, err_msg=k)


# --------------------------- RMSprop and the Ranger family (item 16)

ITEM16_TX = {
    'RMSprop': lambda: jax_build_optimizer('RMSprop', ['momentum=0.9']),
    'Ranger': lambda: jax_build_optimizer('Ranger', ['k=2']),
    'RangerVA': lambda: optax.chain(optax.clip_by_global_norm(1.0),
                                    jax_build_optimizer(
                                        'RangerVA', ['weight_decay=1e-2'])),
    'RangerQH': lambda: optax.MultiSteps(jax_build_optimizer(
        'RangerQH', ['k=2']), 2)}
ITEM16_PORT = {'RMSprop': (['momentum=0.9'], {}),
               'Ranger': (['k=2'], {}),
               'RangerVA': (['weight_decay=1e-2'],
                            dict(clip_val=1.0)),
               'RangerQH': (['k=2'], dict(every=2))}


def _grad_trees(params, n, seed=7):
    rng = np.random.default_rng(seed)
    return [jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32) * 0.1,
        params) for _ in range(n)]


def _srtpu_stepped(tx, grads):
    """srtpu's tiny EDSR state after ``grads`` (trees of its params) as
    its ``apply_gradients`` takes them."""
    jm = jax_create_model('EDSR', scale_factor=4, use_pallas='cs', **KW)
    state = create_train_state(jm, tx, jax.random.PRNGKey(0),
                               jnp.zeros((1, 8, 8, 3)))
    for g in grads:
        state = state.apply_gradients({'model': g, 'loss': {}})
    return state


def _port_step(state, grads) -> None:
    """The port's update on srtpu-layout gradient trees (through convert),
    one ``Updater.apply`` each."""
    named = dict(state.model.named_parameters())
    for g in grads:
        for n, t in convert.params_from_jax({'params': g}).items():
            named[n].grad = t.clone()
        state.updater.apply(state.optimizer)
        state.step += 1


def _port_of(name, params=None):
    from srtpu_torch.losses import parse_losses
    opt, upd = ITEM16_PORT[name]
    model = create_model('EDSR', scale_factor=4,
                         generator=torch.Generator().manual_seed(0), **KW)
    if params is not None:
        model.load_state_dict(convert.params_from_jax(
            {'params': jax.tree_util.tree_map(np.asarray, params)}))
    return TrainState.create(model, parse_losses('l1'), name, opt,
                             Updater(**upd))


@pytest.mark.parametrize('name', sorted(ITEM16_TX))
def test_item16_state_from_jax_resumes_as_srtpu(name):
    """srtpu's state after 3 updates (bare, under the clip / weight-decay
    chain, inside MultiSteps), converted and restored into the port,
    takes the next 3 updates as srtpu does: parameters within 1e-5 of each
    tensor's largest magnitude (test_torch_optim.py's tolerances, over
    fewer steps), its moments, traces and slow weights mapped by
    ``convert``."""
    from srtpu.checkpoint import _state_to_tree
    from srtpu_torch.train.state import tree_to_state
    jm_params = _srtpu_stepped(ITEM16_TX[name](), []).params
    grads = _grad_trees(jm_params, 6)
    before = _srtpu_stepped(ITEM16_TX[name](), grads[:3])
    after = _srtpu_stepped(ITEM16_TX[name](), grads)
    nested = _nested(_flat(_state_to_tree(before)))
    tree = convert.state_from_jax(nested)
    opt = tree['opt_state']['model']
    assert opt['type'] == name and tree['step'] == 3
    st = opt['state']['trunk.w1']
    if name == 'RMSprop':
        assert set(st) == {'nu', 'trace'}
    else:
        slow = convert.params_from_jax(
            {'params': _first(nested['opt_state'], ('slow',))})
        assert torch.equal(st['slow'], slow['trunk.w1'])
        assert float(st['count']) == (1.0 if name == 'RangerQH' else 3.0)
    state = _port_of(name)
    tree_to_state(state, tree)
    _port_step(state, grads[3:])
    want = convert.params_from_jax({'params': jax.tree_util.tree_map(
        np.asarray, after.params)})
    for n, ref in want.items():
        np.testing.assert_allclose(
            state.model.state_dict()[n].numpy(), ref.numpy(), rtol=0,
            atol=1e-5 * ref.abs().max().item(), err_msg=n)


@pytest.mark.parametrize('name', sorted(ITEM16_TX))
def test_item16_round_trip_resumes_bit_for_bit(tmp_path, name):
    """A checkpoint of each optimizer's state, restored into a fresh
    state, continues exactly as the uninterrupted state."""
    grads = _grad_trees(_srtpu_stepped(ITEM16_TX[name](), []).params, 6)
    whole, cut = _port_of(name), _port_of(name)
    _port_step(whole, grads)
    _port_step(cut, grads[:3])
    mngr = CheckpointManager(tmp_path, monitor='')
    mngr.save(1, cut, {})
    fresh = _port_of(name)
    mngr.restore_last(fresh)
    _port_step(fresh, grads[3:])
    a, b = state_to_tree(whole), state_to_tree(fresh)
    assert a['step'] == b['step'] == 6
    for k, v in a['model'].items():
        assert torch.equal(v, b['model'][k]), k
    sa, sb = a['opt_state']['model'], b['opt_state']['model']
    assert sa['type'] == sb['type'] == name
    assert sa['mini_step'] == sb['mini_step']
    for pname, st in sa['state'].items():
        for k, v in st.items():
            assert torch.equal(v, sb['state'][pname][k]), (pname, k)
