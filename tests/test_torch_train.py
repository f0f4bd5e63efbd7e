"""The port's training slice against srtpu on the CPU.

(a) losses and the loss DSL, and the optimizers, against srtpu's
    (optax) on the same inputs;
(b) the train step: x4, n_feats 16, 2 resblocks, batch 2, patch 32, L1,
    Adam at lr 1e-3 and eps 1e-4, f32, 50 steps from the same init (the
    JAX tree through srtpu_torch.convert) on the same batches, against
    srtpu's make_train_step on its XLA path: the loss at every step
    within 1e-5 relative, the final params within 1e-4 of each tensor's
    largest magnitude (the two sides sum in another order: gradients at
    equal params agree to 1e-6). Why eps 1e-4: with srtpu's default
    1e-8, Adam's first update of a weight whose gradient was exactly 0
    until now (a dead ReLU channel coming back) is a full lr step
    whatever the gradient's size, so a channel that revives on one side
    a step earlier than on the other moves there by lr: measured 14% of
    trunk.w1's largest magnitude apart after 50 steps, against 3e-6 at
    eps 1e-4 with the params moving up to 22 lr;
(c) the kernel path: x2 with 8x8 LR, where srtpu's trunk and tail take
    the Pallas kernels (interpret mode; cs_conv.PATH_LOG says 'cs'), a
    step in f32 (params 1e-4 relative, as (b)) and in bf16 compute on
    f32 params: the loss within 2^-7 relative and every weight
    gradient within 2^-6 of its largest magnitude (both sides round
    activations to bf16 at the same points; a value next to a rounding
    boundary can land one step apart and the backward carries it on).
    The bf16 case is also the test of the f32 weight grads: they must
    hold more than bf16's 8 bits, as srtpu's custom_vjp's do;
(d) ``python -m srtpu_torch fit --device cpu`` against srtpu's
    Trainer.fit from the same state, data and seed (params as (b)).
"""


import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from srtpu.losses import parse_losses as jax_parse_losses
from srtpu.models import create_model as jax_create_model
from srtpu.ops import cs_conv
from srtpu.optim import build_optimizer as jax_build_optimizer
from srtpu.train import create_train_state
from srtpu.train import make_train_step as jax_make_train_step
from srtpu_torch.convert import params_from_jax
from srtpu_torch.losses import parse_losses
from srtpu_torch.models import create_model
from srtpu_torch.optim import build_optimizer
from srtpu_torch.train import TrainState, make_train_step

torch.set_num_threads(1)

KW = dict(n_feats=16, n_resblocks=2)


def _tree_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _port(scale, params, dtype=None):
    model = create_model('EDSR', scale_factor=scale, dtype=dtype,
                         generator=torch.Generator().manual_seed(0), **KW)
    model.load_state_dict(params_from_jax(_tree_np(params)))
    return model


def _assert_params_close(model, jax_params, rel=1e-4):
    want = params_from_jax(_tree_np(jax_params))
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        ref = want[k].numpy()
        np.testing.assert_allclose(got[k].numpy(), ref, rtol=0,
                                   atol=rel * np.abs(ref).max(), err_msg=k)


# ---------------------------------------------------- (a) losses, optim

@pytest.mark.parametrize('dsl', ['l1', '0.3 * l1 + 0.7 * mse',
                                 '0.5*mae + 2 * l2', '0.3 * l1 + 0.7 * l1'])
def test_losses_match_srtpu(dsl):
    rng = np.random.default_rng(0)
    sr = rng.random((2, 8, 8, 3), np.float32)
    hr = rng.random((2, 8, 8, 3), np.float32)
    # sr in bf16 (the model's output dtype), read as f32 on both sides
    ref_total, ref_parts = jax_parse_losses(dsl)(
        jnp.asarray(sr, jnp.bfloat16), jnp.asarray(hr))
    total, parts = parse_losses(dsl)(torch.from_numpy(sr).bfloat16(),
                                     torch.from_numpy(hr))
    assert parts.keys() == ref_parts.keys()
    np.testing.assert_allclose(float(total), float(ref_total), rtol=1e-6)
    for k in parts:
        np.testing.assert_allclose(float(parts[k]), float(ref_parts[k]),
                                   rtol=1e-6)


def test_parse_losses_errors_match_srtpu():
    # every srtpu name builds, with srtpu's dispatch flags
    from srtpu.losses import supported_losses as jax_supported
    from srtpu_torch.losses import supported_losses
    assert supported_losses() == jax_supported()
    for name in supported_losses():
        comp = parse_losses(f'0.5 * l1 + 0.5 * {name}')
        assert comp.names == ['l1', name]
        sub = comp.sub_losses[1]
        assert sub.trainable == (name == 'adaptive')
        assert sub.clamp_sr == (name in ('haarpsi', 'pieapp'))
        assert comp.has_trainable == (name == 'adaptive')
    for bad, exc in (('nosuch', AttributeError), ('x * l1', ValueError),
                     ('1 * 2 * l1', ValueError)):
        with pytest.raises(exc) as got:
            parse_losses(bad)
        with pytest.raises(exc) as ref:
            jax_parse_losses(bad)
        assert str(got.value) == str(ref.value)


@pytest.mark.parametrize('name,params', [
    ('ADAM', []),
    ('ADAM', ['lr=3e-3', 'betas=0.8,0.99', 'eps=1e-6',
              'weight_decay=0.1']),
    ('SGD', ['lr=0.05', 'momentum=0.9']),
    ('SGD', ['lr=0.05', 'momentum=0.9', 'nesterov=true',
             'weight_decay=0.01'])])
def test_optimizer_matches_optax(name, params):
    """20 updates from the same gradients: 1e-6 of the largest magnitude
    (optax and torch order the same f32 arithmetic differently)."""
    rng = np.random.default_rng(1)
    p0 = rng.standard_normal((4, 5)).astype(np.float32)
    grads = [rng.standard_normal((4, 5)).astype(np.float32) * 10.0 ** -i
             for i in range(20)]
    tx = jax_build_optimizer(name, params)
    jp = {'w': jnp.asarray(p0)}
    st = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = build_optimizer(name, params, [tp])
    for g in grads:
        upd, st = tx.update({'w': jnp.asarray(g)}, st, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        opt.step()
    ref = np.asarray(jp['w'])
    np.testing.assert_allclose(tp.detach().numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())


def test_optimizer_errors():
    """Parameters an optimizer does not take and unknown names raise
    srtpu's errors; RMSprop and the Ranger family build with srtpu's
    defaults (srtpu/optim.py:142-177) and refuse what srtpu refuses."""
    p = [torch.nn.Parameter(torch.zeros(2))]
    with pytest.raises(ValueError, match='not supported by ADAM'):
        build_optimizer('ADAM', ['momentum=0.9'], p)
    with pytest.raises(ValueError, match='not recognized'):
        build_optimizer('Adagrad', [], p)
    defaults = {'RMSprop': dict(lr=1e-2, alpha=0.99, eps=1e-8, momentum=0.0),
                'Ranger': dict(lr=1e-3, betas=(0.95, 0.999), eps=1e-5, k=6,
                               alpha=0.5),
                'RangerVA': dict(lr=1e-3, betas=(0.95, 0.999), eps=1e-5,
                                 k=6, alpha=0.5),
                'RangerQH': dict(lr=1e-3, betas=(0.95, 0.999), eps=1e-5,
                                 k=6, alpha=0.5, nus=(0.7, 1.0))}
    for name, want in defaults.items():
        group = build_optimizer(name, [], p).param_groups[0]
        assert type(build_optimizer(name, [], p)).__name__ == name
        assert {k: group[k] for k in want} == want, name
        assert group['weight_decay'] == 0.0
        bad = 'nesterov=true' if name == 'RMSprop' else 'momentum=0.9'
        with pytest.raises(ValueError, match=f'not supported by {name}'):
            build_optimizer(name, [bad], p)
    with pytest.raises(ValueError, match="not supported by Ranger: .'nus'"):
        build_optimizer('Ranger', ['nus=0.7,1.0'], p)


# ------------------------------------------------------ (b) train step

def _batches(n, batch, lp, scale, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        hr = rng.random((batch, lp * scale, lp * scale, 3), np.float32)
        lr = hr.reshape(batch, lp, scale, lp, scale, 3).mean((2, 4))
        yield lr.astype(np.float32), hr


OPT = ['lr=1e-3', 'eps=1e-4']


def _jax_state(scale, dtype, x, seed):
    jm = jax_create_model('EDSR', scale_factor=scale, dtype=dtype, **KW)
    return create_train_state(jm, jax_build_optimizer('ADAM', OPT),
                              jax.random.PRNGKey(seed), jnp.asarray(x))


def _port_state(scale, jax_params, dtype):
    model = _port(scale, {'params': jax_params}, dtype)
    return TrainState(model, build_optimizer('ADAM', OPT,
                                             model.parameters()))


def test_train_step_matches_srtpu_50_steps():
    batches = list(_batches(50, 2, 8, 4, seed=2))
    jstate = _jax_state(4, None, batches[0][0], seed=5)
    pstate = _port_state(4, jstate.params, None)
    jstep = jax_make_train_step(jax_parse_losses('l1'), donate=False)
    pstep = make_train_step(parse_losses('l1'))
    for lr, hr in batches:
        jstate, jlogs = jstep(jstate, jnp.asarray(lr), jnp.asarray(hr))
        plogs = pstep(pstate, torch.from_numpy(lr), torch.from_numpy(hr))
        assert plogs.keys() == jlogs.keys() == {'loss', 'loss/l1'}
        np.testing.assert_allclose(float(plogs['loss']), float(jlogs['loss']),
                                   rtol=1e-5)
    assert pstate.step == int(jstate.step) == 50
    _assert_params_close(pstate.model, jstate.params)


# ----------------------------------------------------- (c) kernel path

def _kernel_path_step(dtype, n_steps):
    jdt, tdt = {'f32': (None, None),
                'bf16': (jnp.bfloat16, torch.bfloat16)}[dtype]
    batches = list(_batches(n_steps, 2, 8, 2, seed=3))
    jstate = _jax_state(2, jdt, batches[0][0], seed=6)
    pstate = _port_state(2, jstate.params, tdt)
    jstep = jax_make_train_step(jax_parse_losses('l1'), donate=False)
    pstep = make_train_step(parse_losses('l1'))
    cs_conv.PATH_LOG.clear()
    losses = []
    for lr, hr in batches:
        jstate, jlogs = jstep(jstate, jnp.asarray(lr), jnp.asarray(hr))
        plogs = pstep(pstate, torch.from_numpy(lr), torch.from_numpy(hr))
        losses.append((float(plogs['loss']), float(jlogs['loss'])))
    assert set(cs_conv.PATH_LOG.values()) == {'cs'}
    return jstate, pstate, losses, batches


def test_train_step_kernel_path_matches_srtpu_f32(monkeypatch):
    monkeypatch.setenv('SRTPU_CS_OFF_TPU', '1')
    jstate, pstate, losses, _ = _kernel_path_step('f32', 2)
    for got, ref in losses:
        assert got == pytest.approx(ref, rel=1e-5)
    _assert_params_close(pstate.model, jstate.params)


def test_weight_grads_f32_under_bf16_compute(monkeypatch):
    """bf16 compute on f32 params: the port's weight grads against
    srtpu's jax.grad through the Pallas kernels' custom_vjp's. The ops
    cast the weights inside, so the grads keep f32 precision; cast
    outside, autograd would round each to bf16 on its way back."""
    monkeypatch.setenv('SRTPU_CS_OFF_TPU', '1')
    jstate, pstate, losses, batches = _kernel_path_step('bf16', 1)
    got_loss, ref_loss = losses[0]
    assert abs(got_loss - ref_loss) <= 2.0 ** -7 * ref_loss
    lr, hr = batches[0]
    # gradients at the initial params (the step above moved both)
    jm = jax_create_model('EDSR', scale_factor=2, dtype=jnp.bfloat16, **KW)
    params0 = _jax_state(2, jnp.bfloat16, lr, seed=6).params

    def loss_fn(p):
        sr = jm.apply({'params': p}, jnp.asarray(lr))
        return jnp.mean(jnp.abs(sr.astype(jnp.float32) - jnp.asarray(hr)))

    ref = params_from_jax(_tree_np(jax.grad(loss_fn)(params0)))
    model = _port(2, {'params': params0}, torch.bfloat16)
    parse_losses('l1')(model(torch.from_numpy(lr)).float(),
                       torch.from_numpy(hr))[0].backward()
    for name, p in model.named_parameters():
        want = ref[name].numpy()
        top = np.abs(want).max()
        assert p.grad.dtype == torch.float32
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=2.0 ** -6 * top, err_msg=name)
        if name in ('trunk.w1', 'trunk.w2') or (
                name.startswith(('trunk.', 'tail.')) and 'weight' in name):
            rounded = p.grad.bfloat16().float()
            assert not torch.equal(rounded, p.grad), \
                f'{name}: weight grad rounded to bf16'


# ---------------------------------------------------------------- (d) fit

def _write_dataset(root, n=6, hr_size=(64, 80), scale=4, seed=0):
    hr_dir = root / 'datasets' / 'Train' / 'HR'
    lr_dir = root / 'datasets' / 'Train' / 'LR' / f'X{scale}'
    hr_dir.mkdir(parents=True)
    lr_dir.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    h, w = hr_size
    for i in range(n):
        lo = rng.random((h // 8 + 1, w // 8 + 1, 3))
        hr = np.kron(lo, np.ones((8, 8, 1)))[:h, :w].astype(np.float32)
        np.save(hr_dir / f'{i:03d}.npy', hr)
        lr = hr.reshape(h // scale, scale, w // scale, scale, 3).mean((1, 3))
        np.save(lr_dir / f'{i:03d}.npy', lr.astype(np.float32))
    return root / 'datasets'


def _jax_plain_tree(sd):
    """Port state dict -> srtpu's use_pallas=False EDSR tree (the inverse
    of params_from_jax on that tree)."""
    def conv(w, b):
        return {'kernel': jnp.asarray(w.numpy()), 'bias': jnp.asarray(b.numpy())}
    p = {'Conv2d_0': conv(sd['head.weight'], sd['head.bias']),
         'Conv2d_1': conv(sd['trunk.close_weight'], sd['trunk.close_bias']),
         'Conv2d_2': conv(sd['tail.final_weight'], sd['tail.final_bias'])}
    for i in range(sd['trunk.w1'].shape[0]):
        p[f'ResBlock_{i}'] = {
            'Conv2d_0': conv(sd['trunk.w1'][i], sd['trunk.b1'][i]),
            'Conv2d_1': conv(sd['trunk.w2'][i], sd['trunk.b2'][i])}
    up, i = {}, 0
    while f'tail.up{i}_weight' in sd:
        up[f'Conv2d_{i}'] = conv(sd[f'tail.up{i}_weight'],
                                 sd[f'tail.up{i}_bias'])
        i += 1
    p['UpscaleBlock_0'] = up
    return p


def test_fit_cli_matches_srtpu_trainer(tmp_path):
    from srtpu.data import SRData as JaxSRData
    from srtpu.train import Trainer as JaxTrainer
    from srtpu.train import TrainerConfig as JaxTrainerConfig
    from srtpu.train.state import TrainState as JaxTrainState
    from srtpu_torch import cli

    datasets = _write_dataset(tmp_path)
    seed, opt = 7, OPT
    argv = ['fit', '--datasets_dir', str(datasets), '--train_datasets',
            'Train', '--batch_size', '2', '--patch_size', '32',
            '--n_feats', '16', '--n_resblocks', '2', '--max_epochs', '2',
            '--precision', '32', '--device', 'cpu', '--seed', str(seed),
            '--optimizer_params', *opt, '--default_root_dir',
            str(tmp_path / 'port')]
    init = cli.build_model(cli.build_parser().parse_args(argv),
                           torch.device('cpu')).state_dict()
    assert cli.main(argv) == 0
    log = (tmp_path / 'port' / 'run.log').read_text()
    assert 'epoch 1/2  loss' in log and 'epoch 2/2  loss' in log
    got = torch.load(tmp_path / 'port' / 'final_weights.pt',
                     weights_only=True)

    jm = jax_create_model('EDSR', scale_factor=4, use_pallas=False, **KW)
    tree = _jax_plain_tree(init)
    assert all(torch.equal(v, params_from_jax(_tree_np(tree))[k])
               for k, v in init.items())
    tx = jax_build_optimizer('ADAM', opt)
    state = JaxTrainState.create(apply_fn=jm.apply, params=tree, tx=tx)
    dm = JaxSRData(batch_size=2, datasets_dir=str(datasets),
                   eval_datasets=[], patch_size=32, scale_factor=4,
                   train_datasets=['Train'], seed=seed, num_workers=1)
    trainer = JaxTrainer(JaxTrainerConfig(
        max_epochs=2, num_sanity_val_steps=0, enable_checkpointing=False,
        default_root_dir=str(tmp_path / 'jax'), seed=seed))
    try:
        state = trainer.fit(jm, dm, losses='l1', optimizer_name='ADAM',
                            optimizer_params=opt, state=state)
    finally:
        trainer.close()
    assert trainer.global_step == 6
    want = params_from_jax(_tree_np(state.params))
    for k, ref in want.items():
        np.testing.assert_allclose(got[k].numpy(), ref.numpy(), rtol=0,
                                   atol=1e-4 * ref.abs().max().item(),
                                   err_msg=k)


def test_fit_refuses_what_is_not_ported(tmp_path):
    """Every srtpu knob is ported: the loop keeps no list of refused
    ones, and ``steps_per_execution`` (ROADMAP.md item 18, once refused)
    is taken, from the CLI too, so a missing dataset raises srtpu's error
    whatever its value (at most 0, srtpu's k 1)."""
    from srtpu_torch import cli
    from srtpu_torch.data import SRData
    from srtpu_torch.train import Trainer, TrainerConfig
    from srtpu_torch.train import loop
    assert not hasattr(loop, 'NOT_PORTED')
    model = create_model('EDSR', generator=torch.Generator(), **KW)
    dm = SRData(datasets_dir=str(tmp_path), train_datasets=['Train'])
    for k in (1, 4, 0):
        with pytest.raises(FileNotFoundError, match='HR images'):
            Trainer(TrainerConfig(steps_per_execution=k)).fit(model, dm)
    args = cli.build_parser().parse_args(
        ['fit', '--train_datasets', 'Train', '--steps_per_execution', '4',
         '--datasets_dir', str(tmp_path), '--device', 'cpu'])
    assert cli._flag_config(args)[2].steps_per_execution == 4


def test_fit_cli_cuda_without_card_raises(tmp_path):
    from srtpu_torch.cli import main
    if torch.cuda.is_available():
        pytest.skip('this host has a card: the no-card error cannot show')
    datasets = _write_dataset(tmp_path)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        main(['fit', '--datasets_dir', str(datasets), '--train_datasets',
              'Train', '--device', 'cuda',
              '--default_root_dir', str(tmp_path / 'out')])
    assert not (tmp_path / 'out').exists()


@pytest.mark.parametrize('extra', [['--model', 'RDN', '--scale_factor',
                                    '8'], ['--precision', '32']])
def test_cli_refuses_x3_and_f32_on_cuda(extra):
    """The kernels take bf16, and a scale outside the model's card scales
    (since K2 took the x3 tails' 576 -> 32 and DDBPN x8 runs srtpu's XLA
    branch in stock convs, only a scale the model has nowhere: RDN x8)
    is refused: at model build, before any card is touched."""
    from srtpu_torch import cli
    args = cli.build_parser().parse_args(
        ['fit', '--train_datasets', 'Train', '--device', 'cuda', *extra])
    with pytest.raises(ValueError, match='bf16'):
        cli.build_model(args, torch.device('cuda'))


@pytest.mark.parametrize('model,extra,ok', [
    ('SRCNN', [], True), ('EDSR', ['--use_pallas', 'false'], True),
    ('RCAN', ['--use_pallas', 'false'], True), ('WDSR', [], True),
    ('SRGAN', [], True), ('EDSR', [], False),
    ('EDSR', ['--use_pallas', 'true'], False), ('SRResNet', [], False),
    ('WDSR', ['--use_pallas', 'cs'], False)])
def test_cli_f32_on_cuda_where_no_kernel(model, extra, ok):
    """F4: on CUDA, f32 is refused only where the route reaches a kernel;
    SRCNN and the use_pallas=False routes take it (srtpu's spellings of
    the precision too)."""
    from srtpu_torch import cli
    for precision in ('32', 'bf16', 'bfloat16', '16'):
        args = cli.build_parser().parse_args(
            ['fit', '--train_datasets', 'Train', '--model', model,
             '--precision', precision, *extra])
        given = {k: getattr(args, k) for k in cli.MODEL_FLAGS
                 if hasattr(args, k)}
        if ok or precision != '32':
            cli.check_card(model, 4, precision, given)
        else:
            with pytest.raises(ValueError, match='bf16'):
                cli.check_card(model, 4, precision, given)
        assert cli.model_dtype(precision) == (
            None if precision == '32' else torch.bfloat16)
