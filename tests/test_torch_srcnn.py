"""The port's SRCNN (srtpu_torch.models.SRCNN) against srtpu's on the CPU.

(a) ``resize_matrix`` bit-equal to srtpu's at several (in, out) pairs,
    both kernels and both border conventions; ``bicubic_resize`` within
    1e-6 of srtpu's (two f32 matmuls, summed in another order);
(b) the forward from a converted JAX tree: f32 within 1e-5; bf16 within
    one bf16 step (2^-7) of the output's largest magnitude (the two sides
    round each conv at the same points, so only a sum next to a rounding
    boundary lands a step apart);
(c) ``fit`` through the CLI for a few steps on the CPU, the loss logged
    and finite, the weights written and read back by ``predict``;
(d) ``predict`` PNGs equal to srtpu's ``Trainer.predict`` within +-1
    uint8 level (as tests/test_torch_predict.py holds EDSR's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from srtpu.models import common as jax_common
from srtpu.models import create_model as jax_create_model
from srtpu_torch.convert import params_from_jax
from srtpu_torch.models import SRCNN, create_model
from srtpu_torch.models.common import bicubic_resize, resize_matrix

torch.set_num_threads(1)


@pytest.mark.parametrize('antialias', [False, True])
@pytest.mark.parametrize('a', [-0.75, -0.5])
@pytest.mark.parametrize('sizes', [(6, 24), (7, 21), (13, 26), (32, 96),
                                   (40, 10), (17, 17)])
def test_resize_matrix_bit_equal(sizes, a, antialias):
    got = resize_matrix(*sizes, a=a, antialias=antialias)
    ref = jax_common.resize_matrix(*sizes, a=a, antialias=antialias)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_bicubic_resize_matches_srtpu():
    x = np.random.default_rng(0).random((2, 9, 11, 3), np.float32)
    ref = np.asarray(jax_common.bicubic_resize(jnp.asarray(x), (36, 44),
                                               a=-0.75, antialias=False))
    got = bicubic_resize(torch.from_numpy(x), (36, 44), a=-0.75,
                         antialias=False)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def _tree_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('scale', [2, 3, 4])
def test_srcnn_matches_srtpu(scale, dtype):
    jdt, tdt = {'f32': (None, None),
                'bf16': (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = np.random.default_rng(scale).random((2, 7, 9, 3), np.float32)
    jm = jax_create_model('SRCNN', scale_factor=scale, dtype=jdt)
    params = jm.init(jax.random.PRNGKey(scale), jnp.asarray(x))
    ref = np.asarray(jm.apply(params, jnp.asarray(x)).astype(jnp.float32))
    model = create_model('SRCNN', scale_factor=scale, dtype=tdt,
                         generator=torch.Generator().manual_seed(0))
    assert isinstance(model, SRCNN)
    model.load_state_dict(params_from_jax(_tree_np(params)))
    with torch.inference_mode():
        out = model(torch.from_numpy(x))
    assert out.dtype == (tdt or torch.float32)
    got = out.float().numpy()
    assert got.shape == ref.shape == (2, 7 * scale, 9 * scale, 3)
    atol = 1e-5 if dtype == 'f32' else 2.0 ** -7 * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def _write_datasets(root):
    rng = np.random.default_rng(11)
    demo = root / 'datasets' / 'Demo'
    demo.mkdir(parents=True)
    for name, (h, w) in (('a', (24, 40)), ('b', (32, 32))):
        lo = rng.random((h // 4 + 1, w // 4 + 1, 3))
        img = np.kron(lo, np.ones((4, 4, 1)))[:h, :w]
        Image.fromarray((img * 255).astype(np.uint8)) \
            .save(demo / f'{name}.png')
    train = root / 'datasets' / 'Train'
    (train / 'HR').mkdir(parents=True)
    (train / 'LR' / 'X4').mkdir(parents=True)
    for i in range(2):
        hr = rng.random((32, 32, 3), np.float32)
        np.save(train / 'HR' / f'{i}.npy', hr)
        np.save(train / 'LR' / 'X4' / f'{i}.npy',
                hr.reshape(8, 4, 8, 4, 3).mean((1, 3)))
    return root / 'datasets'


def _png(path):
    return np.asarray(Image.open(path).convert('RGB'), dtype=np.int16)


def test_srcnn_fit_then_predict_cli(tmp_path):
    from srtpu_torch.cli import main
    datasets = _write_datasets(tmp_path)
    net = ['--model', 'SRCNN', '--device', 'cpu', '--precision', '32']
    assert main(['fit', '--datasets_dir', str(datasets), '--train_datasets',
                 'Train', '--batch_size', '2', '--patch_size', '16',
                 '--max_epochs', '3', '--default_root_dir',
                 str(tmp_path / 'run'), *net]) == 0
    log = (tmp_path / 'run' / 'run.log').read_text()
    losses = [float(line.split('loss ')[1].split()[0])
              for line in log.splitlines() if '  loss ' in line]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert main(['predict', '--datasets_dir', str(datasets),
                 '--predict_datasets', 'Demo', '--weights',
                 str(tmp_path / 'run' / 'final_weights.pt'),
                 '--default_root_dir', str(tmp_path / 'out'), *net]) == 0
    assert _png(tmp_path / 'out' / 'Demo' / 'a.png').shape == (96, 160, 3)


def test_srcnn_predict_matches_srtpu_trainer(tmp_path):
    from srtpu.data import SRData as JaxSRData
    from srtpu.optim import build_optimizer
    from srtpu.train import Trainer as JaxTrainer
    from srtpu.train import TrainerConfig as JaxTrainerConfig
    from srtpu.train import create_train_state
    from srtpu_torch.data import SRData
    from srtpu_torch.train import Trainer, TrainerConfig

    datasets = _write_datasets(tmp_path)
    jm = jax_create_model('SRCNN', scale_factor=4)
    state = create_train_state(jm, build_optimizer('ADAM', []),
                               jax.random.PRNGKey(5),
                               jnp.zeros((1, 8, 8, 3)))
    trainer = JaxTrainer(JaxTrainerConfig(
        default_root_dir=str(tmp_path / 'jax')))
    try:
        trainer.predict(state, JaxSRData(
            datasets_dir=datasets, predict_datasets=['Demo'],
            scale_factor=4, eval_datasets=[], train_datasets=[]))
    finally:
        trainer.close()
    model = create_model('SRCNN', generator=torch.Generator().manual_seed(0))
    model.load_state_dict(params_from_jax(
        _tree_np({'params': state.params})))
    written = Trainer(TrainerConfig(default_root_dir=str(tmp_path / 'port'))) \
        .predict(model, SRData(datasets_dir=str(datasets),
                               predict_datasets=['Demo'], scale_factor=4))
    assert [p.name for p in written] == ['a.png', 'b.png']
    for name, shape in (('a', (96, 160, 3)), ('b', (128, 128, 3)),
                        ('a_center', (96, 96, 3))):
        port = _png(tmp_path / 'port' / 'Demo' / f'{name}.png')
        ref = _png(tmp_path / 'jax' / 'Demo' / f'{name}.png')
        assert port.shape == ref.shape == shape
        assert np.abs(port - ref).max() <= 1
