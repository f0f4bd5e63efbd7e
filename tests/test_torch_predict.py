"""The port's predict slice on the CPU.

(d) srtpu_torch Trainer.predict against srtpu Trainer.predict on two tiny
    images, one not a multiple of the 32-pixel bucket: same weights (the
    JAX tree through srtpu_torch.convert), f32, PNGs equal to +-1 uint8
    level (the two sides sum in another order, so a value next to a
    rounding boundary can land one level apart);
(e) importing srtpu_torch and running its CPU fit and predict leaves jax,
    flax and srtpu out of sys.modules;
(f) --device cuda without CUDA raises.
Plus the pieces the slice is built from: PNG writing, bucket padding and
center crops against srtpu's.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from srtpu.data import pipeline as jax_pipeline
from srtpu.utils.logging import save_image as jax_save_image
from srtpu_torch.data import center_crop, pad_to_bucket
from srtpu_torch.utils.logging import save_image

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _png(path):
    return np.asarray(Image.open(path).convert('RGB'), dtype=np.int16)


def test_save_image_matches_srtpu(tmp_path):
    img = np.random.default_rng(0).random((13, 17, 3), np.float32) * 1.2 - 0.1
    save_image(img, tmp_path / 'port.png')
    jax_save_image(img, tmp_path / 'jax.png')
    np.testing.assert_array_equal(_png(tmp_path / 'port.png'),
                                  _png(tmp_path / 'jax.png'))


@pytest.mark.parametrize('shape', [(20, 27), (32, 32), (33, 64)])
def test_pad_and_crop_match_srtpu(shape):
    img = np.random.default_rng(1).random((*shape, 3), np.float32)
    got, size = pad_to_bucket(img, 32)
    ref, ref_size = jax_pipeline.pad_to_bucket(img, 32)
    assert size == ref_size
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(center_crop(img, 24, 30),
                                  jax_pipeline.center_crop(img, 24, 30))


def _write_dataset(root):
    demo = root / 'datasets' / 'Demo'
    demo.mkdir(parents=True)
    rng = np.random.default_rng(7)
    for name, (h, w) in (('a', (24, 40)), ('b', (32, 32))):
        # smooth-ish content so the SR image is not all clipped
        lo = rng.random((h // 4 + 1, w // 4 + 1, 3))
        img = np.kron(lo, np.ones((4, 4, 1)))[:h, :w]
        Image.fromarray((img * 255).astype(np.uint8)) \
            .save(demo / f'{name}.png')
    return root / 'datasets'


def test_predict_matches_srtpu_trainer(tmp_path):
    from srtpu.data import SRData as JaxSRData
    from srtpu.models import create_model as jax_create_model
    from srtpu.optim import build_optimizer
    from srtpu.train import Trainer as JaxTrainer
    from srtpu.train import TrainerConfig as JaxTrainerConfig
    from srtpu.train import create_train_state
    from srtpu_torch.convert import params_from_jax
    from srtpu_torch.data import SRData
    from srtpu_torch.models import create_model
    from srtpu_torch.train import Trainer, TrainerConfig

    datasets = _write_dataset(tmp_path)
    kw = dict(scale_factor=4, n_feats=16, n_resblocks=2)
    jm = jax_create_model('EDSR', **kw)
    state = create_train_state(jm, build_optimizer('ADAM', []),
                               jax.random.PRNGKey(3),
                               jnp.zeros((1, 8, 8, 3)))
    JaxTrainer(JaxTrainerConfig(default_root_dir=str(tmp_path / 'jax'))) \
        .predict(state, JaxSRData(datasets_dir=datasets,
                                  predict_datasets=['Demo'], scale_factor=4,
                                  eval_datasets=[], train_datasets=[]))

    model = create_model('EDSR', generator=torch.Generator().manual_seed(0),
                         **kw)
    tree = jax.tree_util.tree_map(np.asarray, {'params': state.params})
    model.load_state_dict(params_from_jax(tree))
    written = Trainer(TrainerConfig(default_root_dir=str(tmp_path / 'port'))) \
        .predict(model, SRData(datasets_dir=str(datasets),
                               predict_datasets=['Demo'], scale_factor=4))
    assert [p.name for p in written] == ['a.png', 'b.png']
    for name, shape in (('a', (96, 160, 3)), ('b', (128, 128, 3)),
                        ('a_center', (96, 96, 3)), ('b_center', (96, 96, 3))):
        port = _png(tmp_path / 'port' / 'Demo' / f'{name}.png')
        ref = _png(tmp_path / 'jax' / 'Demo' / f'{name}.png')
        assert port.shape == ref.shape == shape
        assert np.abs(port - ref).max() <= 1


def _run(code, cwd):
    return subprocess.run([sys.executable, '-c', code], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env={'PATH': '/usr/bin:/bin',
                               'PYTHONPATH': str(REPO),
                               'HOME': str(cwd)})


def test_predict_cli_imports_no_jax(tmp_path):
    """``fit`` then ``predict`` (with the weights fit wrote) through the
    CLI, in a process that must never import jax, flax or srtpu."""
    datasets = _write_dataset(tmp_path)
    train = datasets / 'Train'
    (train / 'HR').mkdir(parents=True)
    (train / 'LR' / 'X4').mkdir(parents=True)
    rng = np.random.default_rng(8)
    for i in range(2):
        hr = rng.random((32, 32, 3), np.float32)
        np.save(train / 'HR' / f'{i}.npy', hr)
        np.save(train / 'LR' / 'X4' / f'{i}.npy',
                hr.reshape(8, 4, 8, 4, 3).mean((1, 3)))
    code = (
        'import sys\n'
        'import srtpu_torch.convert\n'
        'from srtpu_torch.cli import main\n'
        'net = ["--device", "cpu", "--n_feats", "8", "--n_resblocks", "1"]\n'
        f'fit = main(["fit", "--datasets_dir", {str(datasets)!r}, '
        '"--train_datasets", "Train", "--batch_size", "2", '
        '"--patch_size", "16", "--max_epochs", "1", '
        '"--default_root_dir", "run", *net])\n'
        f'rc = main(["predict", "--datasets_dir", {str(datasets)!r}, '
        '"--predict_datasets", "Demo", "--default_root_dir", "out", '
        '"--weights", "run/final_weights.pt", *net])\n'
        'bad = sorted(m for m in sys.modules\n'
        '             if m.split(".")[0] in ("jax", "flax", "srtpu"))\n'
        'print(fit, rc, bad)\n')
    proc = _run(code, tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == '0 0 []'
    assert 'epoch 1/1  loss' in (tmp_path / 'run' / 'run.log').read_text()
    assert _png(tmp_path / 'out' / 'Demo' / 'a.png').shape == (96, 160, 3)


def test_predict_cli_cuda_without_card_raises(tmp_path):
    from srtpu_torch.cli import main
    if torch.cuda.is_available():
        pytest.skip('this host has a card: the no-card error cannot show')
    datasets = _write_dataset(tmp_path)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        main(['predict', '--datasets_dir', str(datasets),
              '--predict_datasets', 'Demo', '--device', 'cuda',
              '--default_root_dir', str(tmp_path / 'out')])
    assert not (tmp_path / 'out').exists()
