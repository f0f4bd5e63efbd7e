"""The port's eval path against srtpu's on the CPU, f32, the same weights
(the JAX tree through srtpu_torch.convert) and the same .npy eval set.

(a) ``EvalLoader`` batches (LR, HR, mask, hr_size) equal to srtpu's,
    bit for bit, on a ragged set (a side not a multiple of the scale, LR
    sides not multiples of the 32-pixel bucket);
(b) ``make_eval_step`` against srtpu's on a tiny EDSR: the clipped SR
    within 1e-5, each metric within the metric tolerances;
(c) ``Trainer.validate`` against srtpu's ``Trainer.validate`` on a tiny
    EDSR (2 resblocks, 16 features) and a tiny RCAN: the same
    ``{dataset/metric}`` keys, each value within the metric tolerances
    (PSNR 1e-4 dB, SSIM and MS-SSIM 1e-5), and srtpu's ``val`` line;
(d) the ``validate`` CLI prints those keys, sorted, with srtpu's values;
(e) ``validate`` and SRCNN ``predict`` through the CLI import no jax,
    flax or srtpu; ``validate --device cuda`` without a card raises.
"""

import logging
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srtpu.data import SRData as JaxSRData
from srtpu.data.pipeline import EvalLoader as JaxEvalLoader
from srtpu.data.sources import NpySource as JaxNpySource
from srtpu.metrics import build_metrics as jax_build_metrics
from srtpu.models import create_model as jax_create_model
from srtpu.optim import build_optimizer
from srtpu.train import Trainer as JaxTrainer
from srtpu.train import TrainerConfig as JaxTrainerConfig
from srtpu.train import create_train_state
from srtpu.train.steps import make_eval_step as jax_make_eval_step
from srtpu_torch.convert import params_from_jax
from srtpu_torch.data import EvalLoader, NpySource, SRData
from srtpu_torch.metrics import build_metrics
from srtpu_torch.models import create_model
from srtpu_torch.train import Trainer, TrainerConfig, make_eval_step

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TOL = {'PSNR': 1e-4, 'SSIM': 1e-5, 'MS-SSIM': 1e-5}
METRICS = ('PSNR', 'SSIM', 'MS-SSIM')
# HR sizes: 176 x 200 (aligned to x4, LR 44 x 50 bucket-padded to 64 x
# 64) and 190 x 181 (reconciled to 188 x 180, LR 47 x 45); MS-SSIM needs
# HR sides past 160
HR_SIZES = ((176, 200), (190, 181))
MODELS = {'EDSR': dict(n_feats=16, n_resblocks=2),
          'RCAN': dict(n_feats=16, n_resgroups=2, n_resblocks=2,
                       reduction=4)}


def _write_eval_set(root: Path, name: str = 'Val', scale: int = 4) -> Path:
    rng = np.random.default_rng(17)
    hr_dir = root / 'datasets' / name / 'HR'
    lr_dir = root / 'datasets' / name / 'LR' / f'X{scale}'
    hr_dir.mkdir(parents=True)
    lr_dir.mkdir(parents=True)
    for i, (h, w) in enumerate(HR_SIZES):
        lo = rng.random((h // 8 + 1, w // 8 + 1, 3))
        hr = (np.kron(lo, np.ones((8, 8, 1)))[:h, :w] * 0.8
              + rng.random((h, w, 3)) * 0.2).astype(np.float32)
        np.save(hr_dir / f'{i}.npy', hr)
        lh, lw = h // scale, w // scale
        lr = hr[:lh * scale, :lw * scale].reshape(
            lh, scale, lw, scale, 3).mean((1, 3))
        np.save(lr_dir / f'{i}.npy', lr.astype(np.float32))
    return root / 'datasets'


def _pair(name: str, seed: int = 3):
    """srtpu's train state of a tiny model and the port's model from it."""
    jm = jax_create_model(name, scale_factor=4, **MODELS[name])
    state = create_train_state(jm, build_optimizer('ADAM', []),
                               jax.random.PRNGKey(seed),
                               jnp.zeros((1, 16, 16, 3)))
    model = create_model(name, scale_factor=4,
                         generator=torch.Generator().manual_seed(0),
                         **MODELS[name])
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  {'params': state.params})
    model.load_state_dict(params_from_jax(tree))
    return jm, state, model


def test_eval_loader_matches_srtpu(tmp_path):
    datasets = _write_eval_set(tmp_path)
    hr, lr = datasets / 'Val' / 'HR', datasets / 'Val' / 'LR' / 'X4'
    ref = list(JaxEvalLoader(JaxNpySource(hr, lr, 4, mode='eval'), 4,
                             bucket=32))
    got = list(EvalLoader(NpySource(hr, lr, 4), 4, bucket=32))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        for key in ('lr', 'hr', 'mask'):
            np.testing.assert_array_equal(getattr(g, key), getattr(r, key))
        assert g.hr_size == r.hr_size and g.names == r.names
    assert got[1].hr_size == (188, 180) and got[1].lr.shape == (1, 64, 64, 3)


def test_eval_step_matches_srtpu(tmp_path):
    datasets = _write_eval_set(tmp_path)
    jm, state, model = _pair('EDSR')
    hr, lr = datasets / 'Val' / 'HR', datasets / 'Val' / 'LR' / 'X4'
    ref_step = jax_make_eval_step(jax_build_metrics(list(METRICS)))
    step = make_eval_step(model, build_metrics(METRICS))
    for batch in EvalLoader(NpySource(hr, lr, 4), 4):
        sr_ref, res_ref = ref_step(state, jnp.asarray(batch.lr),
                                   jnp.asarray(batch.hr),
                                   jnp.asarray(batch.mask))
        t = torch.from_numpy
        sr, res = step(t(batch.lr), t(batch.hr), t(batch.mask))
        np.testing.assert_allclose(sr.numpy(), np.asarray(sr_ref), rtol=0,
                                   atol=1e-5)
        assert list(res) == sorted(METRICS)   # srtpu's jit sorts them
        for k, v in res.items():
            assert abs(float(v) - float(res_ref[k])) <= TOL[k], k


def _jax_validate(tmp_path, datasets, name, state, jm):
    trainer = JaxTrainer(JaxTrainerConfig(
        default_root_dir=str(tmp_path / 'jax'), metrics=METRICS))
    try:
        return trainer.validate(state, JaxSRData(
            datasets_dir=datasets, eval_datasets=['Val', 'Val2'],
            train_datasets=[], scale_factor=4), model=jm)
    finally:
        trainer.close()


@pytest.mark.parametrize('name', sorted(MODELS))
def test_validate_matches_srtpu(tmp_path, name, caplog):
    datasets = _write_eval_set(tmp_path)
    _write_eval_set(tmp_path, 'Val2')
    jm, state, model = _pair(name)
    ref = _jax_validate(tmp_path, datasets, name, state, jm)
    with caplog.at_level(logging.INFO, logger='srtpu_torch'):
        got = Trainer(TrainerConfig(default_root_dir=str(tmp_path / 'port'),
                                    metrics=METRICS)).validate(
            model, SRData(datasets_dir=str(datasets),
                          eval_datasets=['Val', 'Val2']))
    assert list(got) == list(ref) == [f'{d}/{m}' for d in ('Val', 'Val2')
                                      for m in sorted(METRICS)]
    for k, v in got.items():
        assert abs(v - ref[k]) <= TOL[k.split('/')[1]], (k, v, ref[k])
    assert any(r.getMessage().startswith('val @ epoch 1: Val/MS-SSIM=')
               for r in caplog.records)
    # limit_val_batches: the first image of each dataset alone
    one = Trainer(TrainerConfig(default_root_dir=str(tmp_path / 'one'),
                                limit_val_batches=1)).validate(
        model, SRData(datasets_dir=str(datasets), eval_datasets=['Val']),
        metrics=['PSNR'])
    assert list(one) == ['Val/PSNR'] and one['Val/PSNR'] != got['Val/PSNR']


def test_validate_cli_prints_srtpu_keys(tmp_path, capsys):
    from srtpu_torch.cli import main
    datasets = _write_eval_set(tmp_path)
    jm, state, model = _pair('EDSR')
    torch.save(model.state_dict(), tmp_path / 'w.pt')
    trainer = JaxTrainer(JaxTrainerConfig(
        default_root_dir=str(tmp_path / 'jax'), metrics=METRICS))
    try:
        ref = trainer.validate(state, JaxSRData(
            datasets_dir=datasets, eval_datasets=['Val'], train_datasets=[],
            scale_factor=4), model=jm)
    finally:
        trainer.close()
    capsys.readouterr()
    assert main(['validate', '--datasets_dir', str(datasets),
                 '--eval_datasets', 'Val', '--weights', str(tmp_path / 'w.pt'),
                 '--metrics', *METRICS, '--device', 'cpu', '--precision', '32',
                 '--n_feats', '16', '--n_resblocks', '2',
                 '--default_root_dir', str(tmp_path / 'out')]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(': ')[0] for ln in lines] == sorted(ref)
    for ln in lines:
        k, v = ln.split(': ')
        assert abs(float(v) - ref[k]) <= 1e-4 + TOL[k.split('/')[1]], ln


def test_validate_and_srcnn_predict_import_no_jax(tmp_path):
    """``validate`` (EDSR, then with --eval_tile) and SRCNN ``predict``
    through the CLI, in a process that must never import jax, flax or
    srtpu."""
    datasets = _write_eval_set(tmp_path)
    code = (
        'import sys\n'
        'from srtpu_torch.cli import main\n'
        'net = ["--device", "cpu", "--n_feats", "8", "--n_resblocks", "1"]\n'
        f'd = ["--datasets_dir", {str(datasets)!r}]\n'
        'a = main(["validate", *d, "--eval_datasets", "Val", "--metrics",\n'
        '          "PSNR", "SSIM", "MS-SSIM", *net])\n'
        'b = main(["validate", *d, "--eval_datasets", "Val",\n'
        '          "--eval_tile", "32", *net])\n'
        'c = main(["predict", *d, "--predict_datasets", "Val",\n'
        '          "--model", "SRCNN", "--device", "cpu",\n'
        '          "--default_root_dir", "out"])\n'
        'bad = sorted(m for m in sys.modules\n'
        '             if m.split(".")[0] in ("jax", "flax", "srtpu"))\n'
        'print(a, b, c, bad)\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env={'PATH': '/usr/bin:/bin',
                               'PYTHONPATH': str(REPO),
                               'HOME': str(tmp_path)})
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout.strip().splitlines()
    assert out[-1] == '0 0 0 []'
    assert sum(ln.startswith('Val/MS-SSIM: ') for ln in out) == 1
    assert (tmp_path / 'out' / 'Val' / '1.png').is_file()


def test_validate_cli_cuda_without_card_raises(tmp_path):
    from srtpu_torch.cli import main
    if torch.cuda.is_available():
        pytest.skip('this host has a card: the no-card error cannot show')
    datasets = _write_eval_set(tmp_path)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        main(['validate', '--datasets_dir', str(datasets),
              '--eval_datasets', 'Val', '--device', 'cuda'])
