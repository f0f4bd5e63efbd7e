"""The port's config system (srtpu_torch/config.py) against srtpu's:
``load_config`` and ``link_arguments`` give srtpu's dicts for
``configs/all.yml``, ``configs/train_default_sr.yml`` and a set of
dotted overrides; ``split_training_args`` splits alike; ``build_all``
gives srtpu's hparams snapshot and TrainerConfig values and the model it
names; without PyYAML ``load_config`` raises naming it; ``fit
--config`` trains from srtpu's YAML."""

import json
import sys
from dataclasses import fields
from pathlib import Path

import pytest
import torch

from srtpu import config as jax_config
from srtpu_torch import config

REPO = Path(__file__).resolve().parents[1]
ALL = REPO / 'configs' / 'all.yml'
DEFAULT = REPO / 'configs' / 'train_default_sr.yml'
OVERRIDES = ['trainer.max_epochs=3', 'data.batch_size=2',
             'model.init_args.n_feats=16', 'model.init_args.n_resblocks=2',
             'data.eval_datasets=[Val]', 'trainer.gradient_clip_val=0.5',
             'model.init_args.optimizer_params=[lr=1e-3]',
             'trainer.default_root_dir=run_${model.class_path}']
CASES = {'all': ([ALL], []), 'default': ([DEFAULT], []),
         'default+overrides': ([DEFAULT], OVERRIDES),
         'both+overrides': ([ALL, DEFAULT], OVERRIDES[:4]),
         'overrides': ([], OVERRIDES)}


@pytest.mark.parametrize('case', sorted(CASES))
def test_load_and_link_match_srtpu(case):
    paths, overrides = CASES[case]
    got = config.load_config(paths, overrides)
    want = jax_config.load_config(paths, overrides)
    assert got == want
    linked = config.link_arguments(got)
    assert linked == jax_config.link_arguments(want)
    init = linked['model'].get('init_args', {})
    assert config.split_training_args(init) == \
        jax_config.split_training_args(init)


def test_constants_are_srtpu_s():
    assert config.DEFAULTS == jax_config.DEFAULTS
    assert config.TRAINING_KEYS == jax_config.TRAINING_KEYS
    assert config.TRAINING_DEFAULTS == jax_config.TRAINING_DEFAULTS


def test_build_all_matches_srtpu():
    cfg = config.load_config([DEFAULT], OVERRIDES)
    model, dm, tcfg, fit_kw = config.build_all(cfg)
    jm, jdm, jtcfg, jfit_kw = jax_config.build_all(
        jax_config.load_config([DEFAULT], OVERRIDES))
    assert fit_kw == jfit_kw
    ours = {f.name for f in fields(tcfg)}
    for f in fields(jtcfg):
        if f.name in ours and f.name != 'eval_tile':
            assert getattr(tcfg, f.name) == getattr(jtcfg, f.name), f.name
    assert type(model).__name__ == 'EDSR' and model.use_pallas == 'cs'
    assert model.n_feats == 16 and model.trunk.w1.shape[0] == 2
    assert dm.batch_size == 2 and dm.eval_dataset_names == ['Val']
    assert tcfg.eval_tile == 0       # srtpu's 80 is its TPU lane budget


def test_load_config_without_yaml_names_pyyaml(monkeypatch):
    monkeypatch.setitem(sys.modules, 'yaml', None)
    with pytest.raises(ImportError, match='PyYAML'):
        config.load_config([DEFAULT])
    # no file, no override: nothing to parse
    assert config.load_config() == config.DEFAULTS


@pytest.mark.parametrize('have_yaml', [True, False])
def test_checkpoint_overrides_share_config_parsing(monkeypatch, have_yaml):
    """``validate`` / ``predict --checkpoint``'s ``data.*`` overrides are
    read by ``config``'s own parser: YAML where PyYAML imports, else JSON,
    else the string."""
    from srtpu_torch.cli import _overrides
    if not have_yaml:
        monkeypatch.setitem(sys.modules, 'yaml', None)
    items = ['data.scale_factor=3', 'data.eval_datasets=["Val", "B100"]',
             'data.datasets_dir=/data/sr', 'data.eval_bucket=null']
    want = {'scale_factor': 3, 'eval_datasets': ['Val', 'B100'],
            'datasets_dir': '/data/sr', 'eval_bucket': None}
    assert _overrides(items) == want
    assert config.load_config(None, items)['data'] == {
        **config.DEFAULTS['data'], **want}
    with pytest.raises(ValueError, match='only data'):
        _overrides(['trainer.max_epochs=2'])


def test_fit_from_config(tmp_path):
    from srtpu_torch.cli import main
    from test_torch_fit_val import write_sets
    datasets = write_sets(tmp_path, n_train=2)
    root = tmp_path / 'run'
    assert main(['fit', '--config', str(DEFAULT), '--device', 'cpu',
                 'trainer.max_epochs=2',
                 'data.batch_size=2', 'data.patch_size=32',
                 f'data.datasets_dir={datasets}',
                 'data.train_datasets=[Train]', 'data.eval_datasets=[Val]',
                 'model.init_args.n_feats=16', 'model.init_args.n_resblocks=2',
                 'trainer.precision=32', 'trainer.num_sanity_val_steps=0',
                 'trainer.monitor=Val/PSNR',
                 f'trainer.default_root_dir={root}']) == 0
    hp = json.loads((root / 'checkpoints' / 'hparams.json').read_text())
    assert hp['model'] == 'EDSR' and hp['monitor'] == 'Val/PSNR'
    assert hp['init_args']['n_feats'] == 16 and hp['precision'] == '32'
    assert sorted(p.name for p in (root / 'checkpoints' / 'top')
                  .iterdir()) == ['2']
    assert torch.load(root / 'final_weights.pt', weights_only=True)[
        'trunk.w1'].shape[0] == 2
