"""chip_smoke.py holds every K2 shape the port's main paths launch.

K2 (``ops.conv.conv3x3_fwd`` / ``conv3x3_bwd``) takes any k = 3 or 5 conv
whose channel counts are multiples of 16, and its engine picks its tile
plan from (k, c_in, c_out). The card check, chip_smoke.py, holds the
kernel against its plain version at a fixed list of shapes, so a model
path that launches a shape outside that list would run unchecked on the
card. Here, on the CPU (where the wrappers run their plain versions),
each model at full width and a tiny image (batch 1, LR 8x8, bf16) runs a
forward in eval mode and a train-mode forward and backward, every (k,
c_in, c_out) reaching the two wrappers is recorded, and each must be
among the shapes chip_smoke's K2 cases hold: the forward shapes of
``kernel_cases`` (phase 2), ``K2G_SHAPES`` (2f) and ``K2_TRAIN_FWD``
(2k), the backward shapes of ``bwd_cases`` (2b) and ``K2G_SHAPES``, all
built here with device ``cpu``. One case per model, so each counts.
"""

import pytest
import torch

import chip_smoke
from srtpu_torch.models import create_model
from srtpu_torch.ops import conv as conv_mod
from srtpu_torch.ops import rcab as rcab_mod

torch.set_num_threads(1)

# chip_smoke's configurations: full width and depth
MODELS = {
    'EDSR-x4': ('EDSR', 4, {}),
    'EDSR-x3': ('EDSR', 3, {}),
    'SRResNet-x4': ('SRResNet', 4, {}),
    'SRResNet-x3': ('SRResNet', 3, {}),
    'RCAN-10x16': ('RCAN', 4, dict(n_resgroups=chip_smoke.GROUPS,
                                   n_resblocks=chip_smoke.RCABS,
                                   reduction=chip_smoke.REDUCTION)),
    'RDN-B': ('RDN', 4, dict(rdn_config='B', growth0=chip_smoke.RDN_G0)),
    'DDBPN-x4': ('DDBPN', 4, dict(n0=chip_smoke.DDBPN_N0,
                                  nr=chip_smoke.DDBPN_NR,
                                  depth=chip_smoke.DDBPN_DEPTH)),
}


def _shape(w) -> tuple:
    return w.shape[0], w.shape[-2], w.shape[-1]


def held() -> tuple[set, set]:
    """(forward, backward) (k, c_in, c_out) that chip_smoke holds K2 to
    its plain version at on the card."""
    cpu = torch.device('cpu')
    fwd = {_shape(args[1]) for kid, _, _, _, args, _, _ in
           chip_smoke.kernel_cases(8, 8, cpu) if kid in ('K2', 'K25')}
    bwd = {_shape(args[1]) for kid, _, _, _, args, _, _ in
           chip_smoke.bwd_cases(1, 4, 4, cpu) if kid in ('K2b', 'K25b')}
    general = {(k, ci, co) for ci, co, k in chip_smoke.K2G_SHAPES}
    train = {(k, ci, co) for shapes in chip_smoke.K2_TRAIN_FWD.values()
             for k, ci, co, _ in shapes}
    return fwd | general | train, bwd | general


@pytest.fixture(scope='module')
def held_shapes():
    return held()


@pytest.mark.parametrize('case', sorted(MODELS))
def test_main_path_k2_shapes_are_held_by_chip_smoke(monkeypatch, held_shapes,
                                                    case):
    name, scale, kw = MODELS[case]
    seen = {'fwd': set(), 'bwd': set()}

    def recorder(fn, kind):
        def wrapped(x, w, *args, **kwargs):
            seen[kind].add(_shape(w))
            return fn(x, w, *args, **kwargs)
        return wrapped

    for mod in (conv_mod, rcab_mod):
        monkeypatch.setattr(mod, 'conv3x3_fwd',
                            recorder(conv_mod.conv3x3_fwd, 'fwd'))
        monkeypatch.setattr(mod, 'conv3x3_bwd',
                            recorder(conv_mod.conv3x3_bwd, 'bwd'))
    model = create_model(name, scale_factor=scale, dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(0), **kw)
    lr = torch.rand((1, 8, 8, 3), generator=torch.Generator().manual_seed(1))
    model.eval()
    with torch.no_grad():
        model(lr)
    model.train()
    y = model(lr)
    assert y.shape == (1, 8 * scale, 8 * scale, 3)
    y.float().mean().backward()
    assert seen['fwd'] and seen['bwd'], seen
    fwd, bwd = held_shapes
    assert seen['fwd'] <= fwd, sorted(seen['fwd'] - fwd)
    assert seen['bwd'] <= bwd, sorted(seen['bwd'] - bwd)
