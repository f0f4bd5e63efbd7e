"""F14: srtpu gives SRResNet, RDN and DDBPN a ``use_pallas`` field, 'cs'
by default (srtpu/models/srresnet.py:33, rdn.py:60, ddbpn.py:229), and
any other value runs srtpu's XLA math with XLA's roundings. The port
runs both: 'cs', given or not, builds the model the port has always
built, through ``create_model`` (which once dropped the keyword) as
through the class. False and True, srtpu's XLA routes, are held against
srtpu in ``test_torch_xla_routes.py``; SRGAN's half of F14 (its
``False`` route) in ``test_torch_srgan.py``. Tiny widths: no forward runs
here."""

import pytest
import torch

from srtpu_torch.models import create_model

MODELS = {'SRResNet': dict(n_feats=16, n_resblocks=1), 'RDN': dict(),
          'DDBPN': dict(n0=32, nr=16, depth=2)}


@pytest.mark.parametrize('name', sorted(MODELS))
def test_cs_given_or_not_builds_the_same_model(name):
    kw = MODELS[name]
    models = [create_model(name, scale_factor=2,
                           generator=torch.Generator().manual_seed(0),
                           **kw, **extra)
              for extra in ({}, {'use_pallas': 'cs'})]
    a, b = (m.state_dict() for m in models)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
