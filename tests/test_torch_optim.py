"""F6: the port's build_optimizer against srtpu's (optax) where the two
once parted, on the CPU.

* The default lr follows the name as written, as srtpu's does
  (srtpu/optim.py:142: ``1e-3 if name not in ('SGD', 'RMSprop') else
  1e-2``): ``SGD`` trains at 1e-2, ``sgd`` at 1e-3.
* ``nesterov=true`` with momentum 0 is plain SGD, as optax's trace with
  decay 0 is; torch's SGD refuses it as it stands.

Each case runs a few updates from the same params and gradients on both
sides: within 1e-6 of the largest magnitude (optax and torch order the
same f32 arithmetic differently).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from srtpu.optim import build_optimizer as jax_build_optimizer
from srtpu_torch.optim import build_optimizer


@pytest.mark.parametrize('name,params', [
    ('sgd', []), ('SGD', []), ('adam', []),
    ('SGD', ['nesterov=true']),
    ('sgd', ['momentum=0', 'nesterov=true'])])
def test_build_optimizer_matches_srtpu(name, params):
    rng = np.random.default_rng(4)
    p0 = rng.standard_normal((3, 4)).astype(np.float32)
    grads = [rng.standard_normal((3, 4)).astype(np.float32)
             for _ in range(5)]
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
    assert not np.allclose(ref, p0)
    np.testing.assert_allclose(tp.detach().numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize('name,lr', [('SGD', 1e-2), ('sgd', 1e-3),
                                     ('Sgd', 1e-3), ('ADAM', 1e-3),
                                     ('adam', 1e-3)])
def test_default_lr_follows_the_name_as_written(name, lr):
    opt = build_optimizer(name, [], [torch.nn.Parameter(torch.zeros(2))])
    assert opt.param_groups[0]['lr'] == lr
