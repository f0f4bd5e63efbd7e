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


# ------------------------- RMSprop and the Ranger family (item 16)
#
# srtpu's optax transforms on an srtpu model's tree against the port's
# optimizers on the same tree through ``srtpu_torch.convert`` (a pure
# relayout), the same gradients mapped the same way: N = 12 steps (past
# RAdam's variance threshold at the sixth, two lookahead syncs at k 6),
# the parameters within 1e-6 of each tensor's largest magnitude (the same
# f32 formulas in another evaluation order; pow and rsqrt may round an
# ulp apart); Ranger and RangerVA within 1e-5: RAdam's
# ro = ro_inf - 2 t b2^t / (1 - b2^t) subtracts two f32 values near
# 2 / (1 - b2) = 2000 on both sides, so an ulp of b2^t apart moves the
# rectification r by up to 5e-5 of itself in the first steps past the
# threshold.

import jax  # noqa: E402

from srtpu.models import create_model as jax_create_model  # noqa: E402
from srtpu.optim import _centralize  # noqa: E402
from srtpu_torch.convert import centralize_plan, params_from_jax  # noqa
from srtpu_torch.models import create_model  # noqa: E402
from srtpu_torch.optim import centralize, srtpu_centralize_rule  # noqa

ITEM16 = [('RMSprop', []), ('RMSprop', ['momentum=0.9']),
          ('RMSprop', ['momentum=0.9', 'weight_decay=1e-2', 'alpha=0.9',
                       'lr=1e-3']),
          ('Ranger', []), ('Ranger', ['weight_decay=1e-2', 'k=4']),
          ('RangerVA', []), ('RangerVA', ['weight_decay=1e-2',
                                          'betas=0.9,0.99']),
          ('RangerQH', []), ('RangerQH', ['weight_decay=1e-2',
                                          'nus=0.8,0.9', 'alpha=0.6'])]


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _jax_edsr(use_pallas='cs', **kw):
    jm = jax_create_model('EDSR', scale_factor=4, use_pallas=use_pallas,
                          **{'n_feats': 16, 'n_resblocks': 2, **kw})
    return _np_tree(dict(jm.init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8, 8, 3))))['params'])


@pytest.mark.parametrize('name,params', ITEM16)
def test_item16_optimizers_match_srtpu(name, params):
    tree = _jax_edsr()
    rng = np.random.default_rng(9)
    grads = [jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
        for _ in range(12)]
    tx = jax_build_optimizer(name, params)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    st = tx.init(jp)
    model = create_model('EDSR', scale_factor=4, n_feats=16, n_resblocks=2,
                         generator=torch.Generator())
    model.load_state_dict(params_from_jax({'params': tree}))
    named = dict(model.named_parameters())
    plan = {named[n]: v for n, v in centralize_plan(model).items()}
    opt = build_optimizer(name, params, named.values(), plan)
    for g in grads:
        upd, st = tx.update(jax.tree_util.tree_map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, upd)
        for n, t in params_from_jax({'params': g}).items():
            named[n].grad = t
        opt.step()
    want = params_from_jax({'params': _np_tree(jp)})
    start = params_from_jax({'params': tree})
    tol = 1e-5 if name in ('Ranger', 'RangerVA') else 1e-6
    for n, ref in want.items():
        assert not torch.equal(ref, start[n]), n
        np.testing.assert_allclose(named[n].detach().numpy(), ref.numpy(),
                                   rtol=0, atol=tol * ref.abs().max().item(),
                                   err_msg=n)


# every family's tree, each route the port runs; RCAN at 48 features
# also takes srtpu's rule on its (L, C, C / r) attention stacks
FAMILIES = [
    ('EDSR', dict(n_feats=16, n_resblocks=2), 'cs'),
    ('EDSR', dict(n_feats=16, n_resblocks=2), False),
    ('EDSR', dict(n_feats=16, n_resblocks=2), True),
    ('RCAN', dict(n_feats=16, n_resgroups=2, n_resblocks=2, reduction=4),
     'cs'),
    ('RCAN', dict(n_feats=48, n_resgroups=1, n_resblocks=2, reduction=4),
     'cs'),
    ('RCAN', dict(n_feats=48, n_resgroups=1, n_resblocks=2, reduction=4),
     False),
    ('RCAN', dict(n_feats=48, n_resgroups=1, n_resblocks=2, reduction=4),
     True),
    ('SRResNet', dict(n_feats=16, n_resblocks=2), 'cs'),
    ('RDN', dict(rdn_config='B', growth0=64), 'cs'),
    ('DDBPN', dict(n0=32, nr=16, depth=3), 'cs'),
    ('WDSR', dict(n_feats=16, n_resblocks=2), 'cs'),
    ('WDSR', dict(n_feats=16, n_resblocks=2), False),
    ('WDSR', dict(n_feats=16, n_resblocks=2), True),
    ('SRCNN', {}, None)]


@pytest.mark.parametrize('name,kw,route', FAMILIES)
def test_rangerva_centralizes_as_srtpu(name, kw, route):
    """srtpu's ``_centralize`` on its tree of the model, mapped through
    convert, equals the port's centralisation (``centralize_plan``) of
    the mapped gradients, parameter by parameter."""
    rk = {} if route is None else {'use_pallas': route}
    jm = jax_create_model(name, scale_factor=4, **kw, **rk)
    v = _np_tree(dict(jm.init(jax.random.PRNGKey(0),
                              jnp.zeros((1, 16, 16, 3)))))
    params, stats = v['params'], v.get('batch_stats', {})
    rng = np.random.default_rng(1)
    g = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    gc = _np_tree(_centralize().update(g, None)[0])
    raw = params_from_jax({'params': g, 'batch_stats': stats})
    want = params_from_jax({'params': gc, 'batch_stats': stats})
    model = create_model(name, scale_factor=4, generator=torch.Generator(),
                         **kw, **rk)
    plan = centralize_plan(model)
    assert set(plan) == {n for n, _ in model.named_parameters()}
    moved = 0
    for n, p in plan.items():
        got = centralize(raw[n], p)
        np.testing.assert_allclose(got.numpy(), want[n].numpy(), rtol=0,
                                   atol=1e-6, err_msg=n)
        moved += not torch.equal(raw[n], want[n])
    assert moved


def test_srtpu_centralize_rule_on_its_own_layout():
    """A tensor in srtpu's layout: its rule by shape, as ``_centralize``
    (4-D; 3-D with both last sides multiples of 3; nothing else)."""
    rng = np.random.default_rng(2)
    for shape in ((3, 3, 4, 6), (2, 6, 9), (2, 16, 4), (4, 6), (5,)):
        g = rng.standard_normal(shape).astype(np.float32)
        want = np.asarray(_centralize().update({'w': jnp.asarray(g)},
                                               None)[0]['w'])
        got = centralize(torch.from_numpy(g), srtpu_centralize_rule(shape))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_item16_state_is_made_when_built_and_counts_on_the_device():
    p = torch.nn.Parameter(torch.ones(3))
    for name in ('RMSprop', 'Ranger', 'RangerVA', 'RangerQH'):
        opt = build_optimizer(name, [], [p])
        st = opt.state[p]
        assert st and all(torch.is_tensor(v) for v in st.values())
        if name != 'RMSprop':
            assert st['count'].dtype == torch.float32 and \
                st['count'].dim() == 0 and torch.equal(st['slow'], p)
