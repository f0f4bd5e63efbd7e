"""The port's EDSR forward against srtpu's EDSR.apply on the CPU.

(c) Both JAX parameter trees — the default use_pallas='cs' tree and the
use_pallas=False tree — go through srtpu_torch.convert into the port,
at x2, x3, x4 and x8 (n_feats=16, n_resblocks=2): against the CPU XLA
path in f32 at 1e-4 abs (test_ops_cs.py:566 uses the same), and at one
size against the interpret-mode Pallas kernels in f32 and in bf16.

The bf16 tolerance is 2^-6 abs on outputs of magnitude below 2 (four
bf16 rounding steps at 1.0). Port and Pallas path round at the same
points, so only a sum next to a rounding boundary flips one step; the
skip connections carry such a flip on to the output, where a few may
add up.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srtpu.models import create_model as jax_create_model
from srtpu.ops import cs_conv
from srtpu_torch.convert import load_npz, params_from_jax
from srtpu_torch.models import create_model

torch.set_num_threads(1)

KW = dict(n_feats=16, n_resblocks=2)


def _tree_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _port(scale, params, dtype=None):
    model = create_model('EDSR', scale_factor=scale, dtype=dtype,
                         generator=torch.Generator().manual_seed(0), **KW)
    model.load_state_dict(params_from_jax(_tree_np(params)))
    return model


def _port_out(model, x):
    with torch.inference_mode():
        return model(torch.from_numpy(x)).float().numpy()


@pytest.mark.parametrize('use_pallas', ['cs', False])
@pytest.mark.parametrize('scale', [2, 3, 4, 8])
def test_edsr_matches_jax_xla_path(scale, use_pallas):
    x = np.random.default_rng(scale).random((1, 6, 7, 3), np.float32)
    m = jax_create_model('EDSR', scale_factor=scale, use_pallas=use_pallas,
                         **KW)
    params = m.init(jax.random.PRNGKey(scale), jnp.asarray(x))
    ref = np.asarray(m.apply(params, jnp.asarray(x)))
    got = _port_out(_port(scale, params), x)
    assert got.shape == ref.shape == (1, 6 * scale, 7 * scale, 3)
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_edsr_matches_jax_pallas_interpret(monkeypatch, dtype):
    """x2 at (2, 8, 8): the trunk and tail take the CS kernels (checked
    through cs_conv.PATH_LOG), run in interpret mode."""
    monkeypatch.setenv('SRTPU_CS_OFF_TPU', '1')
    jdt, tdt = {'f32': (None, None),
                'bf16': (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = np.random.default_rng(0).random((2, 8, 8, 3), np.float32)
    m = jax_create_model('EDSR', scale_factor=2, dtype=jdt, **KW)
    params = m.init(jax.random.PRNGKey(1), jnp.asarray(x))
    cs_conv.PATH_LOG.clear()
    ref = np.asarray(m.apply(params, jnp.asarray(x)).astype(jnp.float32))
    assert set(cs_conv.PATH_LOG.values()) == {'cs'}
    got = _port_out(_port(2, params, tdt), x)
    atol = 1e-4 if dtype == 'f32' else 2.0 ** -6
    assert np.abs(ref).max() < 2
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def test_convert_npz_roundtrip(tmp_path):
    """A flat .npz as a JAX host writes it converts to the same state dict
    as the tree itself, and the CLI writes a loadable .pt."""
    from srtpu_torch.convert import main
    m = jax_create_model('EDSR', scale_factor=4, **KW)
    params = _tree_np(m.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 3))))
    flat = {'/'.join(k.key for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(tmp_path / 'p.npz', **flat)
    sd = params_from_jax(load_npz(tmp_path / 'p.npz'))
    ref = params_from_jax(params)
    assert sd.keys() == ref.keys()
    for k in sd:
        torch.testing.assert_close(sd[k], ref[k], rtol=0, atol=0)
    assert main([str(tmp_path / 'p.npz'), str(tmp_path / 'p.pt')]) == 0
    loaded = torch.load(tmp_path / 'p.pt', weights_only=True)
    _port(4, params).load_state_dict(loaded)


def test_create_model_registry():
    # every srtpu family is registered (SRCNN, the last, since its port)
    from srtpu.models import MODEL_REGISTRY as JAX_REGISTRY
    from srtpu_torch.models import MODEL_REGISTRY, SRCNN
    assert set(MODEL_REGISTRY) == set(JAX_REGISTRY)
    assert isinstance(create_model('srcnn', generator=torch.Generator()),
                      SRCNN)
    with pytest.raises(ValueError, match='Unknown model'):
        create_model('NoSuchNet', generator=torch.Generator())
    # kwargs the model doesn't declare are dropped, as in srtpu
    m = create_model('edsr', scale_factor=2, patch_size=48,
                     generator=torch.Generator().manual_seed(0), **KW)
    assert m.scale_factor == 2
