"""srtpu_torch's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; they skip on a host without a card. On the card (which
has no JAX, so the repo's conftest is left out)::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: kernel and plain version round at the
same points and differ only in the order of the f32 sums, so an output
may land one bf16 step (2^-7 of the largest magnitude) away; K1's
skips carry such steps on through the blocks.
"""

import pytest
import torch

from srtpu_torch.models import create_model
from srtpu_torch.ops import (conv3x3_fwd, conv3x3_plain, trunk_fwd,
                             trunk_plain, upsample_fwd, upsample_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cudnn.allow_tf32 = False   # f32 plain references
    return torch.device('cuda', 0)


def _u(gen, shape, bound, device, dtype=torch.bfloat16):
    t = torch.empty(shape).uniform_(-bound, bound, generator=gen)
    return t.to(device, dtype)


def _conv(gen, cin, cout, device, lead=()):
    bound = (9 * cin) ** -0.5
    return (_u(gen, (*lead, 3, 3, cin, cout), bound, device),
            _u(gen, (*lead, cout), bound, device, torch.float32))


@pytest.mark.parametrize('h,w', [(1, 1), (7, 16), (9, 33), (40, 17)])
@pytest.mark.parametrize('case', ['close', 'pm', 'pd', 'ups', 'trunk'])
def test_kernel_matches_plain(device, case, h, w):
    gen = torch.Generator().manual_seed(h * 100 + w)
    batch = 2
    if case == 'trunk':
        w1, b1 = _conv(gen, 64, 64, device, (3,))
        w2, b2 = _conv(gen, 64, 64, device, (3,))
        args = (_u(gen, (batch, h, w, 64), 1.0, device), w1, b1, w2, b2, 0.5)
        fn, plain, steps = trunk_fwd, trunk_plain, 2
    elif case == 'ups':
        args = (_u(gen, (batch, h, w, 64), 1.0, device),
                *_conv(gen, 64, 256, device), 2)
        fn, plain, steps = upsample_fwd, upsample_plain, 1
    else:
        cin, cout = {'close': (64, 64), 'pm': (64, 256), 'pd': (256, 16)}[case]
        args = (_u(gen, (batch, h, w, cin), 1.0, device),
                *_conv(gen, cin, cout, device))
        fn, plain, steps = conv3x3_fwd, conv3x3_plain, 1
    before = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches > before
    ref = plain(*args)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    tol = steps * 2.0 ** -7 * ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize('scale', [2, 4, 8])
def test_edsr_kernel_path_matches_plain(device, scale):
    model = create_model('EDSR', scale_factor=scale, n_feats=64,
                         n_resblocks=2, dtype=torch.bfloat16, device=device,
                         generator=torch.Generator().manual_seed(scale))
    gen = torch.Generator().manual_seed(0)
    lr = torch.rand((1, 20, 28, 3), generator=gen).to(device)
    with torch.inference_mode():
        got = model(lr).float()
        ref = model(lr, plain=True).float()
    assert got.shape == (1, 20 * scale, 28 * scale, 3)
    assert (got - ref).abs().max().item() <= 2.0 ** -6


def test_wrapper_rejects_unsupported_shapes(device):
    x = torch.zeros(1, 4, 4, 32, dtype=torch.bfloat16, device=device)
    w = torch.zeros(3, 3, 32, 32, dtype=torch.bfloat16, device=device)
    b = torch.zeros(32, device=device)
    with pytest.raises(ValueError, match='no kernel'):
        conv3x3_fwd(x, w, b)
    with pytest.raises(TypeError):
        conv3x3_fwd(torch.zeros(1, 4, 4, 64, device=device),
                    torch.zeros(3, 3, 64, 64, device=device),
                    torch.zeros(64, device=device))
