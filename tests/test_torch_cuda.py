"""The port's CUDA kernels on the card (marker `cuda`): each kernel against
its plain PyTorch version, the autograd Function, the launch counters and
the wrapper checks.  They skip on a machine without a GPU; on one with a
GPU and nvcc run them with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(--noconftest: tests/conftest.py configures JAX, which such a machine may
not have; these tests need only torch and the port).

Tolerances: the expansion is pure data movement (bit-exact); the fold sums
at most 27 float32 terms per entry in another order than fold_plain (1e-5).
"""

import pytest
import torch

from nice_slam_tpu_torch.ops import expand as ex
from nice_slam_tpu_torch.ops.trilinear import expand_grid

pytestmark = pytest.mark.cuda

SHAPES = [(5, 4, 3), (1, 4, 3), (4, 1, 3), (4, 3, 1), (1, 1, 1), (2, 2, 2),
          (7, 5, 6), (5, 38, 38), (37, 28, 22)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    return torch.device('cuda')


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('c', [4, 32, 64])
def test_kernels_match_plain(cuda, shape, c):
    gen = torch.Generator(device=cuda).manual_seed(0)
    m = shape[0] * shape[1] * shape[2]
    g = torch.randn((m, c), generator=gen, device=cuda)
    de = torch.randn((m, 8 * c), generator=gen, device=cuda)
    assert torch.equal(ex.expand_corners(g, shape), ex.expand_plain(g, shape))
    torch.testing.assert_close(ex.fold_corners(de, shape),
                               ex.fold_plain(de, shape), atol=1e-5, rtol=0)


def test_autograd_function_launches_both_kernels(cuda):
    shape = (6, 5, 4)
    g = torch.randn((120, 32), device=cuda, requires_grad=True)
    ex.reset_launch_counts()
    e = expand_grid(g, shape).e
    cot = torch.randn_like(e)
    grad, = torch.autograd.grad(e, g, cot)
    assert ex.LAUNCHES == {'expand_corners': 1, 'fold_corners': 1}
    gl = g.detach().clone().requires_grad_()
    want, = torch.autograd.grad(ex.expand_plain(gl, shape), gl, cot)
    torch.testing.assert_close(grad, want, atol=1e-5, rtol=0)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    g = torch.randn((24, 32), device=cuda)
    with pytest.raises(ValueError):
        ex.expand_corners(g.double(), (2, 3, 4))
    with pytest.raises(ValueError):
        ex.expand_corners(torch.randn((24, 6), device=cuda), (2, 3, 4))
    with pytest.raises(ValueError):
        ex.expand_corners(torch.randn((32, 24), device=cuda).T, (2, 3, 4))
    with pytest.raises(ValueError):
        ex.expand_corners(g, (2, 3, 5))
    with pytest.raises(ValueError):
        ex.fold_corners(torch.randn((24, 40), device=cuda), (2, 3, 4))
