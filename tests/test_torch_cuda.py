"""The port's CUDA kernels on the card (marker `cuda`): each kernel against
its plain PyTorch version, the autograd Functions, the launch counters and
the wrapper checks, and the mesher's field query on the card against the
CPU.  They skip on a machine without a GPU; on one with a
GPU and nvcc run them with

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(--noconftest: tests/conftest.py configures JAX, which such a machine may
not have; these tests need only torch and the port).

Tolerances: the expansion is pure data movement (bit-exact); the fold sums
at most 27 float32 terms per entry in another order than fold_plain (1e-5).
The fused MLP sums its layers in another order than cuBLAS and evaluates
sin of arguments up to ~10^2 rad (here) whose last-bit differences move
the embedding by ~1e-5: 1e-4 x max(1, max|plain|).  TF32 is off for every
comparison (the plain version's matmuls would otherwise round to 10 bits).
"""

import numpy as np
import pytest
import torch

from nice_slam_tpu_torch.ops import expand as ex
from nice_slam_tpu_torch.ops import fused_mlp as fm
from nice_slam_tpu_torch.ops.trilinear import expand_grid

pytestmark = pytest.mark.cuda

SHAPES = [(5, 4, 3), (1, 4, 3), (4, 1, 3), (4, 3, 1), (1, 1, 1), (2, 2, 2),
          (7, 5, 6), (5, 38, 38), (37, 28, 22)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')
    return torch.device('cuda')


@pytest.fixture
def decoders(cuda):
    from nice_slam_tpu_torch.models.decoders import (
        DecoderConfig, init_nice_decoders)
    return init_nice_decoders(DecoderConfig(),
                              generator=torch.Generator().manual_seed(0),
                              device='cpu').to(cuda)


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


def _mlp_inputs(n, c_dim, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    p = torch.rand((n, 3), generator=gen, device=device) * 4 - 2
    c = torch.randn((n, c_dim), generator=gen, device=device) * 0.3
    return p, c


@pytest.mark.parametrize('n', [1, 31, 1024, 1025, 262144])
@pytest.mark.parametrize('name,c_dim,color', [
    ('middle', 32, False), ('fine', 64, False), ('color', 32, True),
    ('fine4', 64, True)])
def test_fused_mlp_matches_plain(cuda, decoders, n, name, c_dim, color):
    if name == 'fine4':      # c 64 with out 4: the fourth instantiation
        from nice_slam_tpu_torch.models.decoders import MLP, DecoderConfig
        mlp = MLP(DecoderConfig(), c_dim=64, color=True,
                  generator=torch.Generator().manual_seed(1),
                  device='cpu').to(cuda)
    else:
        mlp = decoders[name]
    p, c = _mlp_inputs(n, c_dim, cuda, seed=n)
    params = [w.detach() for w in fm.mlp_params(mlp)]
    fm.reset_launch_counts()
    got = fm.fused_mlp_forward(p, c, params, color=color)
    want = fm.fused_mlp_plain(p, c, params, color=color)
    torch.cuda.synchronize()
    assert fm.LAUNCHES['fused_mlp'] == 1
    assert got.shape == want.shape
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol


def test_fused_mlp_autograd_matches_plain(cuda, decoders):
    mlp = decoders['fine']
    p, c = _mlp_inputs(3000, 64, cuda, seed=4)
    cl = c.clone().requires_grad_()
    out = fm.fused_mlp(mlp, p, cl)
    names = [k for k, _ in mlp.named_parameters()]
    grads = torch.autograd.grad(torch.sin(out).sum(),
                                list(mlp.parameters()) + [cl])
    cr = c.clone().requires_grad_()
    want = torch.autograd.grad(torch.sin(mlp(p, cr)).sum(),
                               list(mlp.parameters()) + [cr])
    for name, a, b in zip(names + ['c'], grads, want):
        scale = max(float(b.abs().max()), 1e-6)
        assert float((a - b).abs().max()) <= 1e-3 * scale, name


def test_fused_mlp_wrapper_refuses_what_the_kernel_does_not_take(
        cuda, decoders):
    mlp = decoders['middle']
    params = [w.detach() for w in fm.mlp_params(mlp)]
    p, c = _mlp_inputs(64, 32, cuda)
    with pytest.raises(ValueError):            # float64
        fm.fused_mlp_forward(p.double(), c, params, color=False)
    with pytest.raises(ValueError):
        fm.fused_mlp_forward(p, c.double(), params, color=False)
    with pytest.raises(ValueError):            # non-contiguous
        fm.fused_mlp_forward(p, torch.randn((32, 64), device=cuda).T,
                             params, color=False)
    with pytest.raises(ValueError):            # c_dim the kernel lacks
        fm.fused_mlp_forward(p, torch.randn((64, 16), device=cuda), params,
                             color=False)
    with pytest.raises(ValueError):            # out width != color
        fm.fused_mlp_forward(p, c, params, color=True)


def test_mesher_field_on_the_card_matches_the_cpu(cuda):
    from nice_slam_tpu_torch.mesh.mesher import Mesher, MesherConfig
    from nice_slam_tpu_torch.models.decoders import (
        DecoderConfig, init_nice_decoders)
    from nice_slam_tpu_torch.models.grids import (
        GridConfig, init_grids, prepare_grids, static_grid_shapes)
    from nice_slam_tpu_torch.core.cameras import Intrinsics
    from nice_slam_tpu_torch.render.renderer import SceneModel
    gcfg = GridConfig(bound=((-1.3, 1.3), (-1.1, 1.1), (-1.3, 1.3)))
    gen = torch.Generator().manual_seed(2)
    grids = {k: v * 30 for k, v in
             init_grids(gcfg, generator=gen, device='cpu').items()}
    decs = init_nice_decoders(DecoderConfig(), generator=gen, device='cpu')
    mcfg = MesherConfig(resolution=48, points_batch=20000,
                        marching_cubes_bound=gcfg.bound)
    out = {}
    for dev in ('cpu', 'cuda'):
        model = SceneModel(decoder=DecoderConfig(),
                           bound=torch.tensor(gcfg.bound_np, device=dev),
                           coarse_bound=torch.tensor(gcfg.coarse_bound_np,
                                                     device=dev),
                           grid_shapes=static_grid_shapes(gcfg))
        mesher = Mesher(mcfg, model, Intrinsics(30, 40, 20., 20., 19.5,
                                                14.5))
        gr = prepare_grids({k: v.to(dev) for k, v in grids.items()},
                           model.grid_shapes)
        fm.reset_launch_counts()
        pts = mesher.lattice()[0]
        out[dev] = (mesher.eval_field(decs.to(dev), gr, pts, 'fine'),
                    mesher.eval_field(decs.to(dev), gr, pts[:5000], 'color',
                                      column=slice(0, 3)))
        launches = fm.LAUNCHES['fused_mlp']
    # 48^3 points in 6 chunks x (middle + fine), then 1 chunk x 3 decoders
    assert launches == 6 * 2 + 3
    for a, b in zip(out['cpu'], out['cuda']):
        assert np.abs(a - b).max() <= 1e-4 * max(1.0, np.abs(a).max())
