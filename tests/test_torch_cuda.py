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
The fused MLP runs its products on the tensor cores as 3xTF32 (each
operand split into TF32 hi and lo, lo.hi + hi.lo + hi.hi summed in FP32:
~22 of FP32's 24 mantissa bits, the dropped lo.lo term 2^-22 of a
product), sums its layers in another order than cuBLAS and evaluates sin
of arguments up to ~10^3 rad (over room0's bound) whose last-bit
differences move the embedding by up to ~6e-5; through five layers of
width <= 128 that stays far inside 1e-4 x max(1, max|plain|) (the CPU
emulation of the same arithmetic, tests/test_torch_fused_mlp.py, is off
by ~3e-6 at outputs ~7).  That gate fails 1x and 2xTF32 products but not
the fast hardware sine __sinf, so at the mesher's 262,144-point chunk the
three decoders are also held to 1e-5 x max(1, max|plain|) over room0's
bound, which __sinf fails and the kernel meets with a margin of 2x or more
(PERF.md, the fused MLP).  TF32 is off for every comparison (the plain
version's matmuls would otherwise round to 10 bits).
The row gather and the roofline probes move data only (bit-exact; `shifts`
adds two floats per output in the plain version's order); the scatter-add
sums repeated rows in the order of their positions, its plain version
(index_add_ on the card) with atomics in an order that changes from run to
run: 1e-5 x max(1, max|index_add_|); against index_put_ with accumulate,
which sums in the kernel's order, it is bit-equal.  An index out of range
fails a device-side assertion in both gather kernels, as in table[idx].
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nice_slam_tpu_torch.ops import expand as ex
from nice_slam_tpu_torch.ops import gather as ga
from nice_slam_tpu_torch.ops import roofline as rf
from nice_slam_tpu_torch.ops import fused_mlp as fm
from nice_slam_tpu_torch.ops.trilinear import expand_grid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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


# room0's bound (configs/Replica/room0.yaml): Fourier arguments ~10^3 rad
ROOM0_BOUND = ((-2.9, 8.9), (-3.2, 5.5), (-3.5, 3.3))
MLP_DECODERS = [('middle', 32, False), ('fine', 64, False),
                ('color', 32, True), ('fine4', 64, True)]


def _mlp_inputs(n, c_dim, device, seed=0, bound=((-2, 2),) * 3):
    gen = torch.Generator(device=device).manual_seed(seed)
    lo, hi = (torch.tensor(x, device=device) for x in zip(*bound))
    p = lo + (hi - lo) * torch.rand((n, 3), generator=gen, device=device)
    c = torch.randn((n, c_dim), generator=gen, device=device) * 0.3
    return p, c


def _mlp(name, decoders, device):
    if name == 'fine4':      # c 64 with out 4: the fourth instantiation
        from nice_slam_tpu_torch.models.decoders import MLP, DecoderConfig
        return MLP(DecoderConfig(), c_dim=64, color=True,
                   generator=torch.Generator().manual_seed(1),
                   device='cpu').to(device)
    return decoders[name]


# ragged sizes and the edges of the kernel's 32-point warp tiles
@pytest.mark.parametrize('n', [1, 15, 16, 17, 31, 63, 64, 65, 1024, 1025,
                               262144, 262144 + 13])
@pytest.mark.parametrize('name,c_dim,color', MLP_DECODERS)
def test_fused_mlp_matches_plain(cuda, decoders, n, name, c_dim, color):
    mlp = _mlp(name, decoders, cuda)
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


@pytest.mark.parametrize('n', [4097, 262144 + 13])
@pytest.mark.parametrize('name,c_dim,color', MLP_DECODERS)
def test_fused_mlp_matches_plain_over_room0s_bound(cuda, decoders, n, name,
                                                   c_dim, color):
    mlp = _mlp(name, decoders, cuda)
    p, c = _mlp_inputs(n, c_dim, cuda, seed=n + 1, bound=ROOM0_BOUND)
    params = [w.detach() for w in fm.mlp_params(mlp)]
    got = fm.fused_mlp_forward(p, c, params, color=color)
    want = fm.fused_mlp_plain(p, c, params, color=color)
    tol = 1e-4 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize('name,c_dim,color', MLP_DECODERS[:3])
def test_fused_mlp_is_fp32_precise_at_the_mesh_chunk(cuda, decoders, name,
                                                      c_dim, color):
    mlp = _mlp(name, decoders, cuda)
    p, c = _mlp_inputs(262144, c_dim, cuda, seed=5, bound=ROOM0_BOUND)
    params = [w.detach() for w in fm.mlp_params(mlp)]
    got = fm.fused_mlp_forward(p, c, params, color=color)
    want = fm.fused_mlp_plain(p, c, params, color=color)
    tol = 1e-5 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize('precision', ['bfloat16', 'tensorfloat32'])
@pytest.mark.parametrize('n', [17, 4097, 262144 + 13])
@pytest.mark.parametrize('name,c_dim,color', MLP_DECODERS)
def test_fused_mlp_bf16_modes_match_plain(cuda, decoders, n, name, c_dim,
                                          color, precision):
    """The one- and three-pass bf16 modes against the plain version at the
    same precision over room0's bound, by chip_smoke.py's criterion: the
    largest difference at most 2e-2 x max(1, max|plain|), and from 4,097
    points the median at most 1e-5 and at most 2% beyond 1e-4 of
    max|plain| (a float32 sum on the other side of a bf16 rounding
    boundary moves the next layer's input by one bf16 ulp)."""
    mlp = _mlp(name, decoders, cuda)
    p, c = _mlp_inputs(n, c_dim, cuda, seed=n + 2, bound=ROOM0_BOUND)
    params = [w.detach() for w in fm.mlp_params(mlp)]
    fm.reset_launch_counts()
    got = fm.fused_mlp_forward(p, c, params, color=color,
                               precision=precision)
    want = fm.fused_mlp_plain(p, c, params, color=color, precision=precision)
    torch.cuda.synchronize()
    mode = fm.MODES[fm.mode_of(precision)]
    assert fm.LAUNCHES == {k: int(k == mode) for k in fm.LAUNCHES}
    d = (got - want).abs().double()
    top = float(want.abs().max())
    assert float(d.max()) <= 2e-2 * max(1.0, top)
    if n >= 4097:
        assert float(d.median()) <= 1e-5 * top
        assert float((d > 1e-4 * top).double().mean()) <= 0.02


def test_fused_mlp_packs_once_per_parameter_set(cuda, decoders):
    mlp = decoders['fine']
    p, c = _mlp_inputs(100, 64, cuda)
    params = fm.mlp_params(mlp)
    first = fm.packed_weights(params)
    fm.fused_mlp_forward(p, c, params, color=False)
    assert fm.packed_weights(params) is first
    with torch.no_grad():
        mlp.pts_linears[1].bias.add_(0.5)
    got = fm.fused_mlp_forward(p, c, params, color=False)
    assert fm.packed_weights(params) is not first
    want = fm.fused_mlp_plain(p, c, params, color=False)
    assert float((got - want).abs().max()) <= 1e-4 * max(
        1.0, float(want.abs().max()))


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


def _rows_and_index(m, w, n, device, seed=0, kind='runs'):
    """kind 'runs': n draws from m rows plus one run of 64 on row 0 (a
    segment a block orders in shared memory); 'one_row': every position on
    row 0; 'every_third': every third position on row 7 (a segment spread
    over all positions; at 300,000 its range takes more than one window of
    the bitmap that orders it); 'clustered':
    n draws from 1,150 of the rows, row k of them weighted 1 / (k + 5)
    (the shape of a room0 mapping index: segments up to ~1,800 positions);
    'long_rows': every fifth position on row 3 and every seventh on row 11
    (two long segments, each summed by several column slices)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    table = torch.randn((m, w), generator=gen, device=device)
    idx = torch.randint(0, m, (n,), generator=gen, device=device)
    if kind == 'runs':
        idx[: min(n, 64)] = 0
    elif kind == 'one_row':
        idx[:] = 0
    elif kind == 'every_third':
        idx[::3] = 7
    elif kind == 'clustered':
        rows = torch.randperm(m, generator=gen, device=device)[:1150]
        weight = 1.0 / (torch.arange(1150, device=device) + 5.0)
        idx = rows[torch.multinomial(weight, n, replacement=True,
                                     generator=gen)]
    else:
        idx[::5] = 3
        idx[1::7] = 11
    return table, idx


@pytest.mark.parametrize('m,w,n,kind', [
    (1, 4, 1, 'runs'), (37, 4, 1023, 'runs'), (37, 256, 1023, 'runs'),
    (500, 256, 4097, 'runs'), (300, 512, 1025, 'runs'),
    (64, 2048, 3000, 'runs'), (22792, 256, 48000, 'runs'),
    (182336, 512, 9600, 'runs'), (22792, 256, 48000, 'one_row'),
    (5000, 64, 30000, 'every_third'), (5000, 64, 300000, 'every_third'),
    (300, 512, 0, 'runs'),
    (22792, 256, 48000, 'clustered'), (182336, 512, 48000, 'clustered'),
    (4096, 1024, 40000, 'long_rows'), (64, 4, 5000, 'long_rows')])
def test_gather_and_scatter_match_plain(cuda, m, w, n, kind):
    table, idx = _rows_and_index(m, w, n, cuda, kind=kind)
    assert torch.equal(ga.gather_rows(table, idx),
                       ga.gather_rows_plain(table, idx))
    assert torch.equal(ga.gather_rows(table, idx.int()),
                       ga.gather_rows_plain(table, idx))
    grad = torch.randn((n, w), device=cuda)
    want = ga.scatter_add_rows_plain(grad, idx, m)
    got = ga.scatter_add_rows(grad, idx, m)
    torch.testing.assert_close(
        got, want, rtol=0, atol=1e-5 * max(1.0, float(want.abs().max())))
    # the order of autograd's backward of table[idx] on the card, bit for bit
    put = torch.zeros((m, w), device=cuda).index_put_((idx,), grad,
                                                      accumulate=True)
    assert torch.equal(got, put)
    for _ in range(4):      # the same bits on every call: no race, no atomics
        assert torch.equal(got, ga.scatter_add_rows(grad, idx, m))
    assert torch.equal(got, ga.scatter_add_rows(grad, idx.int(), m))


def test_gather_autograd_launches_scatter_only_for_a_gradient(cuda):
    table, idx = _rows_and_index(120, 64, 500, cuda)
    ga.reset_launch_counts()
    with torch.no_grad():
        ga.GatherRows.apply(table, idx)
    out = ga.GatherRows.apply(table, idx)      # no input needs a gradient
    assert out.grad_fn is None
    assert ga.LAUNCHES == {'gather_rows': 2, 'scatter_add_rows': 0}
    t = table.clone().requires_grad_()
    cot = torch.randn((500, 64), device=cuda)
    g, = torch.autograd.grad(ga.GatherRows.apply(t, idx), t, cot)
    assert ga.LAUNCHES == {'gather_rows': 3, 'scatter_add_rows': 1}
    torch.testing.assert_close(g, ga.scatter_add_rows_plain(cot, idx, 120),
                               rtol=0, atol=1e-4)


def test_gather_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    table, idx = _rows_and_index(24, 32, 10, cuda)
    with pytest.raises(ValueError):
        ga.gather_rows(table.double(), idx)
    with pytest.raises(ValueError):
        ga.gather_rows(torch.randn((24, 6), device=cuda), idx)
    with pytest.raises(ValueError):
        ga.gather_rows(torch.randn((32, 24), device=cuda).T, idx)
    with pytest.raises(ValueError):
        ga.gather_rows(table, idx.cpu())
    with pytest.raises(ValueError):
        ga.scatter_add_rows(torch.randn((10, 6), device=cuda), idx, 24)


@pytest.mark.parametrize('op', ['gather_rows', 'scatter_add_rows'])
def test_gather_kernels_fail_on_an_index_out_of_range(cuda, op):
    """As table[idx] on the card: a device-side assertion, raised at the
    next synchronize.  In a child process, because the assertion leaves the
    CUDA context unusable."""
    code = (
        'import torch\n'
        'from nice_slam_tpu_torch.ops import gather as ga\n'
        't = torch.zeros((4, 8), device="cuda")\n'
        'idx = torch.tensor([0, 4], device="cuda")\n'
        f'ga.{op}(t, idx)\n' if op == 'gather_rows' else
        'import torch\n'
        'from nice_slam_tpu_torch.ops import gather as ga\n'
        'g = torch.zeros((2, 8), device="cuda")\n'
        'idx = torch.tensor([0, -1], device="cuda")\n'
        f'ga.{op}(g, idx, 4)\n')
    code += 'torch.cuda.synchronize()\nprint("no error")\n'
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode != 0, res.stdout
    assert 'no error' not in res.stdout
    assert 'assert' in res.stderr.lower(), res.stderr[-2000:]


@pytest.mark.parametrize('shape,c', [((1, 1, 1), 4), ((4, 3, 1), 8),
                                     ((5, 4, 3), 32), ((28, 21, 14), 32),
                                     ((74, 56, 44), 64)])
@pytest.mark.parametrize('mode', rf.MODES)
def test_roofline_probes_match_plain(cuda, mode, shape, c):
    m = shape[0] * shape[1] * shape[2]
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((m, 8 * c if mode == 'copy' else c), generator=gen,
                    device=cuda)
    assert torch.equal(rf.probe(mode, x, shape),
                       rf.probe_plain(mode, x, shape))


@pytest.mark.parametrize('rows,width', [(1, 4), (3, 8), (2047, 4),
                                        (2049, 4), (1000, 12),
                                        (4095, 516), (3276801, 4)])
def test_copy_probe_at_sizes_off_its_unroll(cuda, rows, width):
    """The copy moves 8 float4s per thread and 2,048 per block: sizes that
    are not multiples of either, below and above the L2 cache (plain and
    evict-first hints), bit-exact."""
    x = torch.randn((rows, width), device=cuda)
    assert torch.equal(rf.probe('copy', x), rf.probe_plain('copy', x))


@pytest.mark.parametrize('prec', ['bfloat16', 'BF16_BF16_F32_X3'])
@pytest.mark.parametrize('shape', [(4097, 256, 256), (8193, 256, 4),
                                   (1000, 3, 93)])
def test_bf16_products_match_plain(cuda, prec, shape):
    """The decoder stack's bfloat16 products (models/precision.py) through
    `aten::mm.dtype` against their plain version on the card, forward (the
    bias added in float32) and both gradients: each side sums K exact
    products and the bias in float32, so they agree within
    2 (K + 2) 2^-24 (|A|.|B| + |bias|) per element, and the error's rms is
    within 16 sqrt(K) 2^-24 of the plain version's (float32 sums in two
    orders; at 4,097 rows cuBLAS missed it by ~1.5% until the rows were
    padded to a multiple of 8)."""
    from nice_slam_tpu_torch.models import precision as P
    m, k, n = shape
    gen = torch.Generator(device=cuda).manual_seed(0)
    x, w, g, bias = (torch.randn(s, generator=gen, device=cuda)
                     for s in ((m, k), (k, n), (m, n), (n,)))
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    out = P.linear(xl, wl.t(), bias, prec)
    out.backward(g)
    n_passes = P.passes(prec)
    xs, ws, gs = (P.split(t, n_passes) for t in (x, w, g))
    pairs = [(0, 0)] if n_passes == 1 else [(0, 1), (1, 0), (0, 0)]

    def plain(a, b):
        return sum(P.pass_plain(a[i], b[j]) for i, j in pairs)

    t = lambda ts: tuple(u.t() for u in ts)
    for got, a, b, depth, add in ((out.detach(), xs, ws, k, bias),
                                  (xl.grad, gs, t(ws), n, 0.0),
                                  (wl.grad, t(xs), gs, m, 0.0)):
        mag = plain(tuple(u.abs() for u in a),
                    tuple(u.abs() for u in b)) + abs(add)
        want = plain(a, b) + add
        assert ((got - want).abs()
                <= 2 * (depth + 2) * 2.0 ** -24 * mag).all()
        assert ((got - want).pow(2).mean().sqrt()
                <= 16 * depth ** 0.5 * 2.0 ** -24
                * want.pow(2).mean().sqrt())
