"""Port parity of the fused decoder MLP (ops/fused_mlp.py) on the CPU: the
port's wrapper (which takes the plain version for CPU tensors) and its
autograd Function against the JAX package's Pallas kernel run in interpret
mode (`fused_mlp(..., interpret=True)`, as tests/test_pallas.py runs it)
and against `mlp_apply`, plus the dispatch through `nice_eval(fused=)`.

Tolerances (as tests/test_pallas.py): decoder outputs 2e-5 absolute and
1e-5 relative (float32 layers of width <= 125 summed in another order);
gradients 3e-4 absolute and 2e-3 relative (they pass every layer twice).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nice_slam_tpu.models.decoders import (
    DecoderConfig, init_nice_decoders, mlp_apply)
from nice_slam_tpu.ops.pallas.fused_mlp import fused_mlp as jax_fused_mlp
from nice_slam_tpu_torch.models import decoders as td
from nice_slam_tpu_torch.models.convert import decoders_from_numpy
from nice_slam_tpu_torch.models.grids import prepare_grids
from nice_slam_tpu_torch.ops import fused_mlp as fm
from tests.test_torch_util import jax_nice_setup, np_of, t_of, tree_np

torch.set_num_threads(2)

DECODERS = [('middle', 32, False), ('fine', 64, False), ('color', 32, True)]


@pytest.fixture(scope='module')
def setup():
    dcfg = DecoderConfig()
    params = init_nice_decoders(jax.random.PRNGKey(0), dcfg)
    decs = decoders_from_numpy(tree_np(params), td.DecoderConfig())
    return dcfg, params, decs


def _inputs(n, c_dim, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    c = rng.normal(size=(n, c_dim)).astype(np.float32)
    return p, c


@pytest.mark.parametrize('n', [1500, 1, 1023, 1025])
@pytest.mark.parametrize('name,c_dim,color', DECODERS)
def test_fused_mlp_matches_jax_kernel(setup, n, name, c_dim, color):
    dcfg, params, decs = setup
    p, c = _inputs(n, c_dim, seed=n)
    got = np_of(fm.fused_mlp(decs[name], t_of(p), t_of(c)))
    want = jax_fused_mlp(params[name], dcfg, jnp.asarray(p), jnp.asarray(c),
                         color, (2,), True)
    ref = mlp_apply(params[name], dcfg, jnp.asarray(p), jnp.asarray(c),
                    color=color)
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize('name,c_dim,color', DECODERS)
def test_plain_version_is_the_module_forward(setup, name, c_dim, color):
    """fused_mlp_plain repeats MLP.forward's operations: bit-equal."""
    _, _, decs = setup
    p, c = (t_of(x) for x in _inputs(300, c_dim, seed=7))
    want = decs[name](p, c)
    got = fm.fused_mlp_plain(p, c, fm.mlp_params(decs[name]), color=color)
    assert torch.equal(got, want)


@pytest.mark.parametrize('name,c_dim,color', DECODERS)
def test_fused_mlp_gradients_match_jax(setup, name, c_dim, color):
    """Gradients through the autograd Function (autograd of the plain
    version) against JAX's gradients of its fused_mlp (the custom_vjp of
    the Pallas kernel), for every weight and for the features."""
    dcfg, params, decs = setup
    p, c = _inputs(700, c_dim, seed=3)

    def jloss(prm, c_):
        return jnp.sum(jnp.sin(jax_fused_mlp(prm, dcfg, jnp.asarray(p), c_,
                                             color, (2,), True)))

    jg_params, jg_c = jax.grad(jloss, argnums=(0, 1))(params[name],
                                                      jnp.asarray(c))
    ct = t_of(c).requires_grad_()
    mlp = decs[name]
    out = fm.fused_mlp(mlp, t_of(p), ct)
    tparams = dict(mlp.named_parameters())
    names = sorted(tparams)
    grads = torch.autograd.grad(torch.sin(out).sum(),
                                [tparams[k] for k in names] + [ct])
    got = dict(zip(names + ['c'], grads))

    def close(a, b, what):
        np.testing.assert_allclose(np_of(a), np.asarray(b), atol=3e-4,
                                   rtol=2e-3, err_msg=what)

    close(got['c'], jg_c, 'c')
    close(got['embedder._B'], jg_params['embed_b'], 'B')
    for i in range(5):
        for group, key in (('pts_linears', 'pts_linears'), ('fc_c', 'fc_c')):
            close(got[f'{group}.{i}.weight'].T, jg_params[key][i]['w'],
                  f'{group}.{i}.weight')
            close(got[f'{group}.{i}.bias'], jg_params[key][i]['b'],
                  f'{group}.{i}.bias')
    close(got['output_linear.weight'].T, jg_params['out']['w'], 'out.w')
    close(got['output_linear.bias'], jg_params['out']['b'], 'out.b')


def test_backward_only_computes_what_is_asked(setup):
    """With only the features requiring grad, the Function returns their
    gradient (and the weights' gradients are not formed)."""
    _, _, decs = setup
    p, c = _inputs(50, 32, seed=5)
    ct = t_of(c).requires_grad_()
    mlp = decs['middle']
    with torch.no_grad():
        params = [w.detach() for w in fm.mlp_params(mlp)]
    out = fm.FusedMLP.apply(t_of(p), ct, False, None, *params)
    g, = torch.autograd.grad(out.sum(), [ct])
    cl = t_of(c).requires_grad_()
    want, = torch.autograd.grad(mlp(t_of(p), cl).sum(), [cl])
    torch.testing.assert_close(g, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize('stage', ['middle', 'fine', 'color'])
def test_nice_eval_fused_equals_plain_on_the_cpu(stage):
    _, _, _, tmodel, decs, tgrids = jax_nice_setup(0)
    p = t_of(np.random.default_rng(2).uniform(-1.1, 1.1, (400, 3)))
    args = (decs, tgrids, p, stage, tmodel.decoder, tmodel.bound,
            tmodel.coarse_bound, tmodel.grid_shapes)
    assert torch.equal(td.nice_eval(*args, fused=True),
                       td.nice_eval(*args, fused=False))


def _fused_nodes(t: torch.Tensor) -> int:
    """FusedMLP backward nodes in the autograd graph of `t`."""
    seen, stack, count = set(), [t.grad_fn], 0
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        count += type(node).__name__ == 'FusedMLPBackward'
        stack.extend(n for n, _ in node.next_functions)
    return count


@pytest.mark.parametrize('grids_kind', ['flat', 'expanded'])
@pytest.mark.parametrize('fused', [False, True])
def test_nice_eval_routes_every_mlp_as_asked(fused, grids_kind):
    """fused=True sends the middle, fine and color MLPs through the
    Function (three nodes in the color stage's graph), fused=False none,
    also with the expanded fine+color buffer of prepare_grids."""
    _, _, _, tmodel, decs, tgrids = jax_nice_setup(0)
    if grids_kind == 'expanded':
        tgrids = prepare_grids(tgrids, tmodel.grid_shapes, stage='color')
        assert 'finecolor' in tgrids
    p = t_of(np.random.default_rng(3).uniform(-1, 1, (50, 3)))
    out = td.nice_eval(decs, tgrids, p, 'color', tmodel.decoder,
                       tmodel.bound, tmodel.coarse_bound, tmodel.grid_shapes,
                       fused=fused)
    assert _fused_nodes(out) == (3 if fused else 0)


def test_dispatch_takes_the_plain_path_outside_the_kernels_configuration():
    """Other embeddings go to MLP.forward (as the JAX dispatch sends them to
    XLA); a configuration the kernel cannot take raises instead of falling
    back."""
    cfg = td.DecoderConfig(pos_embedding_method='nerf')
    decs = td.init_nice_decoders(cfg, generator=torch.Generator(),
                                 device='cpu')
    p, c = (t_of(x) for x in _inputs(20, 32))
    fm.reset_launch_counts()
    assert torch.equal(td.mlp_dispatch(decs['middle'], p, c, fused=True),
                       decs['middle'](p, c))
    wide = td.init_nice_decoders(td.DecoderConfig(hidden_size=64),
                                 generator=torch.Generator(), device='cpu')
    with pytest.raises(ValueError):
        td.mlp_dispatch(wide['middle'], p, c, fused=True)
    assert fm.LAUNCHES['fused_mlp'] == 0


def test_packed_layout_sizes():
    """The packed buffer has the lengths the kernel's layout computes: 616
    float32 (B [3][96], b_i, bc_i, b_o [8]) + 2 x (32 x (96 + 32 + 32 +
    128 + 32) dense + 5 x 32C fc_c + 8 x 32 head) TF32 halves."""
    decs = td.init_nice_decoders(td.DecoderConfig(),
                                 generator=torch.Generator(), device='cpu')
    sizes = {name: fm.pack_weights(fm.mlp_params(decs[name])).numel()
             for name in ('middle', 'fine', 'color')}
    assert sizes == {'middle': 31848, 'fine': 42088, 'color': 31848}
    assert sizes['middle'] == fm.pack_size(32)
    assert sizes['fine'] == fm.pack_size(64)


# ---------------------------------------------------------------------------
# the tensor-core kernel's arithmetic and packing, on the CPU
# ---------------------------------------------------------------------------

# room0's bound (configs/Replica/room0.yaml): Fourier arguments ~10^3 rad
ROOM0_BOUND = ((-2.9, 8.9), (-3.2, 5.5), (-3.5, 3.3))
MLP_TOL = 1e-4          # x max(1, max|plain|), as chip_smoke.py holds it


def _rna_tf32_reference(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32 in float64 arithmetic: the significand rounded to 11
    bits, ties away from zero."""
    m, e = np.frexp(np.abs(x.astype(np.float64)))       # m in [0.5, 1)
    return np.sign(x) * np.ldexp(np.floor(m * 2.0 ** 11 + 0.5), e - 11)


def test_split_tf32_rounds_as_cvt_rna():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=4000) * 10.0 ** rng.uniform(-6, 4, 4000)
         ).astype(np.float32)
    bits = x.view(np.int32)
    # ties (low 13 bits exactly half an ulp), and one below / above them
    ties = ((bits[:300] & -0x2000) | 0x1000).view(np.float32)
    near = np.concatenate([ties, (ties.view(np.int32) - 1).view(np.float32),
                           (ties.view(np.int32) + 1).view(np.float32)])
    x = np.concatenate([x, near, -near, np.float32([0.0, 1.0, -2.5])])
    hi, lo = (np_of(t) for t in fm.split_tf32(t_of(x)))
    for part in (hi, lo):
        assert not (part.view(np.int32) & 0x1FFF).any()
    np.testing.assert_array_equal(hi, _rna_tf32_reference(x))
    np.testing.assert_array_equal(
        lo, _rna_tf32_reference((x - hi).astype(np.float32)))
    err = np.abs(hi.astype(np.float64) + lo - x.astype(np.float64))
    assert (err <= 2.0 ** -21 * np.abs(x)).all()


def _mlp(name, decs):
    if name == 'fine4':       # c 64 with out 4: the fourth instantiation
        return td.MLP(td.DecoderConfig(), c_dim=64, color=True,
                      generator=torch.Generator().manual_seed(1),
                      device='cpu')
    return decs[name]


@pytest.mark.parametrize('name,c_dim,out_dim', [
    ('middle', 32, 1), ('fine', 64, 1), ('color', 32, 4), ('fine4', 64, 4)])
def test_unpack_inverts_pack(setup, name, c_dim, out_dim):
    """Every weight comes back from the packed buffer bit for bit: the
    float32 sections as they are, the products' weights as the TF32 halves
    split_tf32 gives."""
    params = [w.detach() for w in fm.mlp_params(_mlp(name, setup[2]))]
    got = fm.unpack(fm.pack_weights(params), c_dim, out_dim)
    b_mat, pts, fcs, w_o, b_o = fm._split(params)

    def same(a, b):
        assert a.shape == b.shape and torch.equal(a, b)

    same(got['B'], b_mat)
    same(got['b_o'], b_o)
    for i in range(fm.N_BLOCKS):
        same(got['b'][i], pts[i][1])
        same(got['bc'][i], fcs[i][1])
        for pair, w in ((got['W'][i], pts[i][0]), (got['Wc'][i], fcs[i][0])):
            for a, b in zip(pair, fm.split_tf32(w)):
                same(a, b)
    for a, b in zip(got['W_o'], fm.split_tf32(w_o)):
        same(a, b)


def emulate_kernel(p: torch.Tensor, c: torch.Tensor, packed: torch.Tensor,
                   c_dim: int, out_dim: int, products: int = 3
                   ) -> torch.Tensor:
    """csrc/fused_mlp.cu's arithmetic on the CPU, from its packed buffer:
    the embedding argument as its float32 fmaf chain (each fma one
    rounding), precise sin in float32, and every product of a layer as
    lo.hi + hi.lo + hi.hi of TF32 halves summed in float32 (`products` 2
    drops lo.hi, 1 keeps hi.hi only: the cheaper arithmetic the tolerance
    has to fail)."""
    w = fm.unpack(packed, c_dim, out_dim)
    bd, pd = w['B'].double(), p.double()

    def f32(x):
        return x.float().double()

    arg = f32(pd[:, 0:1] * bd[0])
    arg = f32(pd[:, 1:2] * bd[1] + arg)
    arg = f32(pd[:, 2:3] * bd[2] + arg)
    e = torch.sin(arg.float())

    def mm3(a, pair):
        hi, lo = pair
        ahi, alo = fm.split_tf32(a)
        terms = [alo @ hi.T, ahi @ lo.T][3 - products:]
        return sum(terms, ahi @ hi.T)

    h = e
    for i in range(fm.N_BLOCKS):
        x = torch.cat([e, h], dim=-1) if i - 1 in fm.SKIPS else h
        h = (torch.relu(mm3(x, w['W'][i]) + w['b'][i]) + w['bc'][i]
             + mm3(c, w['Wc'][i]))
    out = mm3(h, w['W_o']) + w['b_o']
    return out if out_dim == 4 else out[:, 0]


@pytest.mark.parametrize('name,c_dim,color', DECODERS)
def test_kernel_arithmetic_matches_plain_and_jax(setup, name, c_dim, color):
    """The 3xTF32 emulation over room0's bound (arguments ~10^3 rad)
    against fused_mlp_plain and the JAX package's Pallas kernel in
    interpret mode, within MLP_TOL x max(1, max|plain|)."""
    dcfg, params, decs = setup
    rng = np.random.default_rng(11)
    lo, hi = np.array(ROOM0_BOUND, np.float32).T
    p = (lo + (hi - lo) * rng.uniform(size=(1200, 3))).astype(np.float32)
    c = (0.3 * rng.normal(size=(1200, c_dim))).astype(np.float32)
    mparams = [w.detach() for w in fm.mlp_params(decs[name])]
    got = emulate_kernel(t_of(p), t_of(c), fm.pack_weights(mparams), c_dim,
                         4 if color else 1)
    plain = fm.fused_mlp_plain(t_of(p), t_of(c), mparams, color=color)
    want = np.asarray(jax_fused_mlp(params[name], dcfg, jnp.asarray(p),
                                    jnp.asarray(c), color, (2,), True))
    tol = MLP_TOL * max(1.0, float(plain.abs().max()))
    assert float((got - plain).abs().max()) <= tol
    assert float(np.abs(np_of(got) - want).max()) <= tol


def test_packed_weights_cache_hits_and_rebuilds_after_an_update():
    mlp = td.init_nice_decoders(td.DecoderConfig(),
                                generator=torch.Generator().manual_seed(2),
                                device='cpu')['fine']
    first = fm.packed_weights(fm.mlp_params(mlp))
    assert fm.packed_weights(fm.mlp_params(mlp)) is first
    # detached views share the parameters' storage and version counter
    assert fm.packed_weights([w.detach() for w in fm.mlp_params(mlp)]) \
        is first
    with torch.no_grad():
        mlp.fc_c[3].weight.add_(0.25)
    again = fm.packed_weights(fm.mlp_params(mlp))
    assert again is not first
    assert torch.equal(again, fm.pack_weights(fm.mlp_params(mlp)))
    assert fm.packed_weights(fm.mlp_params(mlp)) is again


def test_packed_weights_cache_rebuilds_after_a_restore():
    """SlamSystem.restore loads the decoders with load_state_dict, which
    copies into the parameters in place."""
    gen = torch.Generator().manual_seed(3)
    mlp, other = (td.init_nice_decoders(td.DecoderConfig(), generator=gen,
                                        device='cpu')['middle']
                  for _ in range(2))
    first = fm.packed_weights(fm.mlp_params(mlp))
    mlp.load_state_dict(other.state_dict())
    again = fm.packed_weights(fm.mlp_params(mlp))
    assert again is not first
    assert torch.equal(again, fm.pack_weights(fm.mlp_params(other)))


def _room0_inputs(n, c_dim, seed):
    rng = np.random.default_rng(seed)
    lo, hi = np.array(ROOM0_BOUND, np.float32).T
    p = (lo + (hi - lo) * rng.uniform(size=(n, 3))).astype(np.float32)
    c = (0.3 * rng.normal(size=(n, c_dim))).astype(np.float32)
    return t_of(p), t_of(c)


@pytest.mark.parametrize('products', [1, 2])
@pytest.mark.parametrize('name,c_dim,color', DECODERS)
def test_tolerance_fails_fewer_tf32_products(setup, name, c_dim, color,
                                             products):
    """MLP_TOL x max(1, max|plain|) tells the kernel's 3xTF32 products from
    cheaper ones: with lo.hi dropped (2xTF32) or with hi.hi alone (1xTF32)
    the emulation is off by more than the tolerance on room0's range."""
    p, c = _room0_inputs(4096, c_dim, 12)
    mparams = [w.detach() for w in fm.mlp_params(setup[2][name])]
    packed, out_dim = fm.pack_weights(mparams), 4 if color else 1
    plain = fm.fused_mlp_plain(p, c, mparams, color=color)
    tol = MLP_TOL * max(1.0, float(plain.abs().max()))
    exact = emulate_kernel(p, c, packed, c_dim, out_dim)
    cheap = emulate_kernel(p, c, packed, c_dim, out_dim, products=products)
    assert float((exact - plain).abs().max()) <= tol
    assert float((cheap - plain).abs().max()) > tol


# ---------------------------------------------------------------------------
# the bf16 modes (the decoders' effective precision not float32)
# ---------------------------------------------------------------------------

BF16_MODES = [('bfloat16', 1), ('tensorfloat32', 3)]


def _bf16_values(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


@pytest.mark.parametrize('n_passes', [1, 3])
@pytest.mark.parametrize('name,c_dim,out_dim', [
    ('middle', 32, 1), ('fine', 64, 1), ('color', 32, 4), ('fine4', 64, 4)])
def test_unpack_inverts_pack_bf16(setup, name, c_dim, out_dim, n_passes):
    """The bf16 modes' buffer: B as its bf16 parts, the biases as they
    are, every product weight as the parts models/precision.split gives,
    in the m16n8k16 fragment order and back, at the kernel's length."""
    from nice_slam_tpu_torch.models.precision import split
    params = [w.detach() for w in fm.mlp_params(_mlp(name, setup[2]))]
    packed = fm.pack_weights(params, n_passes)
    assert packed.numel() == fm.pack_size(c_dim, n_passes)
    got = fm.unpack(packed, c_dim, out_dim, n_passes)
    b_mat, pts, fcs, w_o, b_o = fm._split(params)

    def parts(w):
        return tuple(x.float() for x in split(w, n_passes))

    def same(a, b):
        assert a.shape == b.shape and torch.equal(a, b)

    same(got['B'], parts(b_mat)[0])
    if n_passes == 3:
        same(got['B_lo'], parts(b_mat)[1])
    same(got['b_o'], b_o)
    for i in range(fm.N_BLOCKS):
        same(got['b'][i], pts[i][1])
        same(got['bc'][i], fcs[i][1])
        for mine, w in ((got['W'][i], pts[i][0]), (got['Wc'][i], fcs[i][0])):
            assert len(mine) == len(parts(w))
            for a, b in zip(mine, parts(w)):
                same(a, b)
    for a, b in zip(got['W_o'], parts(w_o)):
        same(a, b)


def test_bf16_fragment_order_is_the_mma_layout():
    """One (k16, n8) tile of a weight: lane 4g + t holds rows (n) g and
    columns (k) 2t, 2t+1 in its first word, 2t+8, 2t+9 in its second, the
    lower column in the low half (mma.m16n8k16's B fragment)."""
    w = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    words = fm._fragments_bf16(w, 1).view(torch.int32)
    assert words.numel() == 64
    for lane in range(32):
        g, t = divmod(lane, 4)
        for j in range(2):
            word = int(words[2 * lane + j]) & 0xFFFFFFFF
            lo, hi = (torch.tensor([word & 0xFFFF, word >> 16],
                                   dtype=torch.int32)
                      .to(torch.int16).view(torch.bfloat16).float())
            assert (lo, hi) == (w[g, 8 * j + 2 * t], w[g, 8 * j + 2 * t + 1])


def emulate_kernel_bf16(p: torch.Tensor, c: torch.Tensor,
                        packed: torch.Tensor, c_dim: int, out_dim: int,
                        n_passes: int) -> torch.Tensor:
    """csrc/fused_mlp.cu's bf16 modes on the CPU, from its packed buffer:
    the embedding argument as the kernel's fmaf chains over the bf16 parts
    of p and B (each fma one float32 rounding; three passes sum (hi, lo),
    (lo, hi), then (hi, hi)), precise sin in float32, and every product as
    the passes of its operands' bf16 parts (models/precision.PAIRS), the
    products exact and the sums in float64."""
    from nice_slam_tpu_torch.models.precision import PAIRS
    w = fm.unpack(packed, c_dim, out_dim, n_passes)

    def f32(x):
        return x.float().double()

    def parts(x):
        hi = _bf16_values(x)
        return (hi,) if n_passes == 1 else (hi, _bf16_values(x - hi))

    def chain(a, b):
        a, b = a.double(), b.double()
        s = f32(a[:, 0:1] * b[0])
        s = f32(a[:, 1:2] * b[1] + s)
        return f32(a[:, 2:3] * b[2] + s)

    pp = parts(p)
    arg = chain(pp[0], w['B'])
    if n_passes == 3:
        arg = f32(f32(chain(pp[0], w['B_lo']) + chain(pp[1], w['B'])) + arg)
    e = torch.sin(arg.float())

    def mm(a, wparts):
        ap = parts(a)
        return sum(ap[i].double() @ wparts[j].double().T
                   for i, j in PAIRS[n_passes])

    h = e
    for i in range(fm.N_BLOCKS):
        x = torch.cat([e, h], dim=-1) if i - 1 in fm.SKIPS else h
        h = (torch.relu(mm(x, w['W'][i]) + w['b'][i]) + w['bc'][i]
             + mm(c, w['Wc'][i])).float()
    out = (mm(h, w['W_o']) + w['b_o']).float()
    return out if out_dim == 4 else out[:, 0]


def bf16_share(got: torch.Tensor, want: torch.Tensor) -> dict:
    """The bf16 modes' criterion against their plain version (chip_smoke.py
    holds the kernel to it): the median difference at most 1e-5 of the
    largest output, at most 2% beyond 1e-4 of it, none beyond 2e-2 of it
    (a float32 sum on the other side of a bf16 rounding boundary moves a
    next layer's input by one bf16 ulp)."""
    d = (got.double() - want.double()).abs()
    top = float(want.abs().max())
    return {'median': float(d.median()) / top,
            'beyond': float((d > 1e-4 * top).double().mean()),
            'max': float(d.max()) / top}


def bf16_held(share: dict) -> bool:
    return (share['median'] <= 1e-5 and share['beyond'] <= 0.02
            and share['max'] <= 2e-2)


@pytest.mark.parametrize('name,n_passes', BF16_MODES)
@pytest.mark.parametrize('dec,c_dim,color', DECODERS)
def test_bf16_kernel_arithmetic_matches_plain(setup, dec, c_dim, color,
                                              name, n_passes):
    """Each bf16 mode's emulation over room0's bound against
    fused_mlp_plain at the same precision, held by `bf16_held` (at 4,096
    points, seeds 13 and 14: median 0 / 2.5e-8-4.8e-8 of the largest
    output, 0.02-0.1% / 0 beyond 1e-4 of it, the largest 4.7e-4-2.1e-3 /
    4.8e-6-8.2e-6, one / three passes); the other mode's plain version and
    the float32 one are not (one pass against float32: median 3.2e-2-3.8e-2;
    three passes against float32: 33-38% beyond 1e-4)."""
    p, c = _room0_inputs(4096, c_dim, 13)
    mparams = [w.detach() for w in fm.mlp_params(setup[2][dec])]
    got = emulate_kernel_bf16(p, c, fm.pack_weights(mparams, n_passes),
                              c_dim, 4 if color else 1, n_passes)
    plain = fm.fused_mlp_plain(p, c, mparams, color=color, precision=name)
    assert bf16_held(bf16_share(got, plain)), bf16_share(got, plain)
    other = 'tensorfloat32' if n_passes == 1 else 'bfloat16'
    for wrong in (other, None):
        ref = fm.fused_mlp_plain(p, c, mparams, color=color,
                                 precision=wrong)
        assert not bf16_held(bf16_share(got, ref)), (wrong,
                                                     bf16_share(got, ref))


def test_bf16_modes_and_their_counters():
    """The names with a mode, the counters, and the raise for the six- and
    nine-pass presets before any launch."""
    assert {n: fm.has_mode(n) for n in (
        None, 'float32', 'F32_F32_F32', 'bfloat16', 'BF16_BF16_F32',
        'tensorfloat32', 'BF16_BF16_F32_X3', 'BF16_BF16_F32_X6',
        'BF16_BF16_F32_X9')} == {
        None: True, 'float32': True, 'F32_F32_F32': True, 'bfloat16': True,
        'BF16_BF16_F32': True, 'tensorfloat32': True,
        'BF16_BF16_F32_X3': True, 'BF16_BF16_F32_X6': False,
        'BF16_BF16_F32_X9': False}
    assert fm.LAUNCHES.keys() == {'fused_mlp', 'fused_mlp_bf16x1',
                                  'fused_mlp_bf16x3'}
    assert [fm.pack_size(32, n) for n in (0, 1, 3)] == [31848, 8424, 16520]
    assert [fm.pack_size(64, n) for n in (0, 1, 3)] == [42088, 10984, 21640]
    with pytest.raises(ValueError, match='no kernel mode'):
        fm.mode_of('BF16_BF16_F32_X9')
