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
    out = fm.FusedMLP.apply(t_of(p), ct, False, *params)
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
    """The packed buffer has the lengths the kernel's layout computes:
    280 (B) + 10,208 (five dense layers) + 5 x (32C + 32) + 32 x out +
    out, rounded up to 4."""
    decs = td.init_nice_decoders(td.DecoderConfig(),
                                 generator=torch.Generator(), device='cpu')
    sizes = {name: fm.pack_weights(fm.mlp_params(decs[name])).numel()
             for name in ('middle', 'fine', 'color')}
    assert sizes == {'middle': 15804, 'fine': 20924, 'color': 15900}
