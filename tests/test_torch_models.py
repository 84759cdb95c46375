"""Port parity, L1/L2: decoders, nice_eval, prepare_grids, the pretrained
import, and render_rays of nice_slam_tpu_torch against nice_slam_tpu, with
the JAX parameters carried across by models.convert.

Tolerances: float32 MLPs of width 32 (K <= 125) agree to ~1e-6 relative
between XLA's and torch's CPU matmuls; occupancy logits are O(1-10), so
atol 1e-4 / rtol 1e-4 bounds accumulated rounding through 5 layers with
room to spare; gradients get 1e-3 relative (they pass through the same
layers twice).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nice_slam_tpu.models import decoders as jd
from nice_slam_tpu.models import embeddings as je
from nice_slam_tpu.models import grids as jg
from nice_slam_tpu.render import renderer as jr
from nice_slam_tpu_torch.models import decoders as td
from nice_slam_tpu_torch.models import embeddings as te
from nice_slam_tpu_torch.models import grids as tg
from nice_slam_tpu_torch.models.convert import decoders_from_numpy
from nice_slam_tpu_torch.ops.trilinear import ExpandedGrid
from nice_slam_tpu_torch.render import renderer as tr
from tests.test_torch_util import jax_nice_setup, np_of, t_of, tree_np

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def setup():
    return jax_nice_setup(0)


def _points(n, seed, lo=-1.1, hi=1.1):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(
        np.float32)


@contextlib.contextmanager
def _f32_matmuls():
    """Full-f32 products in both frameworks for the block.  Both settings
    are process-wide and other test files that share a pytest-xdist worker
    change them: the JAX SlamSystem sets `jax_default_matmul_precision`
    from its config, the port's SlamSystem and the CUDA tests set torch's."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision('highest')
    try:
        with jax.default_matmul_precision('float32'):
            yield
    finally:
        torch.set_float32_matmul_precision(before)


def test_embeddings_match():
    p = _points(50, 1)
    b = np.random.default_rng(2).normal(size=(3, 93)).astype(np.float32)
    # sin(p @ B) in float64: each package is held to it at the same
    # tolerance, so a failure names the side that drifted
    exact = np.sin(p.astype(np.float64) @ b.astype(np.float64))
    with _f32_matmuls():
        got = np_of(te.fourier_embed(t_of(b), t_of(p)))
        want = np_of(je.fourier_embed(jnp.asarray(b), jnp.asarray(p)))
    np.testing.assert_allclose(got, exact, atol=1e-5, rtol=1e-5,
                               err_msg='port vs float64')
    np.testing.assert_allclose(want, exact, atol=1e-5, rtol=1e-5,
                               err_msg='JAX package vs float64')
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    for multires, log in ((10, True), (5, False)):
        np.testing.assert_allclose(
            np_of(te.nerf_embed(t_of(p), multires, log)),
            np_of(je.nerf_embed(jnp.asarray(p), multires, log)),
            atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('name,c_dim,color', [
    ('middle', 32, False), ('fine', 64, False), ('color', 32, True)])
def test_mlp_matches(setup, name, c_dim, color):
    _, params, _, _, decs, _ = setup
    p = _points(300, 3)
    c = np.random.default_rng(4).normal(size=(300, c_dim)).astype(
        np.float32)
    want = jd.mlp_apply(params[name], jd.DecoderConfig(), jnp.asarray(p),
                        jnp.asarray(c), color=color)
    got = decs[name](t_of(p), t_of(c))
    np.testing.assert_allclose(np_of(got), np_of(want), atol=1e-4,
                               rtol=1e-4)


def test_mlp_no_xyz_matches(setup):
    _, params, _, _, decs, _ = setup
    c = np.random.default_rng(5).normal(size=(300, 32)).astype(np.float32)
    want = jd.mlp_no_xyz_apply(params['coarse'], jd.DecoderConfig(),
                               jnp.asarray(c))
    np.testing.assert_allclose(np_of(decs['coarse'](t_of(c))),
                               np_of(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize('stage', ['coarse', 'middle', 'fine', 'color'])
@pytest.mark.parametrize('expanded', [False, True])
def test_nice_eval_matches(setup, stage, expanded):
    jmodel, params, grids, tmodel, decs, tgrids = setup
    p = _points(400, 6)
    jgr, tgr = grids, tgrids
    if expanded:
        jgr = jg.prepare_grids(grids, jmodel.grid_shapes, stage=stage)
        tgr = tg.prepare_grids(tgrids, tmodel.grid_shapes, stage=stage)
    want = jd.nice_eval(params, jgr, jnp.asarray(p), stage, jmodel.decoder,
                        jmodel.bound, jmodel.coarse_bound,
                        jmodel.grid_shapes)
    got = td.nice_eval(decs, tgr, t_of(p), stage, tmodel.decoder,
                       tmodel.bound, tmodel.coarse_bound, tmodel.grid_shapes)
    np.testing.assert_allclose(np_of(got), np_of(want), atol=1e-4,
                               rtol=1e-4)


def test_prepare_grids_matches(setup):
    jmodel, _, grids, tmodel, _, tgrids = setup
    for stage in (None, 'coarse', 'middle', 'fine', 'color'):
        want = jg.prepare_grids(grids, jmodel.grid_shapes, stage=stage)
        got = tg.prepare_grids(tgrids, tmodel.grid_shapes, stage=stage)
        assert sorted(got) == sorted(want), stage
        for k in want:
            w, g = want[k], got[k]
            assert isinstance(g, ExpandedGrid) == hasattr(w, 'e'), (stage, k)
            np.testing.assert_array_equal(
                np_of(g.e if isinstance(g, ExpandedGrid) else g),
                np_of(w.e if hasattr(w, 'e') else w))


def test_grid_geometry_matches():
    gj = jg.GridConfig(bound=jg.round_bound(
        [[-2.9, 8.9], [-3.2, 5.5], [-3.5, 3.3]], 0.32))
    gt = tg.GridConfig(bound=tg.round_bound(
        [[-2.9, 8.9], [-3.2, 5.5], [-3.5, 3.3]], 0.32))
    assert gt.bound == gj.bound
    assert tg.grid_shapes(gt) == jg.grid_shapes(gj)
    # room0's volumes (the main path's kernel shapes)
    assert tg.grid_shapes(gt) == {'middle': (37, 28, 22), 'fine': (74, 56, 44),
                                  'color': (74, 56, 44), 'coarse': (11, 8, 7)}
    for name in ('coarse', 'middle'):
        np.testing.assert_array_equal(tg.grid_world_coords(gt, name),
                                      jg.grid_world_coords(gj, name))
    grids = tg.init_grids(gt, generator=torch.Generator().manual_seed(0),
                          device='cpu')
    for name, (nx, ny, nz) in tg.grid_shapes(gt).items():
        assert grids[name].shape == (nx * ny * nz, 32)
    assert 0.005 < float(grids['middle'].std()) < 0.02
    assert float(grids['fine'].std()) < 0.001


def test_pretrained_import_matches_jax_loader():
    """The real pretrained/*.pt blobs load into the port's modules with the
    same weights the JAX importer produces (middle under the
    'decoder.coarse.*' prefix)."""
    from nice_slam_tpu.models.pretrain import load_torch_pretrain as jload
    from nice_slam_tpu_torch.models.pretrain import \
        load_torch_pretrain as tload
    pre = {'coarse': 'pretrained/coarse.pt',
           'middle_fine': 'pretrained/middle_fine.pt'}
    dcfg = jd.DecoderConfig()
    jparams = jload(jd.init_nice_decoders(jax.random.PRNGKey(0), dcfg), pre,
                    coarse=True)
    decs = td.init_nice_decoders(td.DecoderConfig(),
                                 generator=torch.Generator().manual_seed(0),
                                 device='cpu')
    tload(decs, pre, coarse=True)
    want = decoders_from_numpy(tree_np(jparams), td.DecoderConfig())
    for name in ('coarse', 'middle', 'fine'):
        got_sd, want_sd = decs[name].state_dict(), want[name].state_dict()
        assert got_sd.keys() == want_sd.keys()
        for k in got_sd:
            np.testing.assert_array_equal(np_of(got_sd[k]),
                                          np_of(want_sd[k]), err_msg=k)
    # and the loaded middle decoder computes what the JAX one computes
    p = _points(100, 7)
    c = np.random.default_rng(8).normal(size=(100, 32)).astype(np.float32)
    np.testing.assert_allclose(
        np_of(decs['middle'](t_of(p), t_of(c))),
        np_of(jd.mlp_apply(jparams['middle'], dcfg, jnp.asarray(p),
                           jnp.asarray(c), color=False)),
        atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize('stage', ['coarse', 'middle', 'fine', 'color'])
def test_render_rays_matches_with_gradients(setup, stage):
    jmodel, params, grids, tmodel, decs, tgrids = setup
    rng = np.random.default_rng(9)
    n = 64
    o = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    depth = rng.uniform(0.3, 1.5, n).astype(np.float32)
    depth[::9] = 0.0
    jrcfg = jr.RenderConfig(n_samples=16, n_surface=8)
    trcfg = tr.RenderConfig(n_samples=16, n_surface=8)

    def jloss(grids_, o_):
        gr = jg.prepare_grids(grids_, jmodel.grid_shapes, stage=stage)
        dep, var, col, _ = jr.render_rays(
            params, gr, o_, jnp.asarray(d), stage=stage, model=jmodel,
            rcfg=jrcfg, gt_depth=jnp.asarray(depth))
        return jnp.sum(dep) + jnp.sum(var) + jnp.sum(col), (dep, var, col)

    (_, jout), jgrad = jax.value_and_grad(jloss, argnums=(0, 1),
                                          has_aux=True)(grids, jnp.asarray(o))
    leaves = {k: v.clone().requires_grad_() for k, v in tgrids.items()}
    ot = t_of(o).requires_grad_()
    gr = tg.prepare_grids(leaves, tmodel.grid_shapes, stage=stage)
    dep, var, col, _ = tr.render_rays(decs, gr, ot, t_of(d), stage=stage,
                                      model=tmodel, rcfg=trcfg,
                                      gt_depth=t_of(depth))
    for a, b in zip((dep, var, col), jout):
        np.testing.assert_allclose(np_of(a), np_of(b), atol=1e-4, rtol=1e-4)
    names = sorted(leaves)
    tgrad = torch.autograd.grad(dep.sum() + var.sum() + col.sum(),
                                [leaves[k] for k in names] + [ot],
                                allow_unused=True)
    for k, g in zip(names + ['origin'], tgrad):
        want = jgrad[1] if k == 'origin' else jgrad[0][k]
        got = np.zeros_like(np_of(want)) if g is None else np_of(g)
        scale = max(float(np.abs(np_of(want)).max()), 1e-6)
        np.testing.assert_allclose(got / scale, np_of(want) / scale,
                                   atol=1e-3, err_msg=k)


def test_render_rays_refuses_importance_sampling(setup):
    """Importance sampling is ported (tests/test_torch_imap.py); what
    render_rays refuses is a stochastic draw (perturb > 0) with no
    generator to draw from, and with one it adds the n_importance samples
    to every ray."""
    _, _, _, tmodel, decs, tgrids = setup
    rcfg = tr.RenderConfig(n_importance=8, perturb=1.0)
    o, d = torch.zeros(4, 3), torch.ones(4, 3)
    with pytest.raises(ValueError):
        tr.render_rays(decs, tgrids, o, d, stage='color', model=tmodel,
                       rcfg=rcfg)
    *_, weights = tr.render_rays(decs, tgrids, o, d, stage='color',
                                 model=tmodel, rcfg=rcfg,
                                 generator=torch.Generator().manual_seed(0))
    assert weights.shape == (4, rcfg.n_samples + rcfg.n_importance)
