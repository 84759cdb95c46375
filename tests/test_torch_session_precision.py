"""The session-wide matmul precision (`matmul_precision`) of the port
against the JAX package under the TPU's rule.

XLA:CPU computes every float32 product in float32 whatever precision it
carries, so the JAX side runs under tests/tpu_matmul_rule.py: every dot it
lowers computes what the TPU's matrix unit does at the precision it was
traced with (`session_precision(name)` is `jax.default_matmul_precision`
under that rule).  The port computes the rule itself
(nice_slam_tpu_torch/models/precision.py), from the values the config
gives: the session's for the products outside the decoders, the
decoders' effective one (their own key, else the session's) inside them.

Tolerances:
(a) A single product -- the ray directions, the constant-speed pose, the
    keyframe projection, the blocked interpolation's contractions --
    forward and gradient: both packages within the float32 summation bound
    of a float64 numpy reference of the rule, per element
    (K + 2) 2^-24 sum_terms |A_i||B_j| (`_rule`), the bound of
    tests/test_torch_precision.py.
(b) Past one layer a float32 sum on the other side of a bfloat16 rounding
    boundary feeds the next product an input one bfloat16 ulp apart, so
    the decoders, the fused path's plain version and the mesher's lattice
    query are held by share: the median difference at most 1e-5 of the
    largest output, at most 2% of the outputs beyond 1e-4 of it and none
    beyond 2e-2 of it (the criterion chip_smoke.py holds the kernel's bf16
    modes to; measured here: medians 0-6.3e-8, none beyond 1e-4, the
    largest 2.8e-6-9.8e-5).  The float32 answer is further off: its median
    difference is at least 2e-4 of the largest output at one pass
    (measured 1.2e-3-6.5e-3 for the decoders, 2.4e-4 for the lattice
    query).
(c) The masks of a projection (frustum, seen frames, hull) agree but for
    points within a float32 rounding of a boundary: at most 0.2% differ.
(d) One tracking iteration and one mapping iteration on JAX's draws: the
    losses within 1e-3 (relative), the pose after the first Adam step (a
    step of lr x sign(g)) within 1e-6, the grids after one step within
    2% of one step on 99% of their entries.
(e) A 3-frame SlamSystem run (60x80, cut budgets) in both packages at
    bfloat16 (one pass only, for the test's time, like the mapping
    iteration and the mesher's masks): finite, every per-frame error
    under 2 cm, the port's largest within 2x the JAX run's plus 5 mm.
About 100 s of test time in one process, most of it the JAX package's
compiles under the rule (the SlamSystem test ~27 s, the mapping
iteration 12-15 s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nice_slam_tpu.core import cameras as jc
from nice_slam_tpu.engine import frustum as jf
from nice_slam_tpu.engine import tracker as jt
from nice_slam_tpu.models import decoders as jd
from nice_slam_tpu.ops.pallas.fused_mlp import fused_mlp as jax_fused_mlp
from nice_slam_tpu_torch.core import cameras as tc
from nice_slam_tpu_torch.engine import frustum as tf
from nice_slam_tpu_torch.engine import tracker as tt
from nice_slam_tpu_torch.models import decoders as td
from nice_slam_tpu_torch.models import precision as P
from nice_slam_tpu_torch.models.convert import decoders_from_numpy
from nice_slam_tpu_torch.ops import fused_mlp as fm
from nice_slam_tpu_torch.utils import config as tcfg
from tests.test_torch_precision import _rule as rule_and_magnitude
from tests.test_torch_util import np_of, t_of, tree_np
from tests.tpu_matmul_rule import session_precision
from tests.util import make_test_cfg

torch.set_num_threads(2)

PRECISIONS = ['bfloat16', 'tensorfloat32']


def _rule(a, b, n_passes):
    """a @ b under the rule in float64 (batched like np.matmul), and its
    bound (K + 2) 2^-24 sum |a_i| @ |b_j| (tests/test_torch_precision.py's
    reference)."""
    out, mag = rule_and_magnitude(a, b, n_passes)
    return out, (np.shape(a)[-1] + 2) * 2.0 ** -24 * mag


def _within(got, want, bound):
    err = np.abs(np.asarray(got, np.float64) - want)
    assert (err <= bound).all(), float((err - bound).max())


def _held(got, want, f32=None):
    d = np.abs(np.asarray(got, np.float64) - want)
    top = np.abs(want).max()
    assert np.median(d) <= 1e-5 * top, np.median(d) / top
    assert (d > 1e-4 * top).mean() <= 0.02, (d > 1e-4 * top).mean()
    assert d.max() <= 2e-2 * top, d.max() / top
    if f32 is not None:
        assert np.median(np.abs(f32 - want)) >= 2e-4 * top


# ---------------------------------------------------------------------------
# the names
# ---------------------------------------------------------------------------

def test_every_accepted_name_is_a_jax_name_and_fastest_raises():
    names = [n for n in P._PASSES if n is not None]
    assert set(names) == {
        'float32', 'highest', 'F32_F32_F32', 'bfloat16', 'default',
        'BF16_BF16_F32', 'tensorfloat32', 'high', 'BF16_BF16_F32_X3',
        'BF16_BF16_F32_X6', 'BF16_BF16_F32_X9'}
    for name in names:
        with jax.default_matmul_precision(name):
            pass
    with pytest.raises(ValueError):
        with jax.default_matmul_precision('fastest'):
            pass
    with pytest.raises(ValueError, match="'fastest'"):
        tcfg.session_precision({'matmul_precision': 'fastest'})
    assert tcfg.session_precision({}) is None
    assert tcfg.session_precision({'matmul_precision': 'highest'}) is None
    assert tcfg.session_precision(
        {'matmul_precision': 'tensorfloat32'}) == 'tensorfloat32'


# ---------------------------------------------------------------------------
# (a) the single products
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('batched', [False, True], ids=['frame', 'window'])
@pytest.mark.parametrize('name', PRECISIONS)
def test_ray_directions_forward_and_pose_gradient(name, batched):
    n_passes = P.passes(name)
    rng = np.random.default_rng(1)
    intr = tcfg.intrinsics_from_cfg(make_test_cfg())
    jintr = jc.Intrinsics(*intr)
    shape = (3, 50) if batched else (50,)
    i = rng.uniform(0, intr.W, shape).astype(np.float32)
    j = rng.uniform(0, intr.H, shape).astype(np.float32)
    c2w = np.tile(np.eye(4, dtype=np.float32), shape[:-1] + (1, 1))
    c2w[..., :3, :3] += rng.normal(size=shape[:-1] + (3, 3)) * 0.3
    c2w[..., :3, 3] = rng.normal(size=shape[:-1] + (3,))
    g = rng.normal(size=shape + (3,)).astype(np.float32)

    tcw = t_of(c2w).requires_grad_()
    _, d = tc.rays_from_uv(t_of(i), t_of(j), tcw, intr, name)
    (d * t_of(g)).sum().backward()
    with session_precision(name):
        jdirs = np.asarray(jc.rays_from_uv(jnp.asarray(i), jnp.asarray(j),
                                           jnp.asarray(c2w), jintr)[1])
        jgrad = np.asarray(jax.grad(
            lambda cw: (jc.rays_from_uv(jnp.asarray(i), jnp.asarray(j), cw,
                                        jintr)[1] * g).sum())(
            jnp.asarray(c2w)))
    dirs = np.stack([(i - intr.cx) / intr.fx, -(j - intr.cy) / intr.fy,
                     -np.ones_like(i)], axis=-1).astype(np.float32)
    rot = c2w[..., :3, :3]
    want, bound = _rule(dirs, np.swapaxes(rot, -1, -2), n_passes)
    _within(np_of(d), want, bound)
    _within(jdirs, want, bound)
    # dR = G^T dirs over the rays
    want, bound = _rule(np.swapaxes(g, -1, -2), dirs, n_passes)
    _within(np_of(tcw.grad)[..., :3, :3], want, bound)
    _within(jgrad[..., :3, :3], want, bound)
    assert not np.array_equal(np_of(d), np.einsum('...ij,...nj->...ni',
                                                  rot, dirs))


@pytest.mark.parametrize('name', PRECISIONS)
def test_const_speed_pose(name):
    rng = np.random.default_rng(4)
    a, b = (np.eye(4, dtype=np.float32) for _ in range(2))
    for m in (a, b):
        m[:3, :3] += rng.normal(size=(3, 3)).astype(np.float32) * 0.2
        m[:3, 3] = rng.normal(size=3)
    got = tt.const_speed_init(a, b, name)
    with session_precision(name):
        jgot = np.asarray(jt.const_speed_init(jnp.asarray(a), jnp.asarray(b)))
    delta, _ = _rule(a, np.linalg.inv(b), P.passes(name))
    want, bound = _rule(delta.astype(np.float32), a, P.passes(name))
    # the inverse of each package is its own float32 LU: 1e-6 relative
    bound = bound + 1e-5 * np.abs(want).max()
    _within(got, want, bound)
    _within(jgot, want, bound)
    assert got.dtype == np.float32


def _mask_agree(got, want):
    got, want = np.asarray(got, bool), np.asarray(want, bool)
    assert got.shape == want.shape
    assert (got != want).mean() <= 2e-3, (got != want).mean()
    assert 0 < got.sum() < got.size


@pytest.mark.parametrize('name', PRECISIONS)
def test_frustum_projection(name):
    from nice_slam_tpu.models.grids import grid_world_coords
    from nice_slam_tpu.utils.config import grid_config_from_cfg
    from nice_slam_tpu_torch.io.datasets import get_dataset
    cfg = make_test_cfg(n_frames=3)
    _, _, depth, c2w = get_dataset(cfg)[1]
    intr = tcfg.intrinsics_from_cfg(cfg)
    pts = grid_world_coords(grid_config_from_cfg(cfg), 'fine').reshape(-1, 3)
    got = tf.frustum_mask(t_of(pts), t_of(c2w), t_of(depth), intr, name)
    with session_precision(name):
        want = jf.frustum_mask(jnp.asarray(pts), jnp.asarray(c2w),
                               jnp.asarray(depth), jc.Intrinsics(*intr))
    _mask_agree(np_of(got), np_of(want))


@pytest.mark.parametrize('name', PRECISIONS)
def test_blocked_interpolation_and_its_gradients(name):
    """One block: the forward contraction 'nkc,nk->nc' and the backward's
    three 'nabc,na,nb,nc->n' contractions, against the JAX package's
    custom VJP under shard_map on one device."""
    from jax.sharding import PartitionSpec as PS
    from nice_slam_tpu.parallel.blocks import make_blocked as jmake
    from nice_slam_tpu.parallel.blocks import (
        trilinear_interp_blocked as jinterp)
    from nice_slam_tpu_torch.parallel.blocks import (
        make_blocked, trilinear_interp_blocked)
    from nice_slam_tpu_torch.parallel.mesh import RankGroup
    nx, ny, nz, c = 6, 5, 4, 16
    rng = np.random.default_rng(2)
    grid = rng.normal(size=(nx * ny * nz, c)).astype(np.float32)
    pts = rng.uniform(-1.1, 1.1, size=(300, 3)).astype(np.float32)
    cot = rng.normal(size=(300, c)).astype(np.float32)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                             ('block', 'rays'))

    def local(slab, p):
        return (jinterp(jmake(slab, (nx, ny, nz), nx, 'block'), p)
                * cot).sum()

    with session_precision(name):
        f = jax.shard_map(jax.value_and_grad(local, argnums=(0, 1)),
                          mesh=mesh, in_specs=(PS('block'), PS()),
                          out_specs=(PS(), (PS('block'), PS())),
                          check_vma=False)
        _, (jg_slab, jg_p) = jax.jit(f)(jnp.asarray(grid), jnp.asarray(pts))
        jout = np.asarray(jax.jit(jax.shard_map(
            lambda s, p: jinterp(jmake(s, (nx, ny, nz), nx, 'block'), p),
            mesh=mesh, in_specs=(PS('block'), PS()), out_specs=PS(),
            check_vma=False))(jnp.asarray(grid), jnp.asarray(pts)))
    slab, p = t_of(grid).requires_grad_(), t_of(pts).requires_grad_()
    group = RankGroup(1, 0, 'cpu')
    out = trilinear_interp_blocked(
        make_blocked(slab, (nx, ny, nz), nx, group, name), p)
    (out * t_of(cot)).sum().backward()
    f32 = trilinear_interp_blocked(make_blocked(
        t_of(grid), (nx, ny, nz), nx, group), t_of(pts))
    scale = np.abs(grid).max()
    # a product of K = 8 (forward) and chains of K <= 16 (backward), at
    # most 2^-7 relative per rounded operand: agree to a few float32 ulps
    np.testing.assert_allclose(np_of(out), jout, atol=1e-5 * scale, rtol=0)
    if name == 'bfloat16':
        assert np.abs(np_of(f32) - jout).max() > 1e-4 * scale
    np.testing.assert_allclose(np_of(slab.grad), np.asarray(jg_slab),
                               atol=1e-5 * np.abs(cot).max(), rtol=0)
    gp = np.asarray(jg_p)
    np.testing.assert_allclose(np_of(p.grad), gp,
                               atol=3e-5 * np.abs(gp).max(), rtol=0)


# ---------------------------------------------------------------------------
# (b) the decoders, the fused path, the mesher's lattice query
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def nice_params():
    cfg = jd.DecoderConfig()
    params = jd.init_nice_decoders(jax.random.PRNGKey(1), cfg)
    rng = np.random.default_rng(1)
    p = rng.uniform(-1.1, 1.1, (512, 3)).astype(np.float32)
    c = rng.normal(size=(512, 64)).astype(np.float32)
    return cfg, params, p, c


@pytest.mark.parametrize('session,key', [
    ('bfloat16', None), ('tensorfloat32', None), ('bfloat16',
                                                  'tensorfloat32')])
def test_nice_decoders_follow_the_session(nice_params, session, key):
    """Without `model.decoder_matmul_precision` the decoders take the
    session's precision (the JAX `_prec_ctx` is then no scope at all);
    with it, theirs."""
    cfg, params, p, c = nice_params
    conf = make_test_cfg()
    conf['matmul_precision'] = session
    conf['model']['decoder_matmul_precision'] = key
    tdcfg = tcfg.decoder_config_from_cfg(conf)
    assert tdcfg.mm_precision == (key or session)
    jcfg = cfg._replace(mm_precision=key)
    decs = decoders_from_numpy(tree_np(params), tdcfg)
    f32 = decoders_from_numpy(tree_np(params), td.DecoderConfig())
    widths = {'middle': 32, 'fine': 64, 'color': 32, 'coarse': 32}

    def jax_all(prm, p_, c_):
        out = {name: jd.mlp_apply(prm[name], jcfg, p_, c_[:, :widths[name]],
                                  color=name == 'color')
               for name in ('middle', 'fine', 'color')}
        out['coarse'] = jd.mlp_no_xyz_apply(prm['coarse'], jcfg, c_[:, :32])
        return out

    with session_precision(session):
        want = jax.jit(jax_all)(params, jnp.asarray(p), jnp.asarray(c))
    with torch.no_grad():
        for name, width in widths.items():
            args = ((t_of(c[:, :width]),) if name == 'coarse'
                    else (t_of(p), t_of(c[:, :width])))
            base = (np_of(f32[name](*args))
                    if tdcfg.mm_precision == 'bfloat16' else None)
            _held(np_of(decs[name](*args)), np.asarray(want[name]), base)


@pytest.mark.parametrize('name', PRECISIONS)
def test_fused_plain_version_against_the_jax_kernel(nice_params, name):
    """fused_mlp_plain at the precision against the JAX package's Pallas
    kernel in interpret mode under the same session precision (its dots
    outside `_prec_ctx` take the session's), and the wrapper on the CPU
    equal to it; no mode for the six-pass preset."""
    cfg, params, p, c = nice_params
    decs = decoders_from_numpy(tree_np(params),
                               td.DecoderConfig(mm_precision=name))
    for dec, width, color in (('middle', 32, False), ('fine', 64, False),
                              ('color', 32, True)):
        mparams = [w.detach() for w in fm.mlp_params(decs[dec])]
        args = (t_of(p), t_of(c[:, :width]))
        got = fm.fused_mlp_plain(*args, mparams, color=color, precision=name)
        with session_precision(name):
            want = np.asarray(jax_fused_mlp(params[dec], cfg, jnp.asarray(p),
                                            jnp.asarray(c[:, :width]), color,
                                            (2,), True))
        _held(np_of(got), want)
        with torch.no_grad():
            assert torch.equal(td.mlp_dispatch(decs[dec], *args, fused=True),
                               got)
    with pytest.raises(ValueError, match='no kernel mode'):
        fm.fused_mlp_forward(t_of(p), t_of(c[:, :32]), mparams, color=True,
                             precision='BF16_BF16_F32_X6')


def test_mesher_lattice_query_at_the_decoder_key():
    """F5: the port's mesher (the fused path, at the decoders' precision)
    against the JAX package's default mesher (XLA under `_prec_ctx`) at
    `model.decoder_matmul_precision: bfloat16`, session float32."""
    from nice_slam_tpu.mesh import mesher as jm
    from nice_slam_tpu.models.grids import prepare_grids as jprepare
    from nice_slam_tpu_torch.mesh import mesher as tm
    from nice_slam_tpu_torch.models.grids import prepare_grids
    from tests.test_torch_util import jax_nice_setup
    jmodel, params, grids, tmodel, _, tgrids = jax_nice_setup(0)
    jmodel = jmodel._replace(
        decoder=jmodel.decoder._replace(mm_precision='bfloat16'))
    tmodel = tmodel._replace(
        decoder=tmodel.decoder._replace(mm_precision='bfloat16'))
    decs = decoders_from_numpy(tree_np(params), tmodel.decoder)
    f32 = decoders_from_numpy(tree_np(params), td.DecoderConfig())
    intr = tcfg.intrinsics_from_cfg(make_test_cfg())
    kw = dict(resolution=16, marching_cubes_bound=((-1.0, 1.0), (-0.8, 0.8),
                                                   (-1.0, 1.0)),
              points_batch=4096)
    tmesher = tm.Mesher(tm.MesherConfig(**kw), tmodel, intr)
    assert tmesher.model.fused_eval
    pts = tmesher.lattice()[0]
    tx = prepare_grids(tgrids, tmodel.grid_shapes)
    got = tmesher.eval_field(decs, tx, pts, 'fine')
    base = tmesher.eval_field(f32, tx, pts, 'fine')
    with session_precision('float32'):
        jmesher = jm.Mesher(jm.MesherConfig(**kw), jmodel,
                            jc.Intrinsics(*intr))
        want = jmesher.eval_field(params,
                                  jprepare(grids, jmodel.grid_shapes), pts,
                                  'fine')
    _held(got, want, base)


@pytest.mark.parametrize('name', ['bfloat16'])
def test_mesher_seen_frames_and_hull(name):
    from nice_slam_tpu.mesh import mesher as jm
    from nice_slam_tpu_torch.io.datasets import get_dataset
    from nice_slam_tpu_torch.mesh import mesher as tm
    from tests.test_torch_util import jax_nice_setup
    jmodel, _, _, tmodel, _, _ = jax_nice_setup(0)
    cfg = make_test_cfg(n_frames=9)
    intr = tcfg.intrinsics_from_cfg(cfg)
    ds = get_dataset(cfg)
    c2ws = [ds[i][3] for i in (0, 4, 8)]
    depths = [ds[i][2] for i in (0, 4, 8)]
    kw = dict(resolution=16, marching_cubes_bound=((-1.3, 1.3), (-1.1, 1.1),
                                                   (-1.3, 1.3)),
              points_batch=4096)
    tmesher = tm.Mesher(tm.MesherConfig(**kw),
                        tmodel._replace(matmul_precision=name), intr)
    pts = tmesher.lattice()[0]
    eq = np.array([[1.0, 0.2, -0.3, -0.7], [-0.4, 1.0, 0.1, -0.5],
                   [0.3, -0.2, 1.0, -0.6], [-1.0, -0.3, -0.2, -0.8],
                   [0.1, -1.0, 0.3, -0.6], [-0.2, 0.1, -1.0, -0.9]],
                  np.float32)
    eq[:, :3] /= np.linalg.norm(eq[:, :3], axis=1, keepdims=True)
    got_seen = tmesher.seen_mask(pts, c2ws, depths, use_depth=True)
    got_hull = tmesher.inside_hull(pts, eq)
    with session_precision(name):
        jmesher = jm.Mesher(jm.MesherConfig(**kw), jmodel,
                            jc.Intrinsics(*intr))
        want_seen = jmesher.seen_mask(pts, c2ws, depths, use_depth=True)
        want_hull = jmesher.inside_hull(pts, eq)
    _mask_agree(got_seen, want_seen)
    _mask_agree(got_hull, want_hull)


# ---------------------------------------------------------------------------
# (d) one tracking and one mapping iteration, (e) a short SlamSystem run
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def engine_world():
    """Both packages' models on the tiny synthetic scene with the same
    random decoders and grids, and three frames (tests/test_torch_engine.py's
    world)."""
    from nice_slam_tpu.io.datasets import get_dataset
    from nice_slam_tpu.models.grids import init_grids, static_grid_shapes
    from nice_slam_tpu.render.renderer import SceneModel
    from nice_slam_tpu.utils import config as jcfg
    cfg = make_test_cfg()
    gcfg = jcfg.grid_config_from_cfg(cfg)
    params = jd.init_nice_decoders(jax.random.PRNGKey(3),
                                   jcfg.decoder_config_from_cfg(cfg))
    rng = np.random.default_rng(3)
    grids = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32)
                            * 0.1)
             for k, v in init_grids(jax.random.PRNGKey(4), gcfg).items()}
    jmodel = SceneModel(kind='nice', decoder=jcfg.decoder_config_from_cfg(cfg),
                        bound=jnp.asarray(gcfg.bound_np),
                        coarse_bound=jnp.asarray(gcfg.coarse_bound_np),
                        grid_shapes=static_grid_shapes(gcfg))
    ds = get_dataset(cfg)
    return dict(cfg=cfg, intr=jcfg.intrinsics_from_cfg(cfg), params=params,
                grids=grids, jmodel=jmodel,
                frames=[ds[i] for i in (0, 2, 4)])


def _port(w, name):
    from nice_slam_tpu_torch.models.convert import grids_from_numpy
    from nice_slam_tpu_torch.render.renderer import SceneModel
    cfg = dict(w['cfg'], matmul_precision=name)
    gcfg = tcfg.grid_config_from_cfg(cfg)
    tmodel = SceneModel(decoder=tcfg.decoder_config_from_cfg(cfg),
                        bound=torch.tensor(gcfg.bound_np),
                        coarse_bound=torch.tensor(gcfg.coarse_bound_np),
                        grid_shapes=w['jmodel'].grid_shapes,
                        matmul_precision=tcfg.session_precision(cfg))
    decs = decoders_from_numpy(tree_np(w['params']), tmodel.decoder)
    grids = grids_from_numpy(tree_np(w['grids']))
    for g in grids.values():
        g.requires_grad_(True)
    return tmodel, decs, grids


@pytest.mark.parametrize('name', PRECISIONS)
def test_one_tracking_iteration(engine_world, name):
    from nice_slam_tpu.core.sampling import sample_pixels
    from nice_slam_tpu.engine.slam import tracker_config_from_cfg
    from nice_slam_tpu.utils import config as jcfg
    w = engine_world
    cfg, intr = w['cfg'], w['intr']
    jtcfg = tracker_config_from_cfg(cfg)._replace(iters=1)
    _, color, depth, gt = w['frames'][1]
    guess = gt.copy()
    guess[:3, 3] += np.array([0.01, -0.008, 0.006], np.float32)
    cam7 = jc.tensor_from_c2w(jnp.asarray(guess[:3, :4]))
    key = jax.random.PRNGKey(11)
    with session_precision(name):
        track = jt.make_track_frame(model=w['jmodel'],
                                    rcfg=jcfg.render_config_from_cfg(cfg),
                                    tcfg=jtcfg, intr=intr)
        _, jlast, jlosses = track(w['params'], w['grids'], jnp.asarray(color),
                                  jnp.asarray(depth), cam7, key)
    i, j = sample_pixels(jax.random.fold_in(key, 0), jtcfg.pixels,
                         jtcfg.ignore_edge_h, intr.H - jtcfg.ignore_edge_h,
                         jtcfg.ignore_edge_w, intr.W - jtcfg.ignore_edge_w)
    tmodel, decs, grids = _port(w, name)
    _, tlast, tlosses = tt.track_frame(
        decs, grids, t_of(color), t_of(depth), t_of(cam7), model=tmodel,
        rcfg=tcfg.render_config_from_cfg(cfg),
        tcfg=tcfg.tracker_config_from_cfg(cfg)._replace(iters=1),
        intr=tcfg.intrinsics_from_cfg(cfg), draws=[(t_of(i), t_of(j))])
    np.testing.assert_allclose(np_of(tlosses), np_of(jlosses), rtol=1e-3)
    np.testing.assert_allclose(np_of(tlast), np_of(jlast), atol=1e-6)
    assert float(np.abs(np_of(tlast) - np_of(cam7)).max()) > 1e-3


@pytest.mark.parametrize('name', ['bfloat16'])
def test_one_mapping_iteration(engine_world, name):
    """One BA mapping iteration of the color stage (every decoder and
    volume, the poses, the rays' product and the decoders at the
    precision); at one pass only, for the test's time: the three-pass rule
    runs through the same code, held at every single product above."""
    from nice_slam_tpu.core.sampling import sample_pixels
    from nice_slam_tpu.engine import mapper as jm
    from nice_slam_tpu.engine.slam import mapper_config_from_cfg
    from nice_slam_tpu.utils import config as jcfg
    from nice_slam_tpu_torch.engine import mapper as tm
    w = engine_world
    cfg, intr = w['cfg'], w['intr']
    jmcfg = mapper_config_from_cfg(cfg)._replace(ba=True)
    n_frames, pix = 3, 60
    # the last row of a 12-iteration call's table: the color stage
    lr_tab = jm.lr_table(jmcfg, 12, 0.2, True, True)[-1:]
    stage_idx = jm.stage_schedule(jmcfg, 12, True)[-1:]
    assert stage_idx.tolist() == [3]
    colors = np.stack([f[1] for f in w['frames']])
    depths = np.stack([f[2] for f in w['frames']])
    c2ws = np.stack([f[3] for f in w['frames']])
    cams = jc.tensor_from_c2w(jnp.asarray(c2ws[:, :3, :4]))
    cams = cams.at[1:, 4:].add(0.005)
    cam_mask = np.array([0.0, 1.0, 1.0], np.float32)
    masks = {k: jnp.ones((g.shape[0], 1)) for k, g in w['grids'].items()}
    trainable = ('color', 'fine', 'middle')
    opt = {'cams': cams, 'grids': w['grids'],
           'dec': {k: w['params'][k] for k in trainable}}
    key = jax.random.PRNGKey(21)
    with session_precision(name):
        step = jm.make_map_step(model=w['jmodel'],
                                rcfg=jcfg.render_config_from_cfg(cfg),
                                mcfg=jmcfg, intr=intr, n_frames=n_frames,
                                n_iters=1, pix_per_frame=pix)
        jout, _, jlosses = step(opt, {'coarse': w['params']['coarse']},
                                masks, jnp.asarray(lr_tab),
                                jnp.asarray(stage_idx),
                                jnp.asarray(cam_mask), jnp.asarray(colors),
                                jnp.asarray(depths), key)
    fkeys = jax.random.split(jax.random.fold_in(key, 0), n_frames)
    ij = [sample_pixels(k, pix, 0, intr.H, 0, intr.W) for k in fkeys]
    draws = [(t_of(np.stack([a for a, _ in ij])),
              t_of(np.stack([b for _, b in ij])))]
    tmodel, decs, grids = _port(w, name)
    tcams, tlosses = tm.map_step(
        decs, grids, t_of(cams), trainable=trainable,
        masks={k: t_of(v) for k, v in masks.items()},
        cam_mask=t_of(cam_mask), lr_tab=lr_tab, stage_idx=stage_idx,
        colors=t_of(colors), depths=t_of(depths), model=tmodel,
        rcfg=tcfg.render_config_from_cfg(cfg),
        mcfg=tcfg.mapper_config_from_cfg(cfg)._replace(ba=True),
        intr=tcfg.intrinsics_from_cfg(cfg), pix_per_frame=pix, draws=draws)
    np.testing.assert_allclose(np_of(tlosses), np_of(jlosses), rtol=1e-3)
    np.testing.assert_allclose(np_of(tcams), np_of(jout['cams']), atol=1e-6)
    assert float(np.abs(np_of(tcams) - np_of(cams)).max()) > 1e-4
    for vol, g in grids.items():
        moved = np.abs(np_of(g) - np_of(w['grids'][vol]))
        step_size = moved.max()
        if step_size == 0:
            continue
        off = np.abs(np_of(g) - np_of(jout['grids'][vol]))
        assert (off <= 0.02 * step_size).mean() >= 0.99, vol


def test_short_session_in_both_packages(tmp_path):
    """synthetic frames 0-2 at 60x80 under matmul_precision: bfloat16,
    budgets cut (first map 60 iterations, 8 tracking iterations), in both
    packages from seed 4."""
    from nice_slam_tpu.engine.slam import SlamSystem as JSlam
    from nice_slam_tpu_torch.engine.slam import SlamSystem as TSlam
    cfg = make_test_cfg(n_frames=3)
    cfg.update(matmul_precision='bfloat16', enable_vis=False, debug={})
    cfg['mapping']['iters_first'] = 60
    cfg['tracking']['iters'] = 8
    with session_precision(None):
        js = JSlam(cfg, nice=True, output=str(tmp_path / 'jax'), seed=4)
        js.mesher = None
        js.run()
    ts = TSlam(cfg, device='cpu', seed=4, output=str(tmp_path / 'torch'))
    assert ts.model.matmul_precision == 'bfloat16'
    assert ts.dcfg.mm_precision == 'bfloat16'
    ts.mesher = None
    ts.run()
    errs = [np.linalg.norm(s.estimate_c2w[:, :3, 3] - s.gt_c2w[:, :3, 3],
                           axis=-1) for s in (js, ts)]
    for e in errs:
        assert np.isfinite(e).all() and e.max() < 0.02, e
    assert errs[1].max() <= 2 * errs[0].max() + 0.005, errs
