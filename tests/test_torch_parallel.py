"""Port parity of the parallel backends (nice_slam_tpu_torch/parallel/)
against nice_slam_tpu/parallel/, on gloo CPU ranks.

Four rank processes are started once for the module (tests/
torch_rank_pool.py, brought up through the NSTPU_* variables) and serve
every case; the two-rank cases run on the pairs (0, 1) and (2, 3) at once.
The JAX side runs on the 8 virtual CPU devices of tests/conftest.py.  The
inputs are the JAX package's own test inputs (tests/test_parallel.py,
test_distributed.py, test_blocked.py); the draws are the ones the JAX
steps make internally, rebuilt here from their keys and handed to the port.

Tolerances: a step is compared as tests/test_torch_engine.py compares the
single-device steps (tracking: losses rtol 1e-4, poses atol 4e-5; mapping:
losses rtol 2e-4, poses atol 2e-5, volumes atol 1e-3, decoders atol 2e-4);
ranks that share a step must hold the same bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_util import np_of, t_of, tree_np
from tests.torch_rank_pool import RankPool
from tests.util import make_test_cfg

torch.set_num_threads(2)

N_RANKS = 4


@pytest.fixture(scope='module')
def pool():
    p = RankPool(N_RANKS, 'tests.torch_parallel_tasks')
    yield p
    p.close()


def spec_of(model, params, grids=None, dcfg=None):
    """A JAX model and its parameters as the numpy spec the ranks build the
    port's model from (tests/torch_parallel_tasks.build)."""
    d = dcfg if dcfg is not None else model.decoder
    return dict(
        kind=model.kind,
        dcfg=dict(c_dim=d.c_dim, hidden_size=d.hidden_size,
                  n_blocks=d.n_blocks, skips=tuple(d.skips),
                  pos_embedding_method=d.pos_embedding_method,
                  coarse=d.coarse, imap_hidden=d.imap_hidden,
                  imap_blocks=d.imap_blocks),
        bound=np.asarray(model.bound),
        coarse_bound=(None if model.coarse_bound is None
                      else np.asarray(model.coarse_bound)),
        grid_shapes=tuple(model.grid_shapes),
        params=tree_np(params),
        grids=None if grids is None else tree_np(grids))


def rcfg_of(rcfg):
    return dict(n_samples=rcfg.n_samples, n_surface=rcfg.n_surface,
                n_importance=rcfg.n_importance, lindisp=rcfg.lindisp,
                perturb=float(rcfg.perturb), occupancy=rcfg.occupancy)


def mcfg_of(mcfg):
    from nice_slam_tpu_torch.engine.mapper import MapperConfig
    d = mcfg._asdict()
    return {k: d[k] for k in MapperConfig._fields if k in d}


def same_bits(results, keys):
    """Every rank's result equals rank 0's bit for bit."""
    for r in results[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], results[0][k], err_msg=k)


def tiny():
    import __graft_entry__ as g
    from nice_slam_tpu.core.cameras import Intrinsics
    model, rcfg, gcfg, grids, params, key = g._tiny_setup()
    intr = Intrinsics(H=24, W=32, fx=16.0, fy=16.0, cx=15.5, cy=11.5)
    return model, rcfg, grids, params, key, intr


# -- bring-up and collectives ------------------------------------------------

def test_bring_up_from_nstpu_variables(pool):
    infos = pool.run('bring_up')
    assert [i['rank'] for i in infos] == list(range(N_RANKS))
    assert [i['process_id'] for i in infos] == list(range(N_RANKS))
    for i in infos:
        assert i['size'] == N_RANKS and i['backend'] == 'gloo'
        assert i['device'] == 'cpu' and i['initialized']


def test_list_sum_tiled_gather_and_max(pool):
    res = pool.run('collectives', seed=5)
    want_a = sum(r['a'] for r in res)
    want_b = sum(r['b'] for r in res)
    want_s = sum(r['s'] for r in res)
    gathered = np.concatenate([r['piece'] for r in res])
    for r in res:
        np.testing.assert_allclose(r['summed'][0], want_a, rtol=1e-6)
        assert r['summed'][1] is None
        np.testing.assert_allclose(r['summed'][2], want_b, rtol=1e-6)
        np.testing.assert_allclose(r['summed'][3], want_s, rtol=1e-6)
        # the gather is each rank's own bits, in rank order
        np.testing.assert_array_equal(r['gathered'], gathered)
        assert r['max'] == (N_RANKS - 1) * 1.5 - 2.0
    # one all-reduce for the whole list, one for the gather, one max
    assert all(r['calls'] == res[0]['calls'] for r in res)
    same_bits([{'s': r['summed'][0]} for r in res], ['s'])


def test_parallel_devices_must_match_the_world(pool, tmp_path):
    cfg = make_test_cfg(n_frames=2)
    cfg['parallel'] = {'map': 'rays', 'devices': 3}
    msgs = pool.run('devices_mismatch', cfg=cfg, output=str(tmp_path))
    for m in msgs:
        assert m is not None and '3' in m and str(N_RANKS) in m, m


def test_local_devices_above_one_is_refused(monkeypatch):
    from nice_slam_tpu_torch.parallel import distributed as D
    monkeypatch.setenv('NSTPU_COORDINATOR', 'localhost:1')
    monkeypatch.setenv('NSTPU_NUM_PROCESSES', '2')
    monkeypatch.setenv('NSTPU_PROCESS_ID', '0')
    monkeypatch.setenv('NSTPU_LOCAL_DEVICES', '2')
    with pytest.raises(ValueError, match='NSTPU_LOCAL_DEVICES'):
        D.initialize_from_env()
    monkeypatch.delenv('NSTPU_COORDINATOR')
    assert D.initialize_from_env() is None


# -- ray-sharded tracking (mirrors tests/test_parallel.py) --------------------

def _track_setup():
    """tests/test_torch_engine.py's tracking case: the 60x80 synthetic
    scene, random decoders and grids at 0.1 (every stage has real
    gradients), frame 2 from a guess off by ~1.4 cm."""
    from nice_slam_tpu.core.cameras import tensor_from_c2w
    from nice_slam_tpu.engine.slam import tracker_config_from_cfg
    from nice_slam_tpu.io.datasets import get_dataset
    from nice_slam_tpu.models.decoders import init_nice_decoders
    from nice_slam_tpu.models.grids import init_grids, static_grid_shapes
    from nice_slam_tpu.render.renderer import SceneModel
    from nice_slam_tpu.utils import config as jcfg
    cfg = make_test_cfg()
    gcfg = jcfg.grid_config_from_cfg(cfg)
    dcfg = jcfg.decoder_config_from_cfg(cfg)
    intr = jcfg.intrinsics_from_cfg(cfg)
    params = init_nice_decoders(jax.random.PRNGKey(3), dcfg)
    rng = np.random.default_rng(3)
    grids = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32)
                            * 0.1)
             for k, v in init_grids(jax.random.PRNGKey(4), gcfg).items()}
    model = SceneModel(kind='nice', decoder=dcfg,
                       bound=jnp.asarray(gcfg.bound_np),
                       coarse_bound=jnp.asarray(gcfg.coarse_bound_np),
                       grid_shapes=static_grid_shapes(gcfg))
    rcfg = jcfg.render_config_from_cfg(cfg)
    tcfg = tracker_config_from_cfg(cfg)._replace(iters=6)
    _, color, depth, gt = get_dataset(cfg)[2]
    guess = gt.copy()
    guess[:3, 3] += np.array([0.01, -0.008, 0.006], np.float32)
    cam7 = np.asarray(tensor_from_c2w(jnp.asarray(guess[:3, :4])))
    return (model, rcfg, grids, params, jax.random.PRNGKey(11), intr, tcfg,
            np.asarray(color, np.float32), np.asarray(depth, np.float32),
            cam7)


def _tcfg_dict(tcfg):
    from nice_slam_tpu_torch.engine.tracker import TrackerConfig
    d = tcfg._asdict()
    return {k: d[k] for k in TrackerConfig._fields}


def test_sharded_tracking_matches_jax(pool):
    """Two ranks, each rendering half of the JAX-drawn global batch,
    against JAX's make_sharded_track_frame on a 2-device mesh (and its
    single-device program)."""
    from nice_slam_tpu.core.sampling import sample_pixels
    from nice_slam_tpu.engine.tracker import make_track_frame
    from nice_slam_tpu.parallel.mesh import make_ray_mesh
    from nice_slam_tpu.parallel.sharded import make_sharded_track_frame
    (model, rcfg, grids, params, key, intr, tcfg, gt_color, gt_depth,
     cam7) = _track_setup()
    sharded = make_sharded_track_frame(mesh=make_ray_mesh(2), model=model,
                                       rcfg=rcfg, tcfg=tcfg, intr=intr)
    jbest, jlast, jloss = sharded(params, grids, jnp.asarray(gt_color),
                                  jnp.asarray(gt_depth), jnp.asarray(cam7),
                                  key)
    single = make_track_frame(model=model, rcfg=rcfg, tcfg=tcfg, intr=intr)
    sbest, _, sloss = single(params, grids, jnp.asarray(gt_color),
                             jnp.asarray(gt_depth), jnp.asarray(cam7), key)
    draws = [tuple(np.asarray(x) for x in sample_pixels(
        jax.random.fold_in(key, it), tcfg.pixels, tcfg.ignore_edge_h,
        intr.H - tcfg.ignore_edge_h, tcfg.ignore_edge_w,
        intr.W - tcfg.ignore_edge_w)) for it in range(tcfg.iters)]
    res = pool.run('track', spec=spec_of(model, params, grids),
                   tcfg=_tcfg_dict(tcfg), intr=tuple(intr),
                   rcfg=rcfg_of(rcfg), color=gt_color, depth=gt_depth,
                   cam7=cam7, draws=draws)
    same_bits(res, ['best', 'last', 'losses'])
    got = res[0]
    np.testing.assert_allclose(got['losses'], np_of(jloss), rtol=1e-4)
    np.testing.assert_allclose(got['last'], np_of(jlast), atol=4e-5)
    np.testing.assert_allclose(got['best'], np_of(jbest), atol=4e-5)
    np.testing.assert_allclose(got['losses'], np_of(sloss), rtol=1e-4)
    np.testing.assert_allclose(got['best'], np_of(sbest), atol=4e-5)
    assert np.abs(got['last'] - cam7).max() > 1e-3


def test_sharded_tracking_with_jitter_matches_one_rank(pool):
    """perturb 1: each rank renders its slice of the global batch's
    jitter, so two ranks give the one-rank frame up to summation order."""
    from nice_slam_tpu_torch.engine.tracker import track_frame
    from tests.torch_parallel_tasks import build
    (model, rcfg, grids, params, key, intr, tcfg, gt_color, gt_depth,
     cam7) = _track_setup()
    rng = np.random.default_rng(3)
    n = tcfg.pixels
    draws = [(rng.integers(5, intr.W - 5, n).astype(np.float32),
              rng.integers(5, intr.H - 5, n).astype(np.float32),
              rng.random((n, rcfg.n_samples), dtype=np.float32))
             for _ in range(tcfg.iters)]
    r = rcfg_of(rcfg)
    r['perturb'] = 1.0
    spec = spec_of(model, params, grids)
    res = pool.run('track', spec=spec, tcfg=_tcfg_dict(tcfg),
                   intr=tuple(intr), rcfg=r, color=gt_color, depth=gt_depth,
                   cam7=cam7, draws=draws)
    same_bits(res, ['best', 'last', 'losses'])
    from nice_slam_tpu_torch.core.cameras import Intrinsics as TI
    from nice_slam_tpu_torch.engine.tracker import TrackerConfig as TC
    from nice_slam_tpu_torch.render.renderer import RenderConfig as TR
    tmodel, decs, tgrids = build(spec)
    best, last, losses = track_frame(
        decs, tgrids, t_of(gt_color), t_of(gt_depth), t_of(cam7),
        model=tmodel, rcfg=TR(**r), tcfg=TC(**_tcfg_dict(tcfg)),
        intr=TI(*intr), draws=[tuple(t_of(x) for x in d) for d in draws])
    np.testing.assert_allclose(res[0]['losses'], np_of(losses), rtol=1e-4)
    np.testing.assert_allclose(res[0]['best'], np_of(best), atol=4e-5)


def test_sharded_tracking_rejects_indivisible():
    """Mirrors tests/test_parallel.py::test_sharded_track_frame_rejects_
    indivisible: 100 pixels over 8 ranks."""
    from types import SimpleNamespace
    from nice_slam_tpu_torch.engine.tracker import TrackerConfig
    from nice_slam_tpu_torch.parallel.sharded import sharded_track_frame
    with pytest.raises(ValueError, match='divisible'):
        sharded_track_frame({}, {}, torch.zeros(1), torch.zeros(1),
                            torch.zeros(7), group=SimpleNamespace(size=8),
                            model=None, rcfg=None, intr=None,
                            tcfg=TrackerConfig(pixels=100))


# -- keyframe-sharded mapping (mirrors tests/test_distributed.py) -------------

def _kf_draws(key, n_iters, n_frames, pix, intr, rcfg):
    """The per-iteration draws of the JAX mapping step: fold_in(key, it),
    one stream per frame; with perturb > 0 per-ray streams for the jitter
    and the importance uniforms; with density compositing the regulation's
    per-frame stream."""
    from nice_slam_tpu.core.sampling import sample_pixels
    out = []
    for it in range(n_iters):
        fkeys = jax.random.split(jax.random.fold_in(key, it), n_frames)
        ij = [sample_pixels(k, pix, 0, intr.H, 0, intr.W) for k in fkeys]
        i = np.stack([np.asarray(a) for a, _ in ij])
        j = np.stack([np.asarray(b) for _, b in ij])
        t_rand = u_imp = reg = None
        if rcfg.perturb > 0:
            rk = [jax.random.split(jax.random.fold_in(k, 11), pix)
                  for k in fkeys]
            t_rand = np.stack([np.asarray(jax.vmap(
                lambda k: jax.random.uniform(jax.random.fold_in(k, 0),
                                             (rcfg.n_samples,)))(r))
                for r in rk])
            if rcfg.n_importance:
                u_imp = np.stack([np.asarray(jax.vmap(
                    lambda k: jax.random.uniform(
                        jax.random.fold_in(k, 1),
                        (rcfg.n_importance,)))(r)) for r in rk])
        if not rcfg.occupancy:
            reg = np.stack([np.asarray(jax.random.uniform(
                jax.random.fold_in(k, 7), (pix, rcfg.n_samples)))
                for k in fkeys])
        out.append((i, j, t_rand, u_imp, reg))
    return out


def _check_map(got, jout, jloss, trainable, lr_tab):
    """The mapping tolerances of tests/test_torch_engine.py (losses rtol
    2e-4, poses atol 2e-5, volumes atol 1e-3, decoders atol 2e-4), except
    that at most 0.1% of the volume entries and 1% of a decoder tensor's
    weights may differ more, within the reach of the call's steps (2 x lr
    a step): an entry whose gradient is rounding noise (per-frame terms
    that nearly cancel) takes an Adam step of either sign.  The JAX
    package's own sharded-against-replicated test (tests/
    test_distributed.py) allows the same 0.1% of the volumes, and tests/
    test_torch_imap.py the same 1% of the weights."""
    from nice_slam_tpu_torch.engine.mapper import (
        LR_DECODERS, STAGE_ORDER)
    from nice_slam_tpu_torch.models.convert import decoders_from_numpy
    from nice_slam_tpu_torch.models.decoders import DecoderConfig
    np.testing.assert_allclose(got['losses'], np_of(jloss), rtol=2e-4)
    np.testing.assert_allclose(got['cams'], np_of(jout['cams']), atol=2e-5)
    lr_tab = np.asarray(lr_tab)
    for name, g in got['grids'].items():
        diff = np.abs(g - np_of(jout['grids'][name]))
        reach = 2 * lr_tab[:, 1 + STAGE_ORDER.index(name)].sum()
        assert np.mean(diff > 1e-3) <= 1e-3, (name, np.mean(diff > 1e-3))
        assert diff.max() <= reach, (name, diff.max(), reach)
    reach = 2 * lr_tab[:, LR_DECODERS].sum()
    for name in trainable:
        ref = decoders_from_numpy({name: tree_np(jout['dec'][name])},
                                  DecoderConfig())[name].state_dict()
        for k, v in got['dec'][name].items():
            diff = np.abs(v - np_of(ref[k]))
            assert np.mean(diff > 2e-4) <= 0.01, (name, k)
            assert diff.max() <= reach, (name, k, diff.max(), reach)


@pytest.mark.parametrize('perturb', [0.0, 1.0])
def test_kf_sharded_nice_matches_jax(pool, perturb):
    """4 frames over 4 ranks, one frame each, against JAX's
    make_kf_sharded_map_step over 4 devices on the same draws."""
    from nice_slam_tpu.parallel.distributed import (
        kf_mesh, make_kf_sharded_map_step, window_to_global)
    from tests.test_distributed import _setup
    (model, rcfg, mcfg, intr, opt_params, frozen, colors, depths, lr_tab,
     stage_idx, cam_mask, key) = _setup(4, perturb=perturb)
    mesh = kf_mesh(jax.devices()[:4])
    step = make_kf_sharded_map_step(
        mesh=mesh, model=model, rcfg=rcfg, mcfg=mcfg, intr=intr, n_frames=4,
        n_iters=mcfg.iters, pix_per_frame=16)
    c_g, d_g = window_to_global(mesh, np.asarray(colors), np.asarray(depths))
    jout, _, jloss = step(opt_params, frozen, None, lr_tab, stage_idx,
                          cam_mask, c_g, d_g, key)
    params = {**frozen, **opt_params['dec']}
    res = pool.run(
        'kf_map', spec=spec_of(model, params, opt_params['grids']),
        mcfg=mcfg_of(mcfg), rcfg=rcfg_of(rcfg), intr=tuple(intr),
        lr_tab=np.asarray(lr_tab), stage_idx=np.asarray(stage_idx),
        cam_mask=np.asarray(cam_mask), trainable=('color', 'fine'),
        cams=np.asarray(opt_params['cams']), colors=np.asarray(colors),
        depths=np.asarray(depths), pix=16,
        draws=_kf_draws(key, mcfg.iters, 4, 16, intr, rcfg))
    same_bits(res, ['cams', 'losses'])
    for r in res[1:]:
        for name in r['grids']:
            np.testing.assert_array_equal(r['grids'][name],
                                          res[0]['grids'][name])
    _check_map(res[0], jout, jloss, ('color', 'fine'), lr_tab)


@pytest.mark.parametrize('perturb', [0.0, 1.0])
def test_kf_sharded_imap_matches_jax(pool, perturb):
    """iMAP*: density compositing, importance resampling and the
    regulation under keyframe sharding (mirrors test_distributed.py's
    iMAP case): the port's single-rank step up to the order of the sums,
    and JAX's keyframe-sharded step (see the tolerances below)."""
    from nice_slam_tpu.core.cameras import Intrinsics
    from nice_slam_tpu.engine.mapper import (
        MapperConfig, lr_table, stage_schedule)
    from nice_slam_tpu.models.decoders import (
        DecoderConfig, init_imap_decoder)
    from nice_slam_tpu.parallel.distributed import (
        kf_mesh, make_kf_sharded_map_step, window_to_global)
    from nice_slam_tpu.render.renderer import RenderConfig, SceneModel
    dcfg = DecoderConfig(pos_embedding_method='nerf', imap_hidden=32,
                         imap_blocks=2)
    bound = jnp.asarray([[-2.0, 2.0], [-2.0, 2.0], [-2.0, 2.0]])
    model = SceneModel(kind='imap', decoder=dcfg, bound=bound)
    rcfg = RenderConfig(n_samples=8, n_surface=0, n_importance=4,
                        occupancy=False, perturb=perturb)
    mcfg = MapperConfig(pixels=32, iters=4, ba=True, window_size=4)
    intr = Intrinsics(H=24, W=32, fx=16.0, fy=16.0, cx=15.5, cy=11.5)
    key = jax.random.PRNGKey(3)
    params = init_imap_decoder(key, dcfg)
    rng = np.random.default_rng(1)
    cams = jnp.asarray([[1.0, 0, 0, 0, 0.05 * i, 0, 0] for i in range(4)])
    colors = np.asarray(rng.random((4, 24, 32, 3)), np.float32)
    depths = np.asarray(0.5 + rng.random((4, 24, 32)), np.float32)
    lr_tab = lr_table(mcfg, 4, 1.0, False, True)
    stage_idx = stage_schedule(mcfg, 4, False)
    cam_mask = np.asarray([0.0, 1.0, 1.0, 1.0], np.float32)
    mesh = kf_mesh(jax.devices()[:4])
    step = make_kf_sharded_map_step(
        mesh=mesh, model=model, rcfg=rcfg, mcfg=mcfg, intr=intr,
        n_frames=4, n_iters=4, pix_per_frame=8)
    c_g, d_g = window_to_global(mesh, colors, depths)
    jout, _, jloss = step(
        {'cams': cams, 'grids': {}, 'dec': {'imap': params}}, {}, None,
        jnp.asarray(lr_tab), jnp.asarray(stage_idx), jnp.asarray(cam_mask),
        c_g, d_g, key)
    spec = spec_of(model, {'imap': params}, None, dcfg)
    draws = _kf_draws(key, 4, 4, 8, intr, rcfg)
    res = pool.run(
        'kf_map', spec=spec, mcfg=mcfg_of(mcfg), rcfg=rcfg_of(rcfg),
        intr=tuple(intr), lr_tab=lr_tab, stage_idx=stage_idx,
        cam_mask=cam_mask, trainable=('imap',), cams=np.asarray(cams),
        colors=colors, depths=depths, pix=8, draws=draws)
    same_bits(res, ['cams', 'losses'])
    # sharding changes only the order of the sums: the port's single-rank
    # step on the same draws
    from nice_slam_tpu_torch.core.cameras import Intrinsics as TI
    from nice_slam_tpu_torch.engine import mapper as tm
    from nice_slam_tpu_torch.render.renderer import RenderConfig as TR
    from tests.torch_parallel_tasks import _draws, build
    tmodel, decs, _ = build(spec)
    one_cams, one_loss = tm.map_step(
        decs, {}, t_of(cams), trainable=('imap',), masks=None,
        cam_mask=t_of(cam_mask), lr_tab=lr_tab, stage_idx=stage_idx,
        colors=t_of(colors), depths=t_of(depths), model=tmodel,
        rcfg=TR(**rcfg_of(rcfg)), mcfg=tm.MapperConfig(**mcfg_of(mcfg)),
        intr=TI(*intr), pix_per_frame=8, draws=_draws(draws))
    np.testing.assert_allclose(res[0]['losses'], np_of(one_loss), rtol=1e-6)
    np.testing.assert_allclose(res[0]['cams'], np_of(one_cams), atol=1e-6)
    for k, v in decs['imap'].state_dict().items():
        np.testing.assert_allclose(res[0]['dec']['imap'][k], np_of(v),
                                   atol=1e-6, err_msg=k)
    # against JAX: importance resampling puts a sample at the other end of
    # an interval in one package when a uniform ties with a cdf entry to
    # the last bit (the deterministic uniforms' last one ties with the
    # cdf's end, see tests/test_torch_imap.py; after a step a random one
    # can): the losses within 5e-3, the poses within a quarter of the
    # call's reach (4 x BA lr 0.001); with perturb 1 the first iteration,
    # at equal parameters and the same uniforms, at rtol 1e-4
    np.testing.assert_allclose(res[0]['losses'], np_of(jloss), rtol=5e-3)
    np.testing.assert_allclose(res[0]['cams'], np_of(jout['cams']),
                               atol=1e-3)
    if perturb:
        np.testing.assert_allclose(res[0]['losses'][0], np_of(jloss)[0],
                                   rtol=1e-4)


# -- ray-sharded mapping ------------------------------------------------------

def _ray_draws(key, n_iters, n_frames, local_pix, intr, n_dev):
    """JAX make_sharded_map_step's per-device draws, rebuilt from outside:
    device me draws from fold_in(fold_in(key, it), me), one stream per
    frame."""
    from nice_slam_tpu.core.sampling import sample_pixels
    out = []
    for me in range(n_dev):
        dev = []
        for it in range(n_iters):
            k = jax.random.fold_in(jax.random.fold_in(key, it), me)
            fkeys = jax.random.split(k, n_frames)
            ij = [sample_pixels(fk, local_pix, 0, intr.H, 0, intr.W)
                  for fk in fkeys]
            dev.append((np.stack([np.asarray(a) for a, _ in ij]),
                        np.stack([np.asarray(b) for _, b in ij])))
        out.append(dev)
    return out


def test_ray_sharded_map_matches_jax(pool):
    """Two ranks against JAX's make_sharded_map_step on a 2-device mesh,
    the per-device draws rebuilt from its keys (each rank's far clamp is
    its own batch's maximum in both)."""
    from nice_slam_tpu.parallel.mesh import make_ray_mesh
    from nice_slam_tpu.parallel.sharded import make_sharded_map_step
    from tests.test_distributed import _setup
    (model, rcfg, mcfg, intr, opt_params, frozen, colors, depths, lr_tab,
     stage_idx, cam_mask, key) = _setup(4)
    step = make_sharded_map_step(
        mesh=make_ray_mesh(2), model=model, rcfg=rcfg, mcfg=mcfg, intr=intr,
        n_frames=4, n_iters=mcfg.iters, pix_per_frame=16)
    jout, _, jloss = step(opt_params, frozen, None, lr_tab, stage_idx,
                          cam_mask, colors, depths, key)
    params = {**frozen, **opt_params['dec']}
    res = pool.run(
        'ray_map', spec=spec_of(model, params, opt_params['grids']),
        mcfg=mcfg_of(mcfg), rcfg=rcfg_of(rcfg), intr=tuple(intr),
        lr_tab=np.asarray(lr_tab), stage_idx=np.asarray(stage_idx),
        cam_mask=np.asarray(cam_mask), trainable=('color', 'fine'),
        cams=np.asarray(opt_params['cams']), colors=np.asarray(colors),
        depths=np.asarray(depths), pix=16,
        draws=_ray_draws(key, mcfg.iters, 4, 8, intr, 2))
    same_bits(res, ['cams', 'losses'])
    _check_map(res[0], jout, jloss, ('color', 'fine'), lr_tab)


def _blocked_setup():
    """tests/test_blocked.py's mapping inputs (constant depth 0.9, so
    every ray share's far clamp is the window's)."""
    from nice_slam_tpu.engine.mapper import (
        MapperConfig, lr_table, stage_schedule)
    model, rcfg, grids, params, key, intr = tiny()
    stage_lr = tuple((s, (0.005, 0.001, 0.1, 0.005, 0.005))
                     for s in ('coarse', 'middle', 'fine', 'color'))
    mcfg = MapperConfig(pixels=16, iters=4, stage_lr=stage_lr,
                        fix_fine=False, fix_color=False, ba=True)
    n_frames, n_iters = 2, 4
    common = dict(
        spec=spec_of(model, params, grids), mcfg=mcfg_of(mcfg),
        rcfg=rcfg_of(rcfg), intr=tuple(intr),
        lr_tab=lr_table(mcfg, n_iters, 1.0, True, True),
        stage_idx=stage_schedule(mcfg, n_iters, True),
        cam_mask=np.asarray([0.0, 1.0], np.float32),
        trainable=('color', 'fine'),
        cams=np.asarray([[1.0, 0, 0, 0, 0.1, 0, 0]] * n_frames, np.float32),
        colors=np.full((n_frames, 24, 32, 3), 0.5, np.float32),
        depths=np.full((n_frames, 24, 32), 0.9, np.float32), pix=8)
    rng = np.random.default_rng(7)
    # each of two ray shares draws 4 pixels a frame
    draws = [[(rng.integers(0, 32, (n_frames, 4)).astype(np.float32),
               rng.integers(0, 24, (n_frames, 4)).astype(np.float32))
              for _ in range(n_iters)] for _ in range(2)]
    return model, common, draws


def test_ray_sharded_map_is_one_rank_on_the_concatenated_draws(pool):
    """Two ranks against the port's single-rank map_step fed the two
    ranks' draws side by side: the same step up to summation order (the
    depth is constant, so the ranks' far clamps are the window's)."""
    from nice_slam_tpu_torch.engine import mapper as tm
    from nice_slam_tpu_torch.core.cameras import Intrinsics as TI
    from nice_slam_tpu_torch.render.renderer import RenderConfig as TR
    from tests.torch_parallel_tasks import build
    model, common, draws = _blocked_setup()
    res = pool.run('ray_map', draws=draws, **common)
    same_bits(res, ['cams', 'losses'])
    tmodel, decs, grids = build(common['spec'])
    both = [(t_of(np.concatenate([a[0], b[0]], 1)),
             t_of(np.concatenate([a[1], b[1]], 1)))
            for a, b in zip(*draws)]
    cams, losses = tm.map_step(
        decs, grids, t_of(common['cams']), trainable=common['trainable'],
        masks=None, cam_mask=t_of(common['cam_mask']),
        lr_tab=common['lr_tab'], stage_idx=common['stage_idx'],
        colors=t_of(common['colors']), depths=t_of(common['depths']),
        model=tmodel, rcfg=TR(**common['rcfg']),
        mcfg=tm.MapperConfig(**common['mcfg']), intr=TI(*common['intr']),
        pix_per_frame=8, draws=both)
    np.testing.assert_allclose(res[0]['losses'], np_of(losses), rtol=1e-5)
    np.testing.assert_allclose(res[0]['cams'], np_of(cams), atol=1e-6)
    for name, g in grids.items():
        np.testing.assert_allclose(res[0]['grids'][name], np_of(g),
                                   rtol=1e-4, atol=5e-6, err_msg=name)


# -- sharded lattice query ----------------------------------------------------

@pytest.fixture(scope='module')
def eval_case():
    """The points of tests/test_parallel.py's case and JAX's
    sharded_eval_points over 8 devices (compiled once)."""
    from nice_slam_tpu.parallel.mesh import make_ray_mesh
    from nice_slam_tpu.parallel.sharded import sharded_eval_points
    model, rcfg, grids, params, key, intr = tiny()
    pts = jax.random.uniform(key, (64, 3), minval=-1.0, maxval=1.0)
    want = sharded_eval_points(make_ray_mesh(8), params, grids, pts, 'fine',
                               model)
    return spec_of(model, params, grids), np.asarray(pts), np_of(want)


@pytest.mark.parametrize('ranks, n', [(4, 64), (4, 61), (2, 64)])
def test_sharded_eval_points(pool, eval_case, ranks, n):
    """The gather returns every slice's own bits: bit-equal to one rank
    querying the same slices.  Against one rank's query of the whole batch
    within 1e-6: on the CPU the plain decoder's matmuls block the rows by
    the batch's size, so a row's sums may round differently (the fused
    kernel on the card treats points one by one: chip_smoke.py holds that
    query bit-equal).  Within 2e-5 of JAX's sharded_eval_points
    (tests/test_parallel.py)."""
    spec, pts, want = eval_case
    res = pool.run('eval_points', spec=spec, points=pts[:n], stage='fine',
                   ranks=ranks)
    for r in res:
        np.testing.assert_array_equal(r['sharded'], r['slices'])
        np.testing.assert_allclose(r['sharded'], r['one'], rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(r['sharded'], want[:n], atol=2e-5)
        np.testing.assert_array_equal(r['sharded'], res[0]['sharded'])


# -- grid-block tensor parallelism (mirrors tests/test_blocked.py) -----------

@pytest.mark.parametrize('n_block', [2, 4])
def test_blocked_interp_matches_unsharded_and_jax(pool, n_block):
    """nx = 9 does not divide over the blocks (the padded path); the
    values against the port's unsharded interpolation and JAX's
    trilinear_interp_blocked, the slab gradients (the halo plane's
    returned to its owner) reassembled against the unsharded gradient."""
    from jax.sharding import PartitionSpec as P
    from nice_slam_tpu.ops.trilinear import trilinear_interp
    from nice_slam_tpu.parallel.blocks import (
        make_blocked, plan_blocks, trilinear_interp_blocked)
    nx, ny, nz, c = 9, 5, 4, 8
    rng = np.random.default_rng(0)
    grid = rng.normal(size=(nx * ny * nz, c)).astype(np.float32)
    pts = rng.uniform(-1.2, 1.2, size=(64, 3)).astype(np.float32)
    cot = rng.normal(size=(64, c)).astype(np.float32)
    plan = plan_blocks((('g', (nx, ny, nz)),), n_block)['g']
    padded = jnp.pad(jnp.asarray(grid),
                     ((0, plan['rows_pad'] - grid.shape[0]), (0, 0)))
    devs = np.asarray(jax.devices()[:n_block]).reshape(n_block, 1)
    mesh = jax.sharding.Mesh(devs, ('block', 'rays'))

    def local(slab, p):
        bg = make_blocked(slab, (nx, ny, nz), plan['local_nx'], 'block')
        return trilinear_interp_blocked(bg, p)

    jgot = jax.jit(jax.shard_map(local, mesh=mesh,
                                 in_specs=(P('block'), P()), out_specs=P(),
                                 check_vma=False))(padded, jnp.asarray(pts))
    jwant = trilinear_interp(jnp.asarray(grid), jnp.asarray(pts),
                             (nx, ny, nz))
    res = pool.run('blocked_interp', grid=grid, shape=(nx, ny, nz),
                   points=pts, cot=cot, n_block=n_block)
    for r in res:
        np.testing.assert_allclose(r['out'], r['want'], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r['out'], np_of(jgot), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r['want'], np_of(jwant), rtol=1e-5,
                                   atol=1e-6)
    # one slab per block (the ranks of a block agree bit for bit)
    slabs = {}
    for r in res:
        if r['block'] in slabs:
            np.testing.assert_array_equal(r['g_slab'], slabs[r['block']])
        slabs[r['block']] = r['g_slab']
    g = np.concatenate([slabs[b] for b in range(n_block)])[:nx * ny * nz]
    np.testing.assert_allclose(g, res[0]['g_full'], rtol=1e-5, atol=1e-6)


def test_blocked_interp_gradient_matches_jax(pool):
    """tests/test_blocked.py's gradient case (8x4x4, 4 blocks, nx
    divisible): the slab gradients reassembled against JAX's gradient of
    the unsharded interpolation."""
    from nice_slam_tpu.ops.trilinear import trilinear_interp
    nx, ny, nz, c = 8, 4, 4, 4
    rng = np.random.default_rng(1)
    grid = rng.normal(size=(nx * ny * nz, c)).astype(np.float32)
    pts = rng.uniform(-1.1, 1.1, size=(32, 3)).astype(np.float32)
    cot = rng.normal(size=(32, c)).astype(np.float32)
    want = jax.grad(lambda g: jnp.sum(trilinear_interp(
        g, jnp.asarray(pts), (nx, ny, nz)) * cot))(jnp.asarray(grid))
    res = pool.run('blocked_interp', grid=grid, shape=(nx, ny, nz),
                   points=pts, cot=cot, n_block=4)
    g = np.concatenate([r['g_slab'] for r in sorted(
        res, key=lambda r: r['block'])])
    np.testing.assert_allclose(g, np_of(want), rtol=1e-5, atol=1e-6)


def test_blocked_map_step_matches_ray_sharded(pool):
    """The blocked step (2 blocks x 2 ray shares) against the ray-sharded
    step (2 ray shares) on the same draws: same losses, volumes and
    poses (mirrors tests/test_blocked.py)."""
    model, common, draws = _blocked_setup()
    ray = pool.run('ray_map', draws=draws, **common)
    blk = pool.run('blocked_map', draws=draws, n_block=2, **common)
    same_bits(blk, ['cams', 'losses'])
    np.testing.assert_allclose(blk[0]['losses'], ray[0]['losses'],
                               rtol=1e-4)
    np.testing.assert_allclose(blk[0]['cams'], ray[0]['cams'], rtol=1e-4,
                               atol=1e-6)
    from nice_slam_tpu_torch.parallel.blocks import (
        plan_blocks, unpad_from_blocks)
    shapes = common['spec']['grid_shapes']
    plan = plan_blocks(shapes, 2)
    by_block = {r['block']: r['grids'] for r in blk}
    padded = {name: torch.tensor(np.concatenate(
        [by_block[b][name] for b in range(2)])) for name in by_block[0]}
    got = unpad_from_blocks(padded, plan, shapes)
    for name, want in ray[0]['grids'].items():
        assert padded[name].shape[0] == plan[name]['rows_pad']
        # the padding planes are never read, so they stay zero
        assert not padded[name][want.shape[0]:].any()
        np.testing.assert_allclose(np_of(got[name]), want, rtol=1e-4,
                                   atol=5e-6, err_msg=name)
