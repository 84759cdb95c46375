"""Port parity, L3: one tracking frame and one mapping call of
nice_slam_tpu_torch.engine against nice_slam_tpu.engine, fed the pixel
indices the JAX step draws internally (reproduced here from its keys:
fold_in per iteration, split per window frame, sample_pixels), plus the
frustum masks, keyframe selection, Adam and config views.

Tolerances: the losses agree to float32 rounding of ~10^4-sample sums
(rtol 1e-4).  After several Adam steps the parameters differ by rounding
amplified through Adam's g/sqrt(v) normalization, bounded by a small
fraction of one step (lr), hence the lr-relative tolerances below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nice_slam_tpu.core.cameras import tensor_from_c2w
from nice_slam_tpu.core.sampling import sample_pixels
from nice_slam_tpu.engine import frustum as jf
from nice_slam_tpu.engine import keyframes as jk
from nice_slam_tpu.engine import mapper as jm
from nice_slam_tpu.engine import tracker as jt
from nice_slam_tpu.io.datasets import get_dataset
from nice_slam_tpu.models.decoders import init_nice_decoders
from nice_slam_tpu.models.grids import (
    grid_world_coords, init_grids, static_grid_shapes)
from nice_slam_tpu.render.renderer import SceneModel
from nice_slam_tpu.utils import config as jcfg
from nice_slam_tpu.utils.optim import adam_init, adam_update
from nice_slam_tpu_torch.engine import frustum as tf
from nice_slam_tpu_torch.engine import keyframes as tk
from nice_slam_tpu_torch.engine import mapper as tm
from nice_slam_tpu_torch.engine import tracker as tt
from nice_slam_tpu_torch.io.datasets import get_dataset as tget_dataset
from nice_slam_tpu_torch.models.convert import (
    decoders_from_numpy, grids_from_numpy)
from nice_slam_tpu_torch.render.renderer import SceneModel as TSceneModel
from nice_slam_tpu_torch.utils import config as tcfg_mod
from nice_slam_tpu_torch.utils.optim import MaskedAdam
from tests.test_torch_util import np_of, t_of, tree_np
from tests.util import make_test_cfg

torch.set_num_threads(2)


@pytest.fixture(scope='module')
def world():
    """Both packages' models on the tiny synthetic scene, with the same
    random decoders and grids (larger than the init scale, so every stage
    has real gradients), and three frames."""
    cfg = make_test_cfg()
    gcfg = jcfg.grid_config_from_cfg(cfg)
    dcfg = jcfg.decoder_config_from_cfg(cfg)
    intr = jcfg.intrinsics_from_cfg(cfg)
    params = init_nice_decoders(jax.random.PRNGKey(3), dcfg)
    rng = np.random.default_rng(3)
    grids = init_grids(jax.random.PRNGKey(4), gcfg)
    grids = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32)
                            * 0.1) for k, v in grids.items()}
    shapes = static_grid_shapes(gcfg)
    jmodel = SceneModel(kind='nice', decoder=dcfg,
                        bound=jnp.asarray(gcfg.bound_np),
                        coarse_bound=jnp.asarray(gcfg.coarse_bound_np),
                        grid_shapes=shapes)
    tdcfg = tcfg_mod.decoder_config_from_cfg(cfg)
    tmodel = TSceneModel(decoder=tdcfg, bound=torch.tensor(gcfg.bound_np),
                         coarse_bound=torch.tensor(gcfg.coarse_bound_np),
                         grid_shapes=shapes)
    ds = get_dataset(cfg)
    frames = [ds[i] for i in (0, 2, 4)]
    return dict(cfg=cfg, gcfg=gcfg, intr=intr, params=params, grids=grids,
                jmodel=jmodel, tmodel=tmodel, frames=frames,
                tintr=tcfg_mod.intrinsics_from_cfg(cfg))


def _port_state(w):
    decs = decoders_from_numpy(tree_np(w['params']), w['tmodel'].decoder)
    grids = grids_from_numpy(tree_np(w['grids']))
    for g in grids.values():
        g.requires_grad_(True)
    return decs, grids


def test_config_views_match(world):
    cfg = world['cfg']
    assert tcfg_mod.intrinsics_from_cfg(cfg) == tuple(world['intr'])
    assert tcfg_mod.grid_config_from_cfg(cfg) == tuple(world['gcfg'])
    from nice_slam_tpu.engine.slam import (
        mapper_config_from_cfg, tracker_config_from_cfg)
    j = jcfg.render_config_from_cfg(cfg)
    assert tcfg_mod.render_config_from_cfg(cfg)._asdict() == j._asdict()
    assert tcfg_mod.tracker_config_from_cfg(cfg) == tuple(
        tracker_config_from_cfg(cfg))
    for coarse in (False, True):
        jmc = mapper_config_from_cfg(cfg, coarse_mapper=coarse)._asdict()
        tmc = tcfg_mod.mapper_config_from_cfg(
            cfg, coarse_mapper=coarse)._asdict()
        for k, v in tmc.items():
            assert jmc[k] == v, k
    # the layered loader over the default config, as run.py uses it
    a = tcfg_mod.load_config('configs/Replica/room0.yaml',
                             'configs/nice_slam.yaml')
    b = jcfg.load_config('configs/Replica/room0.yaml',
                         'configs/nice_slam.yaml')
    assert a == b


def test_schedules_match(world):
    from nice_slam_tpu.engine.slam import mapper_config_from_cfg
    jmc = mapper_config_from_cfg(world['cfg'])
    tmc = tcfg_mod.mapper_config_from_cfg(world['cfg'])
    for n in (1, 10, 30, 400):
        np.testing.assert_array_equal(tm.stage_schedule(tmc, n),
                                      jm.stage_schedule(jmc, n, True))
        for ba in (False, True):
            np.testing.assert_array_equal(
                tm.lr_table(tmc, n, 2.0, ba),
                jm.lr_table(jmc, n, 2.0, True, ba))
    cm = tcfg_mod.mapper_config_from_cfg(world['cfg'], coarse_mapper=True)
    jcm = mapper_config_from_cfg(world['cfg'], coarse_mapper=True)
    np.testing.assert_array_equal(tm.lr_table(cm, 7, 1.0, False),
                                  jm.lr_table(jcm, 7, 1.0, True, False))


def test_tracking_frame_matches(world):
    cfg, intr, jmodel = world['cfg'], world['intr'], world['jmodel']
    from nice_slam_tpu.engine.slam import tracker_config_from_cfg
    jrcfg = jcfg.render_config_from_cfg(cfg)
    jtcfg = tracker_config_from_cfg(cfg)._replace(iters=6)
    _, color, depth, gt = world['frames'][1]
    guess = gt.copy()
    guess[:3, 3] += np.array([0.01, -0.008, 0.006], np.float32)
    cam7 = tensor_from_c2w(jnp.asarray(guess[:3, :4]))
    key = jax.random.PRNGKey(11)

    track = jt.make_track_frame(model=jmodel, rcfg=jrcfg, tcfg=jtcfg,
                                intr=intr)
    jbest, jlast, jlosses = track(world['params'], world['grids'],
                                  jnp.asarray(color), jnp.asarray(depth),
                                  cam7, key)
    draws = []
    for it in range(jtcfg.iters):
        i, j = sample_pixels(jax.random.fold_in(key, it), jtcfg.pixels,
                             jtcfg.ignore_edge_h, intr.H - jtcfg.ignore_edge_h,
                             jtcfg.ignore_edge_w, intr.W - jtcfg.ignore_edge_w)
        draws.append((t_of(i), t_of(j)))

    decs, grids = _port_state(world)
    ttcfg = tcfg_mod.tracker_config_from_cfg(cfg)._replace(iters=6)
    tbest, tlast, tlosses = tt.track_frame(
        decs, grids, t_of(color), t_of(depth), t_of(cam7),
        model=world['tmodel'], rcfg=tcfg_mod.render_config_from_cfg(cfg),
        tcfg=ttcfg, intr=world['tintr'], draws=draws)
    np.testing.assert_allclose(np_of(tlosses), np_of(jlosses), rtol=1e-4)
    # the pose moves lr=0.002 per step; agree to 2% of one step
    np.testing.assert_allclose(np_of(tlast), np_of(jlast), atol=4e-5)
    np.testing.assert_allclose(np_of(tbest), np_of(jbest), atol=4e-5)
    assert float(np.abs(np_of(tlast) - np_of(cam7)).max()) > 1e-3


def test_mapping_call_matches(world):
    """One BA mapping call whose 12 iterations cross middle -> fine ->
    color, with frustum masks and every decoder trainable."""
    cfg, intr, jmodel = world['cfg'], world['intr'], world['jmodel']
    from nice_slam_tpu.engine.slam import mapper_config_from_cfg
    jmcfg = mapper_config_from_cfg(cfg)._replace(ba=True)
    tmcfg = tcfg_mod.mapper_config_from_cfg(cfg)._replace(ba=True)
    jrcfg = jcfg.render_config_from_cfg(cfg)
    n_iters, n_frames, pix = 12, 3, 40
    lr_tab = jm.lr_table(jmcfg, n_iters, 0.2, True, True)
    stage_idx = jm.stage_schedule(jmcfg, n_iters, True)
    assert set(stage_idx.tolist()) == {1, 2, 3}
    colors = np.stack([f[1] for f in world['frames']])
    depths = np.stack([f[2] for f in world['frames']])
    c2ws = np.stack([f[3] for f in world['frames']])
    cams = tensor_from_c2w(jnp.asarray(c2ws[:, :3, :4]))
    cams = cams.at[1:, 4:].add(0.005)
    cam_mask = np.array([0.0, 1.0, 1.0], np.float32)
    cur = c2ws[-1]
    masks = {}
    for name, g in world['grids'].items():
        if name == 'coarse':
            masks[name] = jnp.ones((g.shape[0], 1))
        else:
            pts = jnp.asarray(grid_world_coords(world['gcfg'],
                                                name).reshape(-1, 3))
            masks[name] = jf.frustum_mask(pts, jnp.asarray(cur),
                                          jnp.asarray(depths[-1]),
                                          intr)[:, None]
    trainable = ('color', 'fine', 'middle')
    opt = {'cams': cams, 'grids': world['grids'],
           'dec': {k: world['params'][k] for k in trainable}}
    frozen = {'coarse': world['params']['coarse']}
    key = jax.random.PRNGKey(21)
    step = jm.make_map_step(model=jmodel, rcfg=jrcfg, mcfg=jmcfg, intr=intr,
                            n_frames=n_frames, n_iters=n_iters,
                            pix_per_frame=pix)
    jout, _, jlosses = step(opt, frozen, masks, jnp.asarray(lr_tab),
                            jnp.asarray(stage_idx), jnp.asarray(cam_mask),
                            jnp.asarray(colors), jnp.asarray(depths), key)
    draws = []
    for it in range(n_iters):
        fkeys = jax.random.split(jax.random.fold_in(key, it), n_frames)
        ij = [sample_pixels(k, pix, 0, intr.H, 0, intr.W) for k in fkeys]
        draws.append((t_of(np.stack([a for a, _ in ij])),
                      t_of(np.stack([b for _, b in ij]))))

    decs, grids = _port_state(world)
    tcams, tlosses = tm.map_step(
        decs, grids, t_of(cams), trainable=trainable,
        masks={k: t_of(v) for k, v in masks.items()},
        cam_mask=t_of(cam_mask), lr_tab=lr_tab, stage_idx=stage_idx,
        colors=t_of(colors), depths=t_of(depths), model=world['tmodel'],
        rcfg=tcfg_mod.render_config_from_cfg(cfg), mcfg=tmcfg,
        intr=world['tintr'], pix_per_frame=pix, draws=draws)

    np.testing.assert_allclose(np_of(tlosses), np_of(jlosses), rtol=2e-4)
    # poses: BA lr 0.001 in the 5 color iterations
    np.testing.assert_allclose(np_of(tcams), np_of(jout['cams']), atol=2e-5)
    assert float(np.abs(np_of(tcams) - np_of(cams)).max()) > 1e-4
    # grids: the middle lr is 0.02 -- agree to 5% of one step
    for name, g in grids.items():
        np.testing.assert_allclose(np_of(g), np_of(jout['grids'][name]),
                                   atol=1e-3, err_msg=name)
    for name in trainable:
        want = decoders_from_numpy({name: tree_np(jout['dec'][name])},
                                   world['tmodel'].decoder)[name]
        for (k, a), (_, b) in zip(decs[name].state_dict().items(),
                                  want.state_dict().items()):
            np.testing.assert_allclose(np_of(a), np_of(b), atol=2e-4,
                                       err_msg=f'{name}.{k}')


def test_frame_groups_accumulate_to_the_same_step(world):
    """max_rays_per_pass splits the window into frame groups whose
    gradients accumulate: the same step as the whole window at once."""
    cfg = world['cfg']
    tmcfg = tcfg_mod.mapper_config_from_cfg(cfg)
    colors = t_of(np.stack([f[1] for f in world['frames']]))
    depths = t_of(np.stack([f[2] for f in world['frames']]))
    cams = t_of(np.stack([np_of(tensor_from_c2w(jnp.asarray(f[3][:3, :4])))
                          for f in world['frames']]))
    lr_tab = tm.lr_table(tmcfg, 6, 1.0, True)
    stage_idx = tm.stage_schedule(tmcfg, 6)
    g = torch.Generator().manual_seed(0)
    draws = [tm.draw_window_pixels(3, 30, world['tintr'], generator=g,
                                   device='cpu') for _ in range(6)]
    outs = []
    for max_rays in (0, 30):
        decs, grids = _port_state(world)
        cams_out, losses = tm.map_step(
            decs, grids, cams, trainable=('color', 'fine'), masks=None,
            cam_mask=torch.tensor([0.0, 1.0, 1.0]), lr_tab=lr_tab,
            stage_idx=stage_idx, colors=colors, depths=depths,
            model=world['tmodel'], rcfg=tcfg_mod.render_config_from_cfg(cfg),
            mcfg=tmcfg._replace(max_rays_per_pass=max_rays),
            intr=world['tintr'], pix_per_frame=30, draws=draws)
        outs.append((cams_out, losses, grids))
    np.testing.assert_allclose(np_of(outs[0][1]), np_of(outs[1][1]),
                               rtol=1e-5)
    np.testing.assert_allclose(np_of(outs[0][0]), np_of(outs[1][0]),
                               atol=1e-6)
    # the grouped gradient differs by f32 summation order; Adam's
    # g/sqrt(v) can turn that into a small fraction of one step (lr up to
    # 0.1) at entries whose gradient is near zero
    for k in outs[0][2]:
        np.testing.assert_allclose(np_of(outs[0][2][k]),
                                   np_of(outs[1][2][k]), atol=2e-4)
    with pytest.raises(ValueError):
        tm.map_step(decs, grids, cams, trainable=(), masks=None,
                    cam_mask=None, lr_tab=lr_tab, stage_idx=stage_idx,
                    colors=colors, depths=depths, model=world['tmodel'],
                    rcfg=tcfg_mod.render_config_from_cfg(cfg),
                    mcfg=tmcfg._replace(max_rays_per_pass=10),
                    intr=world['tintr'], pix_per_frame=30, draws=draws)


def test_frustum_mask_matches(world):
    _, _, depth, c2w = world['frames'][1]
    for name in ('middle', 'fine'):
        pts = grid_world_coords(world['gcfg'], name).reshape(-1, 3)
        want = jf.frustum_mask(jnp.asarray(pts), jnp.asarray(c2w),
                               jnp.asarray(depth), world['intr'])
        got = tf.frustum_mask(t_of(pts), t_of(c2w), t_of(depth),
                              world['tintr'])
        np.testing.assert_array_equal(np_of(got), np_of(want))
        assert 0 < float(got.sum()) < len(pts)


def test_keyframe_selection_matches(world):
    jstore, tstore = jk.KeyframeStore(), tk.KeyframeStore()
    ds = get_dataset(make_test_cfg(n_frames=12))
    for idx in range(0, 12, 2):
        _, c, d, p = ds[idx]
        p = p.copy()
        p[:3, 3] += 0.01 * idx
        jstore.append(jk.Keyframe(idx, c, d, p, p))
        tstore.append(tk.Keyframe(idx, c, d, p, p))
    _, _, d, p = ds[11]
    for seed in range(3):
        assert tstore.select_global(np.random.default_rng(seed), 3) == \
            jstore.select_global(np.random.default_rng(seed), 3)
        assert tstore.select_overlap(np.random.default_rng(seed), 3, d, p,
                                     world['tintr']) == \
            jstore.select_overlap(np.random.default_rng(seed), 3, d, p,
                                  world['intr'])


def test_synthetic_frames_match():
    cfg = make_test_cfg(n_frames=3)
    for a, b in zip(tget_dataset(cfg)[2], get_dataset(cfg)[2]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_const_speed_init_matches():
    rng = np.random.default_rng(4)
    a, b = np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32)
    a[:3, 3], b[:3, 3] = rng.normal(size=3), rng.normal(size=3)
    np.testing.assert_allclose(
        tt.const_speed_init(a, b),
        np_of(jt.const_speed_init(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-6)


# -- Adam (mirrors tests/test_optim.py) -------------------------------------

def test_adam_matches_jax_and_torch():
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(8,)).astype(np.float32)
    a = rng.normal(size=(8,)).astype(np.float32)
    xt = torch.tensor(x0)
    ref = torch.tensor(x0, requires_grad=True)
    ref_opt = torch.optim.Adam([ref], lr=0.01)
    opt = MaskedAdam([xt])
    xj, st = jnp.asarray(x0), adam_init(jnp.asarray(x0))
    for _ in range(25):
        opt.step([2 * (xt - torch.tensor(a))], [0.01])
        ref_opt.zero_grad()
        ((ref - torch.tensor(a)) ** 2).sum().backward()
        ref_opt.step()
        xj, st = adam_update(xj, 2 * (xj - jnp.asarray(a)), st, 0.01)
    np.testing.assert_allclose(np_of(xt), np_of(xj), atol=1e-5)
    np.testing.assert_allclose(np_of(xt), np_of(ref), atol=1e-5)


def test_adam_group_lrs_masks_and_missing_grads():
    a, b, c = torch.ones(4), torch.ones(4), torch.ones(2)
    opt = MaskedAdam([a, b, c])
    opt.step([torch.full((4,), 2.0), torch.full((4,), 2.0), None],
             [0.1, 0.0, 0.1], [torch.tensor([1.0, 1.0, 0.0, 0.0]), None,
                               None])
    np.testing.assert_allclose(np_of(b), 1.0)       # lr 0: unchanged ...
    assert float(opt.mu[1][0]) > 0.0                # ... moments accumulate
    np.testing.assert_allclose(np_of(a[2:]), 1.0)   # masked: unchanged ...
    assert float(opt.mu[0][2]) == 0.0 and float(opt.nu[0][2]) == 0.0
    assert bool((a[:2] < 1.0).all())
    np.testing.assert_allclose(np_of(c), 1.0)       # no gradient = zero
    # zero gradients after real ones still move the parameter, as in JAX
    opt.step([None, None, None], [0.1, 0.1, 0.1])
    params = {'a': jnp.ones(4)}
    st = adam_init(params)
    params, st = adam_update(params, {'a': jnp.full((4,), 2.0)}, st,
                             {'a': 0.1},
                             mask={'a': jnp.array([1.0, 1.0, 0.0, 0.0])})
    params, st = adam_update(params, {'a': jnp.zeros(4)}, st, {'a': 0.1})
    np.testing.assert_allclose(np_of(a), np_of(params["a"]), atol=1e-5)
