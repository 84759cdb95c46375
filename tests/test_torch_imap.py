"""Port parity, iMAP* mode: sample_pdf, both compositing modes, the iMAP*
decoder carried across by models.convert, render_rays with importance
resampling, the free-space regulation, the iMAP* schedules, and one
mapping call and one tracked frame of nice_slam_tpu_torch against
nice_slam_tpu on the same inputs (the JAX-drawn pixels, pdf uniforms and
regulation jitter, reproduced here from its keys).

Tolerances: sample_pdf and compositing are a few float32 operations per
value (rtol 1e-5).  The iMAP* decoder is a Fourier embedding (sin of
arguments up to ~50) and dense layers of width up to 256, whose float32
dot products XLA and torch sum in different orders on the CPU: 1e-4
relative to the largest output.  Losses over ~10^4 samples agree to rtol
1e-4; after several Adam steps the parameters differ by rounding amplified
through Adam's g/sqrt(v), bounded by a fraction of one step (lr), hence
the lr-relative tolerances below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nice_slam_tpu.core import composite as jcomp
from nice_slam_tpu.core import sampling as js
from nice_slam_tpu.core.cameras import tensor_from_c2w
from nice_slam_tpu.engine import mapper as jm
from nice_slam_tpu.engine import tracker as jt
from nice_slam_tpu.io.datasets import get_dataset
from nice_slam_tpu.models import decoders as jd
from nice_slam_tpu.render import renderer as jr
from nice_slam_tpu.utils import config as jcfg
from nice_slam_tpu_torch.core import composite as tcomp
from nice_slam_tpu_torch.core import sampling as ts
from nice_slam_tpu_torch.engine import mapper as tm
from nice_slam_tpu_torch.engine import tracker as tt
from nice_slam_tpu_torch.models import decoders as td
from nice_slam_tpu_torch.models.convert import decoders_from_numpy
from nice_slam_tpu_torch.render import renderer as tr
from nice_slam_tpu_torch.utils import config as tcfg_mod
from tests.test_torch_util import np_of, t_of, tree_np
from tests.util import make_test_cfg

torch.set_num_threads(2)


def _imap_cfg():
    cfg = make_test_cfg(nice=False, coarse=False)
    cfg['rendering'].update(N_importance=4, N_surface=8)
    return cfg


@pytest.fixture(scope='module')
def world():
    """A small iMAP* decoder (hidden 64, 3 blocks, the Fourier embedding)
    in both packages, the two models on the tiny synthetic scene, and
    three of its frames."""
    cfg = _imap_cfg()
    gcfg = jcfg.grid_config_from_cfg(cfg)
    dcfg = jd.DecoderConfig(imap_hidden=64, imap_blocks=3)
    params = jd.init_imap_decoder(jax.random.PRNGKey(5), dcfg)
    tdcfg = td.DecoderConfig(imap_hidden=64, imap_blocks=3)
    jmodel = jr.SceneModel(kind='imap', decoder=dcfg,
                           bound=jnp.asarray(gcfg.bound_np))
    tmodel = tr.SceneModel(decoder=tdcfg, bound=torch.tensor(gcfg.bound_np),
                           kind='imap')
    ds = get_dataset(cfg)
    return dict(cfg=cfg, params=params, tdcfg=tdcfg, jmodel=jmodel,
                tmodel=tmodel, frames=[ds[i] for i in (0, 2, 4)],
                intr=jcfg.intrinsics_from_cfg(cfg),
                tintr=tcfg_mod.intrinsics_from_cfg(cfg),
                jrcfg=jcfg.render_config_from_cfg(cfg),
                trcfg=tcfg_mod.render_config_from_cfg(cfg))


def _decoders(w):
    return decoders_from_numpy({'imap': tree_np(w['params'])}, w['tdcfg'])


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.2, 0.2, size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    depth = rng.uniform(0.3, 1.2, size=(n,)).astype(np.float32)
    return o, d, depth


@pytest.mark.parametrize('given_u', [False, True])
def test_sample_pdf_matches(given_u):
    """Deterministic (linspace) uniforms, and uniforms given as an input
    (the JAX draw from its key); both with near-empty intervals, which
    the denominator guard keeps finite."""
    rng = np.random.default_rng(3)
    bins = np.sort(rng.uniform(0.1, 3.0, size=(64, 25)), -1).astype(
        np.float32)
    weights = rng.exponential(size=(64, 24)).astype(np.float32)
    weights[:8] = 0.0                  # all intervals below the guard
    weights[8:16, 5:] = 0.0
    key = jax.random.PRNGKey(9)
    want = js.sample_pdf(key, jnp.asarray(bins), jnp.asarray(weights), 12,
                         det=not given_u)
    u = (t_of(jax.random.uniform(key, (64, 12))) if given_u else None)
    got = ts.sample_pdf(t_of(bins), t_of(weights), 12, u=u,
                        det=not given_u)
    assert torch.isfinite(got).all()
    got, want = np_of(got), np_of(want)
    # u = 1 (the last deterministic sample) against a cdf that sums to 1
    # within a float32 ulp: XLA's and torch's cumsum round the total
    # differently, which decides whether u falls in the last interval or
    # past it, and where that interval is below the guard it puts the
    # sample at one end of it or the other.  It must be at an end in both,
    # within the rounding of the total (an ulp) over the last interval's
    # probability (down to 6e-4 here) times its width: 1e-3.
    tie = np.zeros(got.shape, bool)
    if not given_u:
        tie[:, -1] = True
        for x in (got, want):
            assert np.all(np.min(np.abs(x[:, -1:] - bins[:, -2:]),
                                 axis=-1) < 1e-3)
    np.testing.assert_allclose(got[~tie], want[~tie], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('occupancy', [True, False])
def test_composite_modes_match_values_and_gradients(occupancy):
    """Both modes, values and the gradients through raw and the depths,
    with saturated rays (the +1e-10 keeps the backward finite) and the
    density mode's 1e10 last interval scaled by |rays_d|."""
    rng = np.random.default_rng(7)
    raw = rng.normal(size=(16, 24, 4)).astype(np.float32) * 2.0
    raw[0, :, 3] = 8.0 if occupancy else 400.0
    raw[1, :, 3] = -40.0
    z = np.sort(rng.uniform(0.1, 5.0, size=(16, 24)), -1).astype(np.float32)
    d = (rng.normal(size=(16, 3)) * 2.0).astype(np.float32)

    def jloss(r, zz):
        dep, var, rgb, wts = jcomp.composite_rays(r, zz, jnp.asarray(d),
                                                  occupancy=occupancy)
        return (jnp.sum(dep) + jnp.sum(var) + jnp.sum(rgb ** 2)
                + jnp.sum(wts ** 2))

    want = jcomp.composite_rays(jnp.asarray(raw), jnp.asarray(z),
                                jnp.asarray(d), occupancy=occupancy)
    g_raw, g_z = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(raw),
                                                 jnp.asarray(z))
    rt = t_of(raw).requires_grad_()
    zt = t_of(z).requires_grad_()
    got = tcomp.composite_rays(rt, zt, t_of(d), occupancy=occupancy)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np_of(a), np_of(b), rtol=1e-5, atol=1e-6)
    dep, var, rgb, wts = got
    gr, gz = torch.autograd.grad(dep.sum() + var.sum() + (rgb ** 2).sum()
                                 + (wts ** 2).sum(), [rt, zt])
    assert torch.isfinite(gr).all() and torch.isfinite(gz).all()
    np.testing.assert_allclose(np_of(gr), np_of(g_raw), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(np_of(gz), np_of(g_z), rtol=1e-4, atol=1e-4)


def test_density_mode_needs_ray_directions():
    with pytest.raises(ValueError):
        tcomp.composite_rays(torch.zeros(2, 3, 4), torch.ones(2, 3),
                             occupancy=False)


def test_imap_eval_matches_with_carried_weights(monkeypatch):
    """The full-size decoder (hidden 256, 4 blocks, Fourier matrix
    included) carried across by decoders_from_numpy computes the JAX
    field; with no grid features mlp_dispatch never reaches the fused
    kernel, even when asked."""
    dcfg = jd.DecoderConfig()
    params = jd.init_imap_decoder(jax.random.PRNGKey(2), dcfg)
    decs = decoders_from_numpy({'imap': tree_np(params)}, td.DecoderConfig())
    dec = decs['imap']
    assert not hasattr(dec, 'fc_c')
    assert [l.weight.shape[0] for l in dec.pts_linears] == [256] * 4
    np.testing.assert_array_equal(np_of(dec.embedder._B),
                                  np.asarray(params['embed_b']))
    p = np.random.default_rng(1).uniform(-0.6, 0.6, (2048, 3)).astype(
        np.float32)
    want = np_of(jd.imap_eval(params, jnp.asarray(p), dcfg))

    def no_kernel(*args, **kwargs):
        raise AssertionError('the fused kernel was called')

    monkeypatch.setattr(td, 'fused_mlp', no_kernel)
    got = np_of(td.imap_eval(dec, t_of(p)))
    fused = np_of(td.mlp_dispatch(dec, t_of(p), None, fused=True))
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=1e-4 * scale)
    np.testing.assert_array_equal(fused, got)


def test_render_rays_with_importance_matches(world):
    """render_rays (N_samples 16 + N_surface 8 + 4 importance samples,
    density compositing) and eval_raw's out-of-bound value 100, against
    the JAX package."""
    o, d, depth = _rays(96, 4)
    want = jr.render_rays(world['params'], None, jnp.asarray(o),
                          jnp.asarray(d), stage='color',
                          model=world['jmodel'], rcfg=world['jrcfg'],
                          gt_depth=jnp.asarray(depth),
                          key=jax.random.PRNGKey(0))
    got = tr.render_rays(_decoders(world), {}, t_of(o), t_of(d),
                         stage='color', model=world['tmodel'],
                         rcfg=world['trcfg'], gt_depth=t_of(depth))
    assert got[3].shape == (96, 16 + 8 + 4)
    # the last importance sample has u = 1, whose place at one end of the
    # last interval or the other is decided by the rounding of the cdf's
    # total (test_sample_pdf_matches): the point decoded there, and with it
    # a ray's color, may move by up to ~1e-3
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(np_of(a), np_of(b), rtol=1e-4, atol=1e-3)
    pts = t_of(o + 0.1 * d)
    pts[:4] += 5.0                    # points outside the bound
    raw = tr.eval_raw(_decoders(world), {}, pts, 'color', world['tmodel'])
    assert (raw[:4, 3] == 100.0).all() and (raw[4:, 3] != 100.0).all()


def _port_full_redecode(decs, model, rcfg, o, d, depth):
    """The reference's importance path: re-decode all the samples in
    depth order (the port's copy of tests/test_renderer.py's golden)."""
    z_vals = tr._z_values(rcfg, o, d, depth, model.bound, 'color')
    n, s = z_vals.shape
    pts = o[..., None, :] + d[..., None, :] * z_vals[..., :, None]
    raw = tr.eval_raw(decs, {}, pts.reshape(-1, 3), 'color', model)
    _, _, _, weights = tcomp.composite_rays(raw.reshape(n, s, 4), z_vals, d,
                                            occupancy=rcfg.occupancy)
    z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    z_samples = ts.sample_pdf(z_mid, weights[..., 1:-1], rcfg.n_importance,
                              det=True)
    z_all = torch.sort(torch.cat([z_vals, z_samples], -1), -1).values
    pts = o[..., None, :] + d[..., None, :] * z_all[..., :, None]
    raw = tr.eval_raw(decs, {}, pts.reshape(-1, 3), 'color', model)
    return tcomp.composite_rays(raw.reshape(n, -1, 4), z_all, d,
                                occupancy=rcfg.occupancy)


def test_importance_merge_matches_full_redecode(world):
    """Decoding only the new points and merging them by one permutation
    equals re-decoding every sample (the decoder is a pure function)."""
    o, d, depth = (t_of(x) for x in _rays(32, 8))
    decs = _decoders(world)
    rcfg = world['trcfg']._replace(n_importance=8)
    got = tr.render_rays(decs, {}, o, d, stage='color',
                         model=world['tmodel'], rcfg=rcfg, gt_depth=depth)
    want = _port_full_redecode(decs, world['tmodel'], rcfg, o, d, depth)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np_of(g), np_of(w), rtol=1e-5, atol=1e-5)


def test_importance_merge_gradients_flow(world):
    o, d, depth = (t_of(x) for x in _rays(32, 9))
    decs = _decoders(world)
    dep, _, col, _ = tr.render_rays(decs, {}, o, d, stage='color',
                                    model=world['tmodel'],
                                    rcfg=world['trcfg'], gt_depth=depth)
    loss = torch.abs(dep - depth).sum() + col.abs().sum()
    grads = torch.autograd.grad(loss, list(decs.parameters()))
    assert all(torch.isfinite(g).all() for g in grads)
    assert any(float(g.abs().max()) > 0 for g in grads)


def test_regulation_sigma_batched_matches(world):
    """Per-frame jitter: the JAX package's draw from each frame's key is
    the port's t_rand input."""
    f, p, s = 3, 20, world['trcfg'].n_samples
    rng = np.random.default_rng(11)
    o = rng.uniform(-0.2, 0.2, (f, p, 3)).astype(np.float32)
    d = rng.normal(size=(f, p, 3)).astype(np.float32)
    depth = rng.uniform(0.2, 1.5, (f, p)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(4), f)
    want = jr.regulation_sigma_batched(
        world['params'], None, jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(depth), model=world['jmodel'], rcfg=world['jrcfg'],
        keys=keys)
    jitter = np.stack([np.asarray(jax.random.uniform(k, (p, s)))
                       for k in keys])
    got = tr.regulation_sigma_batched(
        _decoders(world), {}, t_of(o), t_of(d), t_of(depth),
        model=world['tmodel'], rcfg=world['trcfg'], t_rand=t_of(jitter))
    assert got.shape == (f * p * s,)
    scale = max(1.0, float(np.abs(np_of(want)).max()))
    np.testing.assert_allclose(np_of(got), np_of(want), atol=1e-4 * scale)


def test_imap_schedules_match(world):
    from nice_slam_tpu.engine.slam import mapper_config_from_cfg
    jmc = mapper_config_from_cfg(world['cfg'])
    tmc = tcfg_mod.mapper_config_from_cfg(world['cfg'])
    assert tmc.imap_decoders_lr == jmc.imap_decoders_lr == 0.001
    for n in (1, 100, 450, 1500):
        np.testing.assert_array_equal(tm.stage_schedule(tmc, n, nice=False),
                                      jm.stage_schedule(jmc, n, False))
        for ba in (False, True):
            want = jm.lr_table(jmc, n, 5.0, False, ba)
            np.testing.assert_array_equal(
                tm.lr_table(tmc, n, 5.0, ba, nice=False), want)
    # StepLR(200, 0.8), not scaled by lr_factor
    tab = tm.lr_table(tmc, 450, 5.0, True, nice=False)
    np.testing.assert_allclose(tab[[0, 199, 200, 400], tm.LR_DECODERS],
                               [1e-3, 1e-3, 8e-4, 6.4e-4], rtol=1e-6)
    assert (tab[:, tm.LR_CAM] == tmc.ba_cam_lr).all()


def test_imap_mapping_call_matches(world, monkeypatch):
    """A BA mapping call of 2 iterations: color loss in every iteration, no
    bounding-box mask, the regulation over each frame's jitter.  The
    losses, the first iteration's gradients (both packages at the same
    parameters) and the poses and decoder after the call.  (Further Adam
    steps are not compared: a first Adam step moves each weight by +-lr
    whatever its gradient's size, so weights whose gradient is rounding
    noise take random-sign steps in either package.)"""
    cfg, intr = world['cfg'], world['intr']
    from nice_slam_tpu.engine.slam import mapper_config_from_cfg
    jmcfg = mapper_config_from_cfg(cfg)._replace(ba=True)
    tmcfg = tcfg_mod.mapper_config_from_cfg(cfg)._replace(ba=True)
    n_iters, n_frames, pix = 2, 3, 40
    s = world['jrcfg'].n_samples
    lr_tab = jm.lr_table(jmcfg, n_iters, 1.0, False, True)
    stage_idx = jm.stage_schedule(jmcfg, n_iters, False)
    colors = np.stack([f[1] for f in world['frames']])
    depths = np.stack([f[2] for f in world['frames']])
    c2ws = np.stack([f[3] for f in world['frames']])
    cams = tensor_from_c2w(jnp.asarray(c2ws[:, :3, :4]))
    cams = cams.at[1:, 4:].add(0.005)
    cam_mask = np.array([0.0, 1.0, 1.0], np.float32)
    key = jax.random.PRNGKey(21)
    step = jm.make_map_step(model=world['jmodel'], rcfg=world['jrcfg'],
                            mcfg=jmcfg, intr=intr, n_frames=n_frames,
                            n_iters=n_iters, pix_per_frame=pix)
    opt = {'cams': cams, 'grids': {}, 'dec': {'imap': world['params']}}
    jout, _, jlosses = step(opt, {}, None, jnp.asarray(lr_tab),
                            jnp.asarray(stage_idx), jnp.asarray(cam_mask),
                            jnp.asarray(colors), jnp.asarray(depths), key)
    _, (loss_fn,) = jm.build_stage_losses(
        model=world['jmodel'], rcfg=world['jrcfg'], mcfg=jmcfg, intr=intr,
        n_frames=n_frames, pix_per_frame=pix)
    _, jgrads = jax.value_and_grad(loss_fn)(
        opt, {}, jnp.asarray(colors), jnp.asarray(depths),
        jax.random.fold_in(key, 0))
    draws, jitter = [], []
    for it in range(n_iters):
        fkeys = jax.random.split(jax.random.fold_in(key, it), n_frames)
        ij = [js.sample_pixels(k, pix, 0, intr.H, 0, intr.W) for k in fkeys]
        draws.append((t_of(np.stack([a for a, _ in ij])),
                      t_of(np.stack([b for _, b in ij]))))
        jitter.append(t_of(np.stack([
            np.asarray(jax.random.uniform(jax.random.fold_in(k, 7), (pix, s)))
            for k in fkeys])))

    decs = _decoders(world)
    init = {k: v.clone() for k, v in decs['imap'].state_dict().items()}
    steps = []
    adam_step = tm.MaskedAdam.step

    def recording(self, grads, lrs, masks=None):
        steps.append([None if g is None else g.clone() for g in grads])
        return adam_step(self, grads, lrs, masks)

    monkeypatch.setattr(tm.MaskedAdam, 'step', recording)
    tcams, tlosses = tm.map_step(
        decs, {}, t_of(cams), trainable=['imap'], masks=None,
        cam_mask=t_of(cam_mask), lr_tab=lr_tab, stage_idx=stage_idx,
        colors=t_of(colors), depths=t_of(depths), model=world['tmodel'],
        rcfg=world['trcfg'], mcfg=tmcfg, intr=world['tintr'],
        pix_per_frame=pix, draws=draws, reg_jitter=jitter)

    np.testing.assert_allclose(np_of(tlosses), np_of(jlosses), rtol=1e-4)
    # the first iteration's gradients: [cams] + the decoder's parameters.
    # Each is a sum over rays and samples of terms of both signs, and the
    # L1 losses' |residual| flips sign for a residual within rounding of 0
    # (one ray's whole term): 5e-3 of the largest entry
    grads = steps[0]
    np.testing.assert_allclose(np_of(grads[0]), np_of(jgrads['cams']),
                               atol=5e-3 * float(np.abs(
                                   np_of(jgrads['cams'])).max()))
    jgrad = dict(decoders_from_numpy(
        {'imap': tree_np(jgrads['dec']['imap'])},
        world['tdcfg'])['imap'].named_parameters())
    for (k, want_g), g in zip(jgrad.items(), grads[1:]):
        want_g = np_of(want_g)
        scale = float(np.abs(want_g).max())
        assert scale > 0, k
        np.testing.assert_allclose(np_of(g), want_g, atol=5e-3 * scale,
                                   err_msg=k)
    # poses: BA lr 0.001 for 2 iterations -- agree to 10% of one step
    np.testing.assert_allclose(np_of(tcams), np_of(jout['cams']), atol=1e-4)
    assert float(np.abs(np_of(tcams) - np_of(cams)).max()) > 1e-4
    # decoder: lr 0.001 -- 99% of each tensor agrees to 20% of one step;
    # the rest are weights whose gradient is rounding noise, which Adam
    # steps by up to +-lr on its sign, so they stay within 2 lr a step
    want = decoders_from_numpy({'imap': tree_np(jout['dec']['imap'])},
                               world['tdcfg'])['imap'].state_dict()
    for k, a in decs['imap'].state_dict().items():
        diff = np.abs(np_of(a) - np_of(want[k]))
        assert (diff > 2e-4).mean() < 0.01, k
        assert diff.max() <= 2 * n_iters * 1e-3, k
    assert max(float((a - init[k]).abs().max())
               for k, a in decs['imap'].state_dict().items()) > 1e-3


def test_imap_tracking_frame_matches(world):
    """Six tracking iterations: no bounding-box prefilter, no volumes."""
    cfg, intr = world['cfg'], world['intr']
    from nice_slam_tpu.engine.slam import tracker_config_from_cfg
    jtcfg = tracker_config_from_cfg(cfg)._replace(iters=6)
    _, color, depth, gt = world['frames'][1]
    guess = gt.copy()
    guess[:3, 3] += np.array([0.01, -0.008, 0.006], np.float32)
    cam7 = tensor_from_c2w(jnp.asarray(guess[:3, :4]))
    key = jax.random.PRNGKey(13)
    track = jt.make_track_frame(model=world['jmodel'], rcfg=world['jrcfg'],
                                tcfg=jtcfg, intr=intr)
    jbest, jlast, jlosses = track(world['params'], None, jnp.asarray(color),
                                  jnp.asarray(depth), cam7, key)
    draws = []
    for it in range(jtcfg.iters):
        i, j = js.sample_pixels(
            jax.random.fold_in(key, it), jtcfg.pixels, jtcfg.ignore_edge_h,
            intr.H - jtcfg.ignore_edge_h, jtcfg.ignore_edge_w,
            intr.W - jtcfg.ignore_edge_w)
        draws.append((t_of(i), t_of(j)))
    ttcfg = tcfg_mod.tracker_config_from_cfg(cfg)._replace(iters=6)
    tbest, tlast, tlosses = tt.track_frame(
        _decoders(world), {}, t_of(color), t_of(depth), t_of(cam7),
        model=world['tmodel'], rcfg=world['trcfg'], tcfg=ttcfg,
        intr=world['tintr'], draws=draws)
    np.testing.assert_allclose(np_of(tlosses), np_of(jlosses), rtol=1e-4)
    # the pose moves lr=0.002 per step; agree to 2% of one step
    np.testing.assert_allclose(np_of(tlast), np_of(jlast), atol=4e-5)
    np.testing.assert_allclose(np_of(tbest), np_of(jbest), atol=4e-5)
    assert float(np.abs(np_of(tlast) - np_of(cam7)).max()) > 1e-3
