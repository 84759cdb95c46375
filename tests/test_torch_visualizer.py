"""The port's render panels (nice_slam_tpu_torch/utils/visualizer.py,
utils/draw.py) against the JAX package's (nice_slam_tpu/utils/visualizer.py)
and matplotlib, which the JAX package draws with.

* `draw.PLASMA` is matplotlib's plasma table, and `draw.colormap` gives
  matplotlib's bytes exactly;
* the six tiles equal the JAX package's render_image plus its residual
  rule on the same model (carried across by models/convert.py), NICE and
  iMAP*, within tests/test_torch_render_image.py's 1e-4 (iMAP* with
  importance samples within tests/test_torch_imap.py's 1e-3 for them);
* a 5-frame run writes the panels the JAX SlamSystem writes on the same
  config (file names), each decodable at the layout's size, and its poses
  are bit-equal to the run with `enable_vis: false`.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nice_slam_tpu.core.cameras import Intrinsics as JIntrinsics
from nice_slam_tpu.render import renderer as jr
from nice_slam_tpu_torch.core.cameras import Intrinsics
from nice_slam_tpu_torch.render import renderer as tr
from nice_slam_tpu_torch.utils import draw
from nice_slam_tpu_torch.utils import visualizer as tv
from tests.test_torch_util import jax_nice_setup, tree_np
from tests.util import make_test_cfg

matplotlib = pytest.importorskip('matplotlib')

torch.set_num_threads(2)

H, W = 24, 32


def test_plasma_table_is_matplotlibs():
    assert draw.PLASMA.shape == (256, 3)
    np.testing.assert_array_equal(
        draw.PLASMA, np.asarray(matplotlib.colormaps['plasma'].colors))


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('vmax', [3.2, 1.0, 7.123456])
def test_colormap_bytes_equal_matplotlib(vmax, dtype):
    """Below 0, at 0, inside, exactly vmax, above and NaN."""
    from matplotlib.colors import Normalize
    x = (np.random.default_rng(0).random((40, 50)) * 1.3 * vmax
         - 0.1 * vmax).astype(dtype)
    x[0, :4] = [np.nan, 0.0, vmax, -1.0]
    want = matplotlib.colormaps['plasma'](Normalize(0, vmax)(x),
                                          bytes=True)[..., :3]
    np.testing.assert_array_equal(draw.colormap(x, 0, vmax), want)


def _frame(seed=1):
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.1, -0.05, 0.2]
    ang = 0.3
    c2w[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                   [-np.sin(ang), 0, np.cos(ang)]]
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.4, 1.2, (H, W)).astype(np.float32)
    depth[::7, ::5] = 0.0
    color = rng.random((H, W, 3)).astype(np.float32)
    return c2w, depth, color


def _jax_tiles(params, grids, c2w, depth, color, jmodel, jrcfg):
    """The JAX Visualizer's numbers (nice_slam_tpu/utils/visualizer.py)."""
    intr = JIntrinsics(H, W, 0.5 * W, 0.5 * W, W / 2 - 0.5, H / 2 - 0.5)
    d, _, c = jr.render_image(params, grids, jnp.asarray(c2w), intr,
                              stage='color', model=jmodel, rcfg=jrcfg,
                              gt_depth=jnp.asarray(depth))
    d = np.asarray(d)
    c = np.clip(np.asarray(c), 0, 1)
    d_res = np.abs(depth - d)
    d_res[depth == 0.0] = 0.0
    c_res = np.abs(color - c)
    c_res[depth == 0.0] = 0.0
    return [depth, d, d_res, color, c, np.clip(c_res, 0, 1)], \
        float(np.max(depth)) or 1.0


def _imap_setup():
    from nice_slam_tpu.models import decoders as jd
    from nice_slam_tpu_torch.models import decoders as td
    from nice_slam_tpu_torch.models.convert import decoders_from_numpy
    bound = np.asarray([[-1.0, 1.0], [-0.8, 0.8], [-1.0, 1.0]], np.float32)
    params = jd.init_imap_decoder(
        jax.random.PRNGKey(5), jd.DecoderConfig(imap_hidden=64,
                                                imap_blocks=3))
    tdcfg = td.DecoderConfig(imap_hidden=64, imap_blocks=3)
    jmodel = jr.SceneModel(kind='imap', decoder=jd.DecoderConfig(
        imap_hidden=64, imap_blocks=3), bound=jnp.asarray(bound))
    tmodel = tr.SceneModel(decoder=tdcfg, bound=torch.tensor(bound),
                           kind='imap')
    decs = decoders_from_numpy({'imap': tree_np(params)}, tdcfg)
    return jmodel, params, None, tmodel, decs, {}


@pytest.mark.parametrize('kind, n_importance, atol', [
    ('nice', 0, 1e-4), ('imap', 0, 1e-4),
    # with importance samples the last one (u = 1) may sit at either end
    # of its interval by the rounding of the cdf's total, which moves a
    # ray's color by up to ~1e-3 (tests/test_torch_imap.py
    # test_render_rays_with_importance_matches)
    ('imap', 4, 1e-3)])
def test_panel_tiles_match_jax(kind, n_importance, atol):
    if kind == 'nice':
        jmodel, params, grids, tmodel, decs, tgrids = jax_nice_setup(0)
        jrcfg = jr.RenderConfig(n_samples=16, n_surface=8, ray_chunk=500)
        trcfg = tr.RenderConfig(n_samples=16, n_surface=8, ray_chunk=500)
    else:
        jmodel, params, grids, tmodel, decs, tgrids = _imap_setup()
        kw = dict(n_samples=16, n_surface=8, n_importance=n_importance,
                  occupancy=False, ray_chunk=500)
        jrcfg, trcfg = jr.RenderConfig(**kw), tr.RenderConfig(**kw)
    c2w, depth, color = _frame()
    want, want_vmax = _jax_tiles(params, grids, c2w, depth, color, jmodel,
                                 jrcfg)
    # the Visualizer's model (the fused decoders for NICE)
    vis_model = tmodel._replace(fused_eval=True) if kind == 'nice' \
        else tmodel
    got, vmax = tv.panel_tiles(
        decs, tgrids, c2w, depth, color, model=vis_model, rcfg=trcfg,
        intr=Intrinsics(H, W, 0.5 * W, 0.5 * W, W / 2 - 0.5, H / 2 - 0.5))
    assert vmax == want_vmax
    for name, a, b in zip(tv.TITLES, got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=atol, rtol=1e-4, err_msg=name)
    # the drawn panel: the layout's size, the tiles' bytes in place
    panel = tv.draw_panel(got, vmax)
    assert panel.shape[:2] == tv.panel_size(H, W)
    strip = panel.shape[0] - 2 * H - 3 * draw.GAP
    assert strip % 2 == 0
    y0, x0 = draw.GAP + strip // 2, draw.GAP
    np.testing.assert_array_equal(panel[y0:y0 + H, x0:x0 + W],
                                  draw.colormap(depth, 0, vmax))


def _run_cfg(n_frames=5):
    cfg = make_test_cfg(n_frames=n_frames, coarse=False, h=30, w=40)
    cfg['mapping'].update(iters_first=30, iters=20, vis_freq=2,
                          vis_inside_freq=10)
    cfg['tracking'].update(iters=5, vis_freq=2)
    cfg['debug']['check_invariants'] = False
    return cfg


@pytest.fixture(scope='module')
def port_runs(tmp_path_factory):
    """The port on _run_cfg with panels, and with enable_vis: false."""
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    runs = {}
    for vis in (True, False):
        cfg = _run_cfg()
        cfg['enable_vis'] = vis
        out = str(tmp_path_factory.mktemp(f'vis{int(vis)}'))
        slam = SlamSystem(cfg, device='cpu', seed=4, output=out)
        slam.run()
        runs[vis] = (slam, out)
    return runs


def _panels(out):
    return {d: sorted(os.listdir(os.path.join(out, d)))
            for d in ('tracking_vis', 'mapping_vis')}


def test_panel_names_match_the_jax_run(port_runs, tmp_path):
    from nice_slam_tpu.engine.slam import SlamSystem as JaxSlam
    slam, out = port_runs[True]
    jout = str(tmp_path / 'jax')
    JaxSlam(_run_cfg(), nice=True, output=jout).run()
    got = _panels(out)
    assert got == _panels(jout)
    # tracking every 2nd frame past 0; mapping on frame 4 (the mapped
    # multiple of 2 past 0) at iterations 0 and 10, the post-mapping panel
    # sharing 0000
    assert got == {'tracking_vis': ['00002_0000.jpg', '00004_0000.jpg'],
                   'mapping_vis': ['00004_0000.jpg', '00004_0010.jpg']}


def test_panels_decode_at_the_layout_size(port_runs):
    from nice_slam_tpu_torch.io.codecs import read_color
    slam, out = port_runs[True]
    for d, names in _panels(out).items():
        for name in names:
            img = read_color(os.path.join(out, d, name))
            assert img.shape[:2] == tv.panel_size(slam.intr.H,
                                                  slam.intr.W), name
    assert slam._last_panel == os.path.join(out, 'mapping_vis',
                                            '00004_0000.jpg')


def test_panels_leave_the_poses_bit_equal(port_runs):
    (a, _), (b, out_b) = port_runs[True], port_runs[False]
    np.testing.assert_array_equal(a.estimate_c2w, b.estimate_c2w)
    for name, g in a.grids.items():
        assert torch.equal(g, b.grids[name]), name
    assert _panels(out_b) == {'tracking_vis': [], 'mapping_vis': []}


def test_demo_output_writes_tracking_panels_only(tmp_path):
    """An output path containing 'Demo': tracking panels in vis/, no
    mapping panels (the JAX package's rule)."""
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    out = tmp_path / 'Demo'
    slam = SlamSystem(make_test_cfg(n_frames=2), device='cpu',
                      output=str(out))
    assert slam.map_vis is None
    assert slam.track_vis.vis_dir == str(out / 'vis')
    assert sorted(os.listdir(out)) == ['ckpts', 'mesh', 'vis']


def test_replay_tool_writes_a_frame_per_stride(port_runs, tmp_path,
                                               monkeypatch):
    """tools/visualizer.py on the run's output: one row of tiles (the
    checkpoint's rendered color, the final mesh's depth, the trajectory)
    per replayed pose, each REPLAY_W pixels wide (320; 64 here, for the
    CPU's renders)."""
    import yaml

    from nice_slam_tpu_torch.io.codecs import read_color
    from nice_slam_tpu_torch.tools import visualizer as replay_tool
    monkeypatch.setattr(replay_tool, 'REPLAY_W', 64)
    _, out = port_runs[True]
    cfg_path = tmp_path / 'run.yaml'
    cfg_path.write_text(yaml.safe_dump(_run_cfg()))
    replay_tool.main([str(cfg_path), '--output', out, '--stride', '2',
                      '--device', 'cpu'])
    names = sorted(os.listdir(os.path.join(out, 'replay')))
    assert names == ['00000.jpg', '00001.jpg', '00002.jpg']   # frames 0-4
    h = 30 * 64 // 40
    img = read_color(os.path.join(out, 'replay', names[-1]))
    assert img.shape[:2] == draw.grid_size([(h, 64)] * 3, 3)
    # without the volume renders: two tiles
    replay_tool.main([str(cfg_path), '--output', out, '--stride', '4',
                      '--no-rgb', '--device', 'cpu'])
    img = read_color(os.path.join(out, 'replay', '00000.jpg'))
    assert img.shape[:2] == draw.grid_size([(h, 64)] * 2, 2)


def test_eval_ate_plot_is_drawn_without_matplotlib(port_runs, tmp_path):
    import sys

    import yaml

    from nice_slam_tpu_torch.io.codecs import read_color
    from nice_slam_tpu_torch.tools import eval_ate
    _, out = port_runs[True]
    cfg_path = tmp_path / 'run.yaml'
    cfg_path.write_text(yaml.safe_dump(_run_cfg()))
    before = set(sys.modules)
    eval_ate.main([str(cfg_path), '--output', out, '--plot'])
    assert not any(m.startswith('matplotlib.pyplot')
                   for m in set(sys.modules) - before)
    img = read_color(os.path.join(out, 'eval_ate_plot.png'))
    assert img.shape[1] > 600


def test_panels_under_loose_render_on_the_mapping_thread(tmp_path):
    """Under `loose` (mapping every every_frame // 2 = 2 frames, the rounds
    on the mapping thread) the panels follow the same rule: tracking
    panels from the adopted snapshot, mapping panels (iterations 0 and 10
    of frames 2 and 4) rendered by the mapping thread."""
    import threading

    from nice_slam_tpu_torch.engine.slam import SlamSystem
    from nice_slam_tpu_torch.utils import visualizer
    cfg = _run_cfg()
    cfg['sync_method'] = 'loose'
    threads = set()
    vis = visualizer.Visualizer.vis

    def recording(self, idx, iter_i, *args):
        threads.add((os.path.basename(self.vis_dir),
                     threading.current_thread().name.startswith('mapping')))
        return vis(self, idx, iter_i, *args)

    visualizer.Visualizer.vis = recording
    try:
        SlamSystem(cfg, device='cpu', seed=4, output=str(tmp_path)).run()
    finally:
        visualizer.Visualizer.vis = vis
    assert _panels(str(tmp_path)) == {
        'tracking_vis': ['00002_0000.jpg', '00004_0000.jpg'],
        'mapping_vis': ['00002_0000.jpg', '00002_0010.jpg',
                        '00004_0000.jpg', '00004_0010.jpg']}
    assert ('tracking_vis', False) in threads
    assert ('mapping_vis', True) in threads
