"""The port's measurement entry points against the JAX scripts they port:
nice_slam_tpu_torch/bench.py (the root bench.py), tools/bench_budget.py,
tools/bench_imap.py and tools/bench_sync_modes.py (scripts/bench_*.py).

(a) bench.py's workload equals the one the root bench.py builds from the
    JAX package's functions and constants (grid shapes, intrinsics, the
    budgets, the learning-rate table and stage schedule, cam_mask, the
    frame's bytes, the camera); bench_imap's frames and budgets likewise.
(b) bench_budget's budget line equals the JAX script's, computed from the
    JAX package's config views, for the four named scenes.
(c) At 60x80 the bench's tracked frame and a 6-iteration mapping call
    against the JAX programs on the same draws, with the JAX package's
    initial grids and decoders carried across (models/convert.py): the
    tolerances of tests/test_torch_engine.py (tracking losses rtol 1e-4,
    poses 4e-5; mapping losses rtol 2e-4, poses 2e-5).
(d) Each entry point end to end on the CPU at a tiny size (keyword sizes
    of its main(), or a tiny config for bench_budget): its last line
    carries the JAX script's keys.
(e) Without CUDA and without a CPU request each entry point raises, this
    file's and those of tests/test_torch_measure_scripts.py.
About 80 s in one process, 43 s of it the JAX tracked frame run op by op.
"""

import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from nice_slam_tpu.core.cameras import Intrinsics as JIntrinsics
from nice_slam_tpu.core.sampling import sample_pixels
from nice_slam_tpu.engine import mapper as jm
from nice_slam_tpu.engine import tracker as jt
from nice_slam_tpu.models.decoders import DecoderConfig as JDecoderConfig
from nice_slam_tpu.models.decoders import init_nice_decoders
from nice_slam_tpu.models.grids import (
    GridConfig as JGridConfig, init_grids, prepare_grids, round_bound,
    static_grid_shapes)
from nice_slam_tpu.render.renderer import RenderConfig as JRenderConfig
from nice_slam_tpu.render.renderer import SceneModel
from nice_slam_tpu_torch import bench
from nice_slam_tpu_torch.models.convert import (
    decoders_from_numpy, grids_from_numpy)
from nice_slam_tpu_torch.tools import bench_budget, bench_imap
from nice_slam_tpu_torch.tools import bench_sync_modes
from nice_slam_tpu_torch.tools._small_config import small_config
from tests.test_torch_util import np_of, t_of, tree_np

torch.set_num_threads(2)

ROOM0 = [[-1.3, 7.4], [-3.1, 3.2], [-1.7, 2.3]]
JAX_STAGE_LR = tuple((s, (0.005, 0.001, 0.1, 0.005, 0.005))
                     for s in ('coarse', 'middle', 'fine', 'color'))

# the keys of the JAX scripts' result lines
BENCH_KEYS = {'metric', 'value', 'unit', 'vs_baseline', 'baseline_provenance',
              'tracking_only_fps', 'track_ms_per_frame', 'map_iters_per_s',
              'map_device_util', 'dispatch_ms', 'expand_gbps',
              'expand_hbm_frac', 'device'}
BUDGET_KEYS = {'metric', 'value', 'track_s_per_frame', 'map_s_per_call',
               'map_iters_per_s', 'every_frame', 'scene_config'}
SYNC_KEYS = {'mode', 'wall_s', 'fps_incl_compiles', 'max_terr_m',
             'mean_terr_m', 'ate_rmse_m', 'track_s', 'map_s', 'coarse_map_s',
             'mesh_s', 'frames_tracked', 'frames_mapped', 'map_iters',
             'tracked_fps', 'map_iters_per_s'}


def _common(a, b) -> None:
    """Two NamedTuple configs agree on every field they share."""
    a, b = a._asdict(), b._asdict()
    shared = set(a) & set(b)
    assert shared
    for k in shared:
        assert a[k] == b[k], k


def _jax_bench(h: int, w: int, n_iters: int = 60):
    """The root bench.py's workload (bench.py:53-140) at an h x w frame
    with fx = fy = w / 2 and the centre (its own at 680x1200)."""
    gcfg = JGridConfig(bound=round_bound(ROOM0, 0.32))
    dcfg = JDecoderConfig()
    model = SceneModel(kind='nice', decoder=dcfg,
                       bound=jnp.asarray(gcfg.bound_np),
                       coarse_bound=jnp.asarray(gcfg.coarse_bound_np),
                       grid_shapes=static_grid_shapes(gcfg))
    intr = JIntrinsics(H=h, W=w, fx=w / 2, fy=w / 2, cx=(w - 1) / 2,
                       cy=(h - 1) / 2)
    rng = np.random.default_rng(0)
    color = rng.random((h, w, 3), dtype=np.float32)
    depth = 1.0 + 2.0 * rng.random((h, w), dtype=np.float32)
    mcfg = jm.MapperConfig(pixels=1000, iters=n_iters, fix_fine=True,
                           stage_lr=JAX_STAGE_LR)
    return dict(gcfg=gcfg, dcfg=dcfg, model=model, intr=intr,
                rcfg=JRenderConfig(n_samples=32, n_surface=16),
                tcfg=jt.TrackerConfig(pixels=200, iters=10), mcfg=mcfg,
                color=color, depth=depth,
                cam7=np.asarray([1.0, 0, 0, 0, 2.0, 0.0, 0.5], np.float32),
                lr_tab=jm.lr_table(mcfg, n_iters, 1.0, True, True),
                stage_idx=jm.stage_schedule(mcfg, n_iters, True),
                cam_mask=np.asarray([0.0] + [1.0] * 4, np.float32))


def test_bench_workload_is_the_jax_scripts():
    j = _jax_bench(680, 1200)
    wl = bench.workload(torch.device('cpu'))
    assert j['intr'] == JIntrinsics(H=680, W=1200, fx=600.0, fy=600.0,
                                    cx=599.5, cy=339.5)
    assert tuple(wl.intr) == tuple(j['intr'])
    assert wl.model.grid_shapes == j['model'].grid_shapes
    assert dict(wl.model.grid_shapes) == {
        'coarse': (8, 6, 4), 'middle': (28, 20, 13), 'fine': (56, 40, 26),
        'color': (56, 40, 26)}
    np.testing.assert_array_equal(np_of(wl.model.bound),
                                  j['gcfg'].bound_np)
    np.testing.assert_array_equal(np_of(wl.model.coarse_bound),
                                  j['gcfg'].coarse_bound_np)
    _common(wl.model.decoder, j['dcfg'])
    _common(wl.rcfg, j['rcfg'])
    _common(wl.tcfg, j['tcfg'])
    _common(wl.mcfg, j['mcfg'])
    np.testing.assert_array_equal(wl.lr_tab, j['lr_tab'])
    np.testing.assert_array_equal(wl.stage_idx, j['stage_idx'])
    np.testing.assert_array_equal(np_of(wl.cam_mask), j['cam_mask'])
    np.testing.assert_array_equal(np_of(wl.cam7), j['cam7'])
    assert np_of(wl.color).tobytes() == j['color'].tobytes()
    assert np_of(wl.depth).tobytes() == j['depth'].tobytes()
    assert {k: tuple(g.shape) for k, g in wl.grids.items()} == {
        k: tuple(g.shape) for k, g in init_grids(
            jax.random.PRNGKey(0), j['gcfg']).items()}


def test_bench_imap_inputs_are_the_jax_scripts():
    """bench_imap.py:21-24, 47-88, 124-128 at a 68x120 frame."""
    h, w = 68, 120
    rng = np.random.default_rng(0)
    colors = jnp.asarray(rng.random((5, h, w, 3)), dtype=jnp.float32)
    depths = jnp.asarray(1.0 + rng.random((5, h, w)) * 2.0,
                         dtype=jnp.float32) * 0.1
    tc, td = bench_imap.frames(h, w)
    assert tc.tobytes() == np.asarray(colors).tobytes()
    assert td.tobytes() == np.asarray(depths).tobytes()
    assert (bench_imap.N_FRAMES, bench_imap.MAP_PIXELS,
            bench_imap.TRACK_ITERS) == (5, 5000, 50)
    jmc = jm.MapperConfig(pixels=5000, iters=100, ba=True, window_size=5,
                          keyframe_selection='global', w_color_loss=0.1,
                          max_rays_per_pass=4096)
    from nice_slam_tpu_torch.engine import mapper as tm
    tmc = tm.MapperConfig(pixels=5000, iters=100, ba=True, window_size=5,
                          keyframe_selection='global', w_color_loss=0.1,
                          max_rays_per_pass=bench_imap.MAX_RAYS_PER_PASS)
    _common(tmc, jmc)
    np.testing.assert_array_equal(
        tm.lr_table(tmc, 100, 1.0, True, nice=False),
        jm.lr_table(jmc, 100, 1.0, nice=False, ba_active=True))


@pytest.mark.parametrize('scene', ['replica', 'scannet', 'tum', 'apartment'])
def test_bench_budget_line_is_the_jax_scripts(scene):
    """bench_budget.py:44-78 through the JAX package's config views."""
    import os

    from nice_slam_tpu.engine.slam import (
        mapper_config_from_cfg, tracker_config_from_cfg)
    from nice_slam_tpu.utils import config as cfgutil
    path = bench_budget.SCENES[scene]
    repo = bench_budget.REPO
    cfg = cfgutil.load_config(os.path.join(repo, path),
                              os.path.join(repo, 'configs/nice_slam.yaml'))
    intr = cfgutil.intrinsics_from_cfg(cfg)
    tcfg, mcfg = tracker_config_from_cfg(cfg), mapper_config_from_cfg(cfg)
    want = {'scene': path, 'cam': [intr.H, intr.W],
            'grid_shapes': {k: list(v) for k, v in static_grid_shapes(
                cfgutil.grid_config_from_cfg(cfg))},
            'track': [tcfg.pixels, tcfg.iters],
            'map': [mcfg.pixels, mcfg.iters, mcfg.window_size,
                    int(cfg['mapping']['every_frame'])]}
    got = bench_budget.budget_line(*bench_budget.load(scene))
    assert json.dumps(got) == json.dumps(want)


@pytest.fixture(scope='module')
def small_bench():
    """The bench at 60x80 in both packages, the JAX package's initial
    grids and decoders (PRNGKey(0), as bench.py draws them) carried into
    the port's workload."""
    j = _jax_bench(60, 80, n_iters=6)
    kg, kd, key = jax.random.split(jax.random.PRNGKey(0), 3)
    grids, params = init_grids(kg, j['gcfg']), init_nice_decoders(kd,
                                                                  j['dcfg'])
    wl = bench.workload(torch.device('cpu'), h=60, w=80, map_iters=6)
    wl = wl._replace(
        grids=grids_from_numpy(tree_np(grids)),
        decoders=decoders_from_numpy(tree_np(params), wl.model.decoder))
    return dict(j=j, grids=grids, params=params, key=key, wl=wl)


def test_bench_tracked_frame_matches_jax(small_bench):
    """The JAX program runs op by op (disable_jit): compiled, XLA sums in
    another order, and on this workload that moves one pixel across the
    dynamic-pixel rejection's threshold (10x the median residual) at the
    first iteration, 0.27% of the loss (16,507,080 compiled against
    16,462,578 op by op, JAX's own tracking_loss at the same draws): the
    random decoders saturate every ray's first sample, the depth variance
    sits at the 1e-10 floor, and one pixel's residual is ~1e5.  Op by op
    the JAX function gives the port's numbers."""
    j, wl, key = small_bench['j'], small_bench['wl'], small_bench['key']
    intr, tcfg = j['intr'], j['tcfg']
    tg = jax.jit(lambda g: prepare_grids(g, j['model'].grid_shapes,
                                         stage='color'))(small_bench['grids'])
    fn = jt.make_track_frame(model=j['model'], rcfg=j['rcfg'], tcfg=tcfg,
                             intr=intr)
    with jax.disable_jit():
        jbest, jlast, jlosses = fn(small_bench['params'], tg,
                                   jnp.asarray(j['color']),
                                   jnp.asarray(j['depth']),
                                   jnp.asarray(j['cam7']), key)
    draws = []
    for it in range(tcfg.iters):
        i, jj = sample_pixels(jax.random.fold_in(key, it), tcfg.pixels,
                              tcfg.ignore_edge_h, intr.H - tcfg.ignore_edge_h,
                              tcfg.ignore_edge_w, intr.W - tcfg.ignore_edge_w)
        draws.append((t_of(i), t_of(jj)))
    tbest, tlast, tlosses = bench.run_track(wl, bench.track_grids(wl),
                                            draws=draws)
    np.testing.assert_allclose(np_of(tlosses), np_of(jlosses), rtol=1e-4)
    np.testing.assert_allclose(np_of(tlast), np_of(jlast), atol=4e-5)
    np.testing.assert_allclose(np_of(tbest), np_of(jbest), atol=4e-5)
    assert float(np.abs(np_of(tlast) - j['cam7']).max()) > 1e-3


def test_bench_mapping_call_matches_jax(small_bench):
    j, wl, key = small_bench['j'], small_bench['wl'], small_bench['key']
    intr, n_win, n_iters = j['intr'], 5, 6
    params = small_bench['params']
    step = jm.make_map_step(model=j['model'], rcfg=j['rcfg'], mcfg=j['mcfg'],
                            intr=intr, n_frames=n_win, n_iters=n_iters,
                            pix_per_frame=1000 // n_win)
    cam7 = jnp.asarray(j['cam7'])
    opt = {'cams': jnp.tile(cam7, (n_win, 1)), 'grids': small_bench['grids'],
           'dec': {'color': params['color']}}
    frozen = {k: v for k, v in params.items() if k != 'color'}
    jout, _, jlosses = step(
        opt, frozen, None, jnp.asarray(j['lr_tab']),
        jnp.asarray(j['stage_idx']), jnp.asarray(j['cam_mask']),
        jnp.tile(jnp.asarray(j['color'])[None], (n_win, 1, 1, 1)),
        jnp.tile(jnp.asarray(j['depth'])[None], (n_win, 1, 1)), key)
    draws = []
    for it in range(n_iters):
        fkeys = jax.random.split(jax.random.fold_in(key, it), n_win)
        ij = [sample_pixels(k, 1000 // n_win, 0, intr.H, 0, intr.W)
              for k in fkeys]
        draws.append((t_of(np.stack([a for a, _ in ij])),
                      t_of(np.stack([b for _, b in ij]))))
    assert set(wl.stage_idx.tolist()) == {1, 2, 3}
    tcams, tlosses = bench.run_map(wl, bench.map_state(wl), draws=draws)
    np.testing.assert_allclose(np_of(tlosses), np_of(jlosses), rtol=2e-4)
    np.testing.assert_allclose(np_of(tcams), np_of(jout['cams']), atol=2e-5)
    # the call starts from a copy: the workload's state is untouched
    for name, g in wl.grids.items():
        np.testing.assert_array_equal(np_of(g), np.asarray(
            small_bench['grids'][name]))


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def _finite(row: dict, keys) -> None:
    for k in keys:
        assert isinstance(row[k], (int, float)) and math.isfinite(row[k]), k


def test_bench_end_to_end_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(bench, 'main', functools.partial(
        bench.main, h=60, w=80, track_frames=1, map_iters=2, map_calls=1,
        expand_reps=1))
    bench.cli(['--device', 'cpu'])
    row = _last_json(capsys.readouterr().out)
    assert set(row) == BENCH_KEYS | {'launches'}
    assert row['metric'] == 'replica_tracked_fps' and row['device'] == 'cpu'
    _finite(row, ('value', 'vs_baseline', 'tracking_only_fps',
                  'track_ms_per_frame', 'map_iters_per_s', 'dispatch_ms',
                  'expand_gbps'))
    # device-only figures are not measured on the CPU
    assert row['map_device_util'] is None and row['expand_hbm_frac'] is None
    assert row['value'] == pytest.approx(1.0 / (
        row['track_ms_per_frame'] * 1e-3 + 2 / row['map_iters_per_s'] / 5))
    # the wrappers run their plain versions on CPU tensors: no launch
    assert set(row['launches']) >= {'expand_corners', 'fold_corners',
                                    'gather_rows', 'scatter_add_rows'}
    assert not any(row['launches'].values())


def test_bench_budget_end_to_end_on_cpu(tmp_path, capsys):
    cfg = small_config()
    cfg['tracking'].update(iters=2, pixels=100)
    cfg['mapping'].update(iters=3, pixels=120, mapping_window_size=2)
    path = tmp_path / 'tiny.yaml'
    path.write_text(yaml.safe_dump(cfg))
    bench_budget.cli([str(path), '--device', 'cpu'])
    out = capsys.readouterr()
    line = json.loads(out.err.strip().splitlines()[-1])
    assert line['cam'] == [60, 80] and line['map'] == [120, 3, 2, 4]
    row = _last_json(out.out)
    assert set(row) == BUDGET_KEYS | {'device', 'launches'}
    _finite(row, ('value', 'track_s_per_frame', 'map_s_per_call',
                  'map_iters_per_s'))
    assert row['value'] == pytest.approx(
        row['track_s_per_frame'] + row['map_s_per_call'] / 4)


def test_bench_imap_end_to_end_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(bench_imap, 'main', functools.partial(
        bench_imap.main, h=60, w=80, pixels=250, track_iters=2))
    bench_imap.cli(['2', '--device', 'cpu'])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-3].startswith('iMAP mapping: 2 iters in ')
    assert lines[-2].startswith('iMAP tracking: 2 iters x 250 px in ')
    row = json.loads(lines[-1])
    _finite(row, ('map_s_per_call', 'map_iters_per_s', 'track_s_per_frame'))
    assert f'{row["map_s_per_call"]:.3f} s' in lines[-3]
    assert f'{row["track_s_per_frame"]:.3f} s/frame' in lines[-2]
    assert not any(row['launches'].values())


def test_bench_sync_modes_end_to_end_on_cpu(monkeypatch, capsys):
    import warnings
    monkeypatch.setattr(bench_sync_modes, 'main', functools.partial(
        bench_sync_modes.main, h=60, w=80, update={
            'mapping': {'iters_first': 10, 'iters': 4, 'pixels': 200},
            'tracking': {'iters': 3}, 'meshing': {'resolution': 32}}))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        bench_sync_modes.cli(['3', 'strict', 'free', '--device', 'cpu'])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith('{')
    rows = [json.loads(ln) for ln in lines if ln.startswith('{')]
    # free stays free: the script forces it, and no fallback is warned
    assert [r['mode'] for r in rows] == ['strict', 'free']
    assert not any("'free'" in str(w.message) for w in caught)
    for r in rows:
        assert set(r) >= SYNC_KEYS | {'device', 'launches'}
        _finite(r, ('wall_s', 'fps_incl_compiles', 'max_terr_m',
                    'ate_rmse_m'))
        assert r['frames_tracked'] == 3 and r['frames_mapped'] == 2


@pytest.mark.parametrize('entry', ['bench', 'bench_budget', 'bench_imap',
                                   'bench_sync_modes', 'bench_demo',
                                   'bench_imap_e2e', 'bench_fused_eval',
                                   'profile_steps', 'profile_components',
                                   'ablate_track_step', 'ablate_map_step',
                                   'diagnose_strict'])
def test_entry_points_need_cuda_unless_asked_for_the_cpu(entry, monkeypatch):
    import importlib
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    run = {'bench': lambda: bench.main(),
           'bench_budget': lambda: bench_budget.main('replica'),
           'bench_imap': lambda: bench_imap.main(),
           'bench_sync_modes': lambda: bench_sync_modes.main(3)}.get(
        entry, lambda: importlib.import_module(
            f'nice_slam_tpu_torch.tools.{entry}').main())
    with pytest.raises(RuntimeError, match='no CUDA device'):
        run()


def test_busy_share_is_the_union_of_the_device_intervals():
    from nice_slam_tpu_torch.utils import measure
    spans = [(20.0, 25.0), (0.0, 10.0), (5.0, 15.0), (15.0, 16.0)]
    assert measure.busy_share(spans, 50.0) == (21.0 / 50.0, 4)
    assert measure.busy_share([], 50.0) == (0.0, 0)
    assert measure.busy_share_of(lambda: 1 / 0, torch.device('cpu')) is None
