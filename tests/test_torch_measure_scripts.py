"""The port's last measurement entry points against the JAX scripts they
port: tools/bench_demo.py, bench_imap_e2e.py, bench_fused_eval.py,
profile_steps.py, profile_components.py, ablate_track_step.py,
ablate_map_step.py, diagnose_strict.py and bench_precision.py
(scripts/*.py).

(a) Configs: each JAX script's `main` runs with the JAX `SlamSystem`
    replaced by a stub that records its config and stops; the port's
    config function gives the same dictionary (bench_imap_e2e's with its
    bfloat16 decoder products; diagnose_strict's at
    `bench_sync_modes.mode_config`, which adds `sync_force_free`);
    bench_precision's orbit config, and the iMAP* call's decoder,
    renderer, mapper, camera, bound and sizes as the JAX `time_imap`
    hands them to `make_map_step`, at each of its precisions.
(b) Output keys: a stub that carries poses and JAX `PhaseTimers` lets the
    JAX script print its JSON; the port's JSON from a tiny CPU run carries
    the same keys plus `device`, `launches` and `peak_mem_gb`.
(c) The lattice query at 16^3 against the JAX `eval_raw` on the same
    points, the JAX tiny setup's decoders and volumes carried across:
    within 1e-5 x max(1, max|JAX| inside the bound), fused and plain.
(d) Ablations: each `full` case's losses equal `bench.run_track` /
    `bench.run_map`'s on the same draws to the bit; the cases change only
    what they take away (no_grid_grad the volumes, no_cam_grad the
    cameras, fwd_only nothing); the no_sort and frozen_expand contexts
    leave the production calls' bits as they were, also after an error.
(e) profile_steps, profile_components, the two ablations and
    diagnose_strict end to end on the CPU at tiny sizes: every row
    printed, every number finite.
(f) Importing the nine entry points imports neither JAX nor the JAX
    package.
About 60 s in one process.
"""

import functools
import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nice_slam_tpu_torch import bench
from nice_slam_tpu_torch.engine import mapper as M
from nice_slam_tpu_torch.models import grids as G
from nice_slam_tpu_torch.models.convert import (
    decoders_from_numpy, grids_from_numpy)
from nice_slam_tpu_torch.render import renderer as R
from nice_slam_tpu_torch.tools import (
    ablate_map_step, ablate_track_step, bench_demo, bench_fused_eval,
    bench_imap_e2e, bench_precision, bench_sync_modes, diagnose_strict,
    profile_components, profile_steps)
from tests.test_torch_util import np_of, tree_np

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device('cpu')
REAL_SORT = torch.sort
ENTRY_POINTS = ('bench_demo', 'bench_imap_e2e', 'bench_fused_eval',
                'profile_steps', 'profile_components', 'ablate_track_step',
                'ablate_map_step', 'diagnose_strict', 'bench_precision')
# tiny budgets of the end-to-end runs
TINY = {'mapping': {'iters_first': 10, 'iters': 3, 'pixels': 200},
        'tracking': {'iters': 3, 'pixels': 100},
        'meshing': {'resolution': 32}}


def _jax_script(name: str):
    """scripts/NAME.py as a module."""
    spec = importlib.util.spec_from_file_location(
        f'jax_script_{name}', os.path.join(REPO, 'scripts', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Stop(Exception):
    pass


def _recorded_config(monkeypatch, name: str, *args, fn: str = 'main'
                     ) -> dict:
    import nice_slam_tpu.engine.slam as jslam
    seen = []

    def stub(cfg, **_):
        seen.append(cfg)
        raise _Stop
    monkeypatch.setattr(jslam, 'SlamSystem', stub)
    with pytest.raises(_Stop):
        getattr(_jax_script(name), fn)(*args)
    return seen[0]


def _same_fields(port, jax_cfg) -> None:
    """Two NamedTuple configs agree on every field they share."""
    a, b = port._asdict(), jax_cfg._asdict()
    assert set(a) & set(b)
    for k in set(a) & set(b):
        assert a[k] == b[k], k


def _precision_setup_is_the_jax_scripts(monkeypatch, mm_precision) -> None:
    """bench_precision's iMAP* call: the JAX script's `time_imap` runs
    until it builds its step, whose arguments are recorded."""
    import nice_slam_tpu.engine.mapper as jm
    seen = {}

    def stub(**kw):
        seen.update(kw)
        raise _Stop
    monkeypatch.setattr(jm, 'make_map_step', stub)
    with pytest.raises(_Stop):
        _jax_script('bench_precision').time_imap(60, mm_precision)
    got = bench_precision.imap_setup(60, mm_precision, CPU)
    assert seen['model'].kind == got['model'].kind == 'imap'
    for key in ('dcfg', 'rcfg', 'mcfg'):
        want = seen['model'].decoder if key == 'dcfg' else seen[key[0] + 'cfg']
        _same_fields(got[key], want)
    assert got['dcfg'].mm_precision == mm_precision
    assert tuple(got['intr']) == tuple(seen['intr'])
    np.testing.assert_allclose(np_of(got['model'].bound),
                               np.asarray(seen['model'].bound), rtol=1e-6)
    assert (got['n_frames'], got['pixels'] // got['n_frames'], 60) == (
        seen['n_frames'], seen['pix_per_frame'], seen['n_iters'])


@pytest.mark.parametrize('name,args', [
    ('bench_demo', ()),
    ('bench_demo', (500, True)),
    ('bench_demo', (500, False, 'strict')),
    ('bench_demo', (60, True, 'strict')),
    ('bench_imap_e2e', ()),
    ('bench_imap_e2e', (6, 1.0)),
    ('diagnose_strict', ()),
    ('bench_precision', (None,)),
    ('bench_precision', ('BF16_BF16_F32_X3',)),
    ('bench_precision', ('bfloat16',)),
])
def test_config_is_the_jax_scripts(name, args, monkeypatch):
    import jax
    if name == 'bench_precision':
        _precision_setup_is_the_jax_scripts(monkeypatch, *args)
        want = _recorded_config(monkeypatch, name, *args, fn='orbit_ate')
        got = bench_precision.orbit_config(*args)
        assert json.dumps(got, sort_keys=True) == json.dumps(
            want, sort_keys=True)
        return
    try:
        want = _recorded_config(monkeypatch, name, *args)
    finally:
        jax.config.update('jax_log_compiles', False)   # diagnose_strict's
    if name == 'bench_demo':
        got = bench_demo.demo_config(*args)
    elif name == 'bench_imap_e2e':
        assert want['model']['decoder_matmul_precision'] == 'bfloat16'
        got = bench_imap_e2e.imap_config(*args)
    else:
        assert want['sync_method'] == 'strict'
        got = bench_sync_modes.mode_config('strict', 40)
        assert got.pop('sync_force_free') is True
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


def _jax_printed_keys(monkeypatch, capsys, name: str, *args) -> set:
    """The keys of the JSON line the JAX script prints around a stub
    SlamSystem with 4 poses and JAX PhaseTimers."""
    import nice_slam_tpu.engine.slam as jslam

    class Stub:
        def __init__(self, cfg, **_):
            n = 4
            self.gt_c2w = np.tile(np.eye(4), (n, 1, 1))
            self.gt_c2w[:, :3, 3] = np.random.default_rng(0).random((n, 3))
            self.estimate_c2w = self.gt_c2w.copy()
            self.estimate_c2w[:, 0, 3] += 0.01 * np.arange(n)
            self.timers = jslam.PhaseTimers(track_s=1.0, map_s=1.0,
                                            frames_tracked=n,
                                            frames_mapped=2, map_iters=20)

        def run(self):
            pass
    monkeypatch.setattr(jslam, 'SlamSystem', Stub)
    capsys.readouterr()
    _jax_script(name).main(*args)
    return set(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))


def _finite(obj) -> bool:
    if isinstance(obj, dict):
        return all(_finite(v) for v in obj.values())
    if isinstance(obj, list):
        return all(_finite(v) for v in obj)
    if isinstance(obj, float):
        return math.isfinite(obj)
    return True


@pytest.mark.parametrize('name', ['bench_demo', 'bench_imap_e2e'])
def test_output_keys_are_the_jax_scripts(name, monkeypatch, capsys):
    want = _jax_printed_keys(monkeypatch, capsys, name, 4)
    if name == 'bench_demo':
        monkeypatch.setattr(bench_demo, 'main', functools.partial(
            bench_demo.main, h=60, w=80, update=TINY))
        bench_demo.cli(['3', '--device', 'cpu'])
    else:
        monkeypatch.setattr(bench_imap_e2e, 'main', functools.partial(
            bench_imap_e2e.main, h=60, w=80, update=TINY))
        bench_imap_e2e.cli(['3', '--device', 'cpu'])
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(row) >= want | {'device', 'launches', 'peak_mem_gb'}
    assert row['device'] == 'cpu' and row['peak_mem_gb'] is None
    assert row['frames_tracked'] == 3 and _finite(row)
    assert not any(row['launches'].values())
    if name == 'bench_demo':
        # the last frame is always mapped, meshed and checkpointed
        assert row['mode'] == 'loose'
        assert row['meshes'] == 1 and row['checkpoints'] == 1


def test_lattice_query_matches_jax():
    """bench_fused_eval's query at 16^3 on the CPU against JAX eval_raw
    (the JAX script's computation) on the same points and parameters."""
    import jax.numpy as jnp

    import __graft_entry__ as g
    from nice_slam_tpu.models.grids import prepare_grids as jprepare
    from nice_slam_tpu.render.renderer import eval_raw as jeval_raw
    jmodel, _, _, jgrids, jparams, _ = g._tiny_setup()
    pts = bench_fused_eval.lattice_points(16, chunk=16 ** 3)
    want = np.asarray(jeval_raw(
        jparams, jprepare(jgrids, jmodel.grid_shapes, stage='fine'),
        jnp.asarray(pts[0]), 'fine', jmodel)[:, 3])
    model, _, _, _ = bench_fused_eval._tiny_setup(CPU)
    assert model.grid_shapes == jmodel.grid_shapes
    decoders = decoders_from_numpy(tree_np(jparams), model.decoder)
    grids = G.prepare_grids(grids_from_numpy(tree_np(jgrids)),
                            model.grid_shapes, stage='fine')
    pts3 = torch.from_numpy(pts)
    inside = np.all((pts[0] > np.asarray(jmodel.bound)[:, 0])
                    & (pts[0] < np.asarray(jmodel.bound)[:, 1]), axis=-1)
    assert 0 < inside.sum() < len(inside)
    tol = 1e-5 * max(1.0, float(np.abs(want[inside]).max()))
    for fused in (False, True):
        got = np_of(bench_fused_eval.query(
            decoders, grids, pts3, model._replace(fused_eval=fused)))[0]
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_fused_eval_end_to_end_on_cpu(capsys):
    row = bench_fused_eval.main(8, 'cpu', reps=1, chunk=128)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith('plain: 8^3 fine-stage query (0.0M pts) in ')
    assert lines[1].startswith('fused: 8^3 fine-stage query (0.0M pts) in ')
    assert row['chunks'] == 4 and row['points'] == 512
    # on the CPU the fused path is the kernel's plain version
    assert row['agree'] and row['max_abs_diff'] == 0.0 and _finite(row)


@pytest.fixture(scope='module')
def track_case():
    wl = ablate_track_step.ablation_workload(CPU, h=60, w=80)
    wl = wl._replace(tcfg=wl.tcfg._replace(iters=3))
    tg = bench.track_grids(wl)
    draws = ablate_track_step.track_draws(wl, wl.tcfg.pixels, 3)
    production = bench.run_track(wl, tg, draws=draws)[2]
    return wl, tg, draws, production


def test_track_ablations(track_case):
    wl, tg, draws, production = track_case
    cam7 = wl.cam7.clone()
    params = [p.clone() for p in wl.decoders.parameters()]
    cases = ablate_track_step.cases(
        wl, tg, draws, ablate_track_step.track_draws(wl, 1000, 3))
    assert list(cases) == ['full', 'fwd_only', 'no_sort', 'no_color',
                           'pix1000', 'iters1']
    assert torch.equal(cases['full'][0](), production)
    fwd = cases['fwd_only'][0]()
    # the first iteration's loss is taken at the initial pose either way
    assert fwd.shape == (3,) and torch.equal(fwd[0], production[0])
    # wrong math, timing only: finite (test_no_sort_skips_the_sort)
    assert torch.isfinite(cases['no_sort'][0]()).all()
    assert cases['iters1'][1] == 1 and cases['iters1'][0]().shape == (1,)
    for label in ('no_color', 'pix1000'):
        assert torch.isfinite(cases[label][0]()).all()
    # nothing changed the workload, and the production bits are back
    assert torch.equal(wl.cam7, cam7)
    assert all(torch.equal(a, b) for a, b in zip(wl.decoders.parameters(),
                                                  params))
    assert torch.sort is REAL_SORT
    assert torch.equal(bench.run_track(wl, tg, draws=draws)[2], production)


@pytest.fixture(scope='module')
def map_case():
    wl = ablate_map_step.map_workload(CPU, h=60, w=80, n_iters=4)
    wl = wl._replace(mcfg=wl.mcfg._replace(pixels=200))
    assert set(wl.stage_idx.tolist()) == {1, 2, 3}
    draws = ablate_map_step.map_draws(wl)
    cams, losses = bench.run_map(wl, bench.map_state(wl), draws=draws)
    return wl, draws, cams, losses


def _same_state(a, b) -> bool:
    (ga, da), (gb, db) = a, b
    return (all(torch.equal(ga[k], gb[k]) for k in ga)
            and all(torch.equal(x, y) for x, y in zip(da.parameters(),
                                                       db.parameters())))


def test_map_ablations(map_case):
    wl, draws, cams, losses = map_case
    start = bench.map_state(wl)
    cases = ablate_map_step.cases(wl, draws)
    assert list(cases) == ['full', 'fwd_only', 'no_grid_grad', 'no_dec_grad',
                           'no_cam_grad', 'frozen_expand', 'no_sort']
    cam0 = wl.cam7.repeat(wl.mcfg.window_size, 1)

    def run(label):
        state = bench.map_state(wl)
        return state, cases[label](state)

    state, (c, l) = run('full')
    assert torch.equal(c, cams) and torch.equal(l, losses)
    assert not _same_state(state, start)
    # map_call with nothing taken away is the production call
    state = bench.map_state(wl)
    c, l = ablate_map_step.map_call(wl, state, draws)
    assert torch.equal(c, cams) and torch.equal(l, losses)

    state, (c, l) = run('fwd_only')
    assert _same_state(state, start) and torch.equal(c, cam0)
    assert l.shape == losses.shape and torch.equal(l[0], losses[0])

    state, (c, _) = run('no_grid_grad')
    assert all(torch.equal(state[0][k], start[0][k]) for k in start[0])
    assert not torch.equal(c, cam0)

    state, (c, _) = run('no_dec_grad')
    assert all(torch.equal(x, y) for x, y in zip(state[1].parameters(),
                                                  start[1].parameters()))

    state, (c, _) = run('no_cam_grad')
    assert torch.equal(c, cam0)
    assert not all(torch.equal(state[0][k], start[0][k]) for k in start[0])

    assert torch.isfinite(run('no_sort')[1][1]).all()
    # frozen_expand: no gradient reaches the volumes, and the first
    # iteration sees the production call's features
    state, (c, l) = run('frozen_expand')
    assert torch.isfinite(l).all() and torch.equal(l[0], losses[0])
    assert all(torch.equal(state[0][k], start[0][k]) for k in start[0])
    assert torch.sort is REAL_SORT and M.prepare_grids is G.prepare_grids
    c, l = bench.run_map(wl, bench.map_state(wl), draws=draws)
    assert torch.equal(c, cams) and torch.equal(l, losses)


def test_no_sort_skips_the_sort(track_case):
    from nice_slam_tpu_torch.utils import measure
    wl = track_case[0]
    n = 64
    o = torch.zeros((n, 3)) + torch.tensor([2.0, 0.0, 0.3])
    th = torch.linspace(-0.5, 0.5, n)
    d = torch.stack([torch.sin(th), 0.1 * torch.cos(3 * th),
                     -torch.cos(th)], dim=-1)
    depth = torch.full((n,), 1.5)

    def z():
        return R._z_values(wl.rcfg, o, d, depth, wl.model.bound, 'color')
    want = z()
    assert (want[:, 1:] >= want[:, :-1]).all()
    x = torch.cat([want, want.flip(-1)], dim=-1)
    with measure.no_sort():
        got = z()
        # the stable sort of the importance merge still sorts
        stable = torch.sort(x, dim=-1, stable=True)
    assert torch.equal(stable.values, REAL_SORT(x, dim=-1, stable=True).values)
    assert not (got[:, 1:] >= got[:, :-1]).all()
    assert torch.equal(got.sort(dim=-1).values, want)
    assert torch.equal(z(), want)


def test_frozen_expand_serves_one_expansion(map_case):
    wl = map_case[0]
    shapes = wl.model.grid_shapes
    want = G.prepare_grids(wl.grids, shapes)
    other = {k: g + 1.0 for k, g in wl.grids.items()}
    with ablate_map_step.frozen_expand(wl.grids, shapes):
        got = M.prepare_grids(other, shapes, stage='middle')
        assert got is M.prepare_grids(other, shapes, stage='color')
    assert set(got) == set(want)
    for k in want:
        a, b = got[k], want[k]
        assert torch.equal(getattr(a, 'e', a), getattr(b, 'e', b))


def test_wrong_math_contexts_restore_on_error(map_case):
    from nice_slam_tpu_torch.utils import measure
    wl = map_case[0]
    for ctx in (measure.no_sort(),
                ablate_map_step.frozen_expand(wl.grids,
                                              wl.model.grid_shapes)):
        with pytest.raises(_Stop):
            with ctx:
                assert torch.sort is not REAL_SORT or (
                    M.prepare_grids is not G.prepare_grids)
                raise _Stop
        assert torch.sort is REAL_SORT and (
            M.prepare_grids is G.prepare_grids)


def _short(wl):
    """A bench workload with 2 tracking iterations and 200 mapping
    pixels."""
    return wl._replace(tcfg=wl.tcfg._replace(iters=2),
                       mcfg=wl.mcfg._replace(pixels=200))


def _lines_and_row(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    return lines, json.loads(lines[-1])


def test_profile_steps_end_to_end_on_cpu(monkeypatch, capsys):
    workload = bench.workload
    monkeypatch.setattr(bench, 'workload', lambda *a, **k: _short(
        workload(*a, **k)))
    monkeypatch.setattr(profile_steps, 'main', functools.partial(
        profile_steps.main, h=60, w=80, track_frames=1, map_calls=1,
        map_iters=3))
    profile_steps.cli(['--device', 'cpu'])
    lines, row = _lines_and_row(capsys)
    assert [ln.split()[0] for ln in lines[-7:-1]] == (
        ['[baseline]'] * 3 + ['[expanded]'] * 3)
    for tag in ('baseline', 'expanded'):
        r = row[tag]
        assert r['strict_fps'] == pytest.approx(
            1.0 / (r['track_ms'] * 1e-3 + r['map_ms'] * 1e-3 / 5))
        assert f'{r["track_ms"]:7.2f} ms' in lines[-7 if tag == 'baseline'
                                                   else -4]
    assert _finite(row) and row['device'] == 'cpu'


def test_profile_components_end_to_end_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(profile_components, 'main', functools.partial(
        profile_components.main, n=1, n_pts=500, n_rays=50, n_track=20))
    profile_components.cli(['--device', 'cpu'])
    lines, row = _lines_and_row(capsys)
    pieces = ['trilinear_middle', 'trilinear_fine', 'trilinear_color',
              'nice_eval_color_fwd', 'render_rays_color_fwd',
              'map_grad_iter', 'map_grad_iter_coarse',
              'map_grad_iter_middle', 'map_grad_iter_fine',
              'track_grad_iter']
    assert set(row['grids']) == {'coarse', 'middle', 'fine', 'color'}
    for tag in ('baseline', 'expanded'):
        assert list(row['rows'][tag]) == pieces
        assert sum(ln.startswith(f'[{tag}] ') and 'ms pipelined' in ln
                   for ln in lines) == len(pieces)
    assert _finite(row)


def test_ablations_end_to_end_on_cpu(monkeypatch, capsys):
    track_wl = ablate_track_step.ablation_workload
    monkeypatch.setattr(ablate_track_step, 'ablation_workload',
                        lambda *a, **k: _short(track_wl(*a, **k)))
    map_wl = ablate_map_step.map_workload
    monkeypatch.setattr(ablate_map_step, 'map_workload',
                        lambda *a, **k: _short(map_wl(*a, **k)))
    track = ablate_track_step.main('cpu', h=60, w=80, reps=1)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == list(track['cases'])
    rows = ablate_map_step.main('cpu', h=60, w=80, reps=1, n_iters=3)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines[:7]] == list(rows['cases'])
    assert lines[-1].startswith('full = ')
    for row in (track, rows):
        assert row['full_matches_production'] and _finite(row)


def test_diagnose_strict_end_to_end_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(diagnose_strict, 'main', functools.partial(
        diagnose_strict.main, warm=2, h=60, w=80, update=TINY))
    diagnose_strict.cli(['4', '--device', 'cpu'])
    lines, row = _lines_and_row(capsys)
    steps = [ln.split(':')[0] for ln in lines
             if ln.startswith(('frame ', 'warmup '))]
    assert steps == ['frame 0', 'frame 1', 'warmup 2 frames', 'frame 2',
                     'frame 3']
    assert any(ln.startswith('profiled 2 frames: ') for ln in lines)
    assert any('cumulative' in ln for ln in lines)
    assert len(row['frame_s']) == 4 and len(row['top']) == \
        diagnose_strict.TOP
    assert row['frames_tracked'] == 4 and _finite(row)


def test_entry_points_import_no_jax():
    code = ('import sys\n'
            + ''.join(f'import nice_slam_tpu_torch.tools.{n}\n'
                      for n in ENTRY_POINTS)
            + "bad = [m for m in sys.modules if m == 'jax' or "
              "m.startswith('jax.') or m == 'nice_slam_tpu' or "
              "m.startswith('nice_slam_tpu.')]\n"
              'assert not bad, bad\n')
    res = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
