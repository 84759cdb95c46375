"""The overlapped schedules (sync_method loose / free) of the port on two
gloo CPU ranks (tests/torch_rank_pool.py), against the JAX package on two
of its virtual devices (tests/conftest.py): 8-frame runs of the test scene
under `parallel.map: kf`, `parallel.map: rays` and `parallel.track: rays`,
and forced `free` with the tracking and mapping rays both shared (two
groups running all-reduces at once, one per thread).  In the
`track: rays` run the ranks finish their mapping rounds at different
times (rank 1's rounds start late).

Each rank maps on a thread of its own, so its rounds finish when its
thread gets to them; before each frame the ranks agree, in one all-reduce,
on the least count of finished rounds, and every rank adopts the same
round at the same frame.  So the ranks' poses and adoption records must be
identical.  The JAX package runs each setting on the same config and seed
(one controller, whose `is_ready` decides the adoptions for both devices):
the port's ATE RMSE and largest translation error are held to stated
multiples of the JAX run's, and under the absolute bound of
tests/test_async.py (0.05 m); its mapped frames are the JAX run's, and
its loose gate the JAX package's.  The runs use seed 4 and a 200-iteration
first-frame map, as tests/test_torch_async.py does."""

import numpy as np
import pytest
import torch

from tests.torch_parallel_e2e_tasks import loose_cfg
from tests.torch_rank_pool import RankPool

MODES = {'map-kf': {'map': 'kf'},
         'map-rays': {'map': 'rays'},
         'track-rays': {'track': 'rays'}}
BOTH = {'track': 'rays', 'map': 'rays'}
# name -> (parallel.*, sync_method); `free` is forced (one CPU device)
RUNS = {**{mode: (parallel, 'loose') for mode, parallel in MODES.items()},
        'free': (BOTH, 'free')}
TASKS = 'tests.torch_parallel_e2e_tasks'
# the skewed run: rank 1's rounds start this late, rank 0 waits for its own
SKEWED = 'track-rays'
SKEW_DELAY_S = 1.0
FRAMES = 8
T_ERR_BOUND_M = 0.05
# the port's error against the JAX run's on the same setting.  The two
# draw their rays from different generators and adopt rounds at frames
# their own timing picks (on the CPU the port's mapping thread shares the
# interpreter lock with the tracker, and adopts each round a frame or so
# later), so one JAX run is one draw of a spread.  ATE RMSE: within 1.5x,
# the rule of chip_smoke.py's gates.  The largest per-frame error, one
# frame of eight: within 2x (between JAX seeds of one setting it spreads
# 2.57x on synthetic.yaml, PERF.md section 2)
JAX_RMSE_MULT = 1.5
JAX_MAX_MULT = 2.0


def _cfg(name: str) -> dict:
    parallel, sync = RUNS[name]
    return loose_cfg(dict(parallel, devices=2), sync, FRAMES,
                     **({'sync_force_free': True} if sync == 'free' else {}))


def _jax_run(name: str, output: str) -> dict:
    """The JAX SlamSystem on the run's config and seed, on two of the
    virtual devices: its poses, its mapped frames, the age of the round
    still pending after each tracked frame, and its loose gate."""
    from nice_slam_tpu.engine.slam import SlamSystem as JSlam
    slam = JSlam(_cfg(name), nice=True, output=output, seed=4)
    slam.mesher = None
    maps, ages = [], []
    map_frame, track = slam.map_frame, slam.track

    def spying_map_frame(idx, *a, **kw):
        if not kw.get('coarse'):
            maps.append(idx)
        return map_frame(idx, *a, **kw)

    def spying_track(idx, *a, **kw):
        out = track(idx, *a, **kw)
        if slam._pending_refresh is not None:
            ages.append(idx - slam._pending_refresh[0])
        return out

    slam.map_frame, slam.track = spying_map_frame, spying_track
    slam.run()
    every = slam.mcfg.every_frame
    return dict(poses=np.asarray(slam.estimate_c2w),
                gt=np.asarray(slam.gt_c2w), sync=slam.sync_method,
                maps=maps, pending_ages=ages, gate=every + every // 2)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The four runs, one after another on one pool of two ranks, while
    this process runs the JAX package's runs of the same settings; the
    pool then serves the schedule's set-up checks."""
    tmp = tmp_path_factory.mktemp('loose')
    pool = RankPool(2, TASKS, timeout=400.0)
    try:
        # the ranks take the tasks in order; their results wait for
        # `collect`
        for name, (parallel, sync) in RUNS.items():
            skew = (dict(delay_rank=1, delay_s=SKEW_DELAY_S)
                    if name == SKEWED else {})
            pool.submit('loose_run', output=str(tmp / name),
                        parallel=dict(parallel, devices=2), sync=sync,
                        force_free=sync == 'free', n_frames=FRAMES, **skew)
        jax_runs = {name: _jax_run(name, str(tmp / f'jax-{name}'))
                    for name in RUNS}
        results = {name: pool.collect('loose_run') for name in RUNS}
        yield dict(pool=pool, results=results, jax=jax_runs)
    finally:
        pool.close()


def _result(runs, name):
    return runs['results'][name]


def _setup(runs, **kw):
    """`overlap_setup` on the ranks, once the runs are done."""
    return runs['pool'].run('overlap_setup', **kw)


def _t_err(run) -> np.ndarray:
    return np.linalg.norm(run['poses'][:, :3, 3] - run['gt'][:, :3, 3],
                          axis=-1)


def _rmse(t_err: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.square(t_err))))


def _check_agreed(runs, name, record_property):
    """Both ranks ran the setting's schedule, agreed at the same frames on
    the same counts, adopted the same rounds at the same frames and
    tracked the same poses, within the stated multiples of the JAX run's
    errors and under the absolute bound.  The errors and the adoptions go
    into the test report's properties (`--junitxml`)."""
    res, jax_run = _result(runs, name), runs['jax'][name]
    sync = RUNS[name][1]
    assert [r['sync'] for r in res] == [sync, sync] == [jax_run['sync']] * 2
    assert all(not r['warnings'] for r in res), res[0]['warnings']
    assert res[0]['adoptions'] == res[1]['adoptions']
    assert [(i, a) for i, _, a in res[0]['counts']] == \
        [(i, a) for i, _, a in res[1]['counts']]
    assert res[0]['control_calls'] == res[1]['control_calls'] > 0
    np.testing.assert_array_equal(res[0]['poses'], res[1]['poses'])
    assert len(res[0]['poses']) == FRAMES
    t_err, jax_err = _t_err(res[0]), _t_err(jax_run)
    assert np.isfinite(t_err).all() and np.isfinite(jax_err).all()
    for key, value in [('ate_rmse_m', _rmse(t_err)),
                       ('max_err_m', float(t_err.max())),
                       ('jax_ate_rmse_m', _rmse(jax_err)),
                       ('jax_max_err_m', float(jax_err.max())),
                       ('adoptions', res[0]['adoptions'])]:
        record_property(key, value)
    assert t_err.max() < T_ERR_BOUND_M, t_err
    assert _rmse(t_err) <= JAX_RMSE_MULT * _rmse(jax_err), (t_err, jax_err)
    assert t_err.max() <= JAX_MAX_MULT * jax_err.max(), (t_err, jax_err)
    return res


@pytest.mark.parametrize('mode', list(MODES))
def test_loose_on_two_ranks(runs, mode, record_property):
    _check_agreed(runs, mode, record_property)


def test_forced_free_on_two_ranks(runs, record_property):
    """`free` (forced: the CPU ranks share one device) with the tracking
    and the mapping rays shared: the tracker's and the mapper's groups run
    their all-reduces at once, in different orders on the ranks."""
    res = _check_agreed(runs, 'free', record_property)
    # free has no gate
    assert res[0]['refreshes']['forced'] == 0


@pytest.mark.parametrize('name', list(RUNS))
def test_schedule_matches_jax(runs, name):
    """The port maps the JAX run's frames, and its loose gate is the JAX
    package's: no frame tracks against a snapshot older than the gate,
    and a round is adopted before it is done only when the snapshot
    would be older.  Frame 1 adopts the first-frame round."""
    res, jax_run = _result(runs, name)[0], runs['jax'][name]
    assert [i for i, _ in res['maps']] == jax_run['maps']
    gate = jax_run['gate']
    assert max(jax_run['pending_ages'] or [0]) <= gate
    adoptions = res['adoptions']
    assert adoptions[0] == (1, 0, False), adoptions
    if RUNS[name][1] == 'free':
        assert not any(forced for _, _, forced in adoptions), adoptions
        return
    snapshot, taken = -1, {}
    for i, p, forced in adoptions:
        if forced:
            assert i - snapshot > gate, adoptions
        snapshot = taken[i] = p
    snapshot = -1
    for i in range(1, FRAMES):
        snapshot = taken.get(i, snapshot)
        assert i - snapshot <= gate, adoptions


def test_ranks_agree_under_skewed_rounds(runs, record_property):
    """Rank 1's rounds start late and rank 0 waits for its own, so at some
    frames rank 0 has finished rounds that rank 1 has not: their local
    counts differ there, and both adopt what the minimum says."""
    res = _check_agreed(runs, SKEWED, record_property)
    local = [[k for _, k, _ in r['counts']] for r in res]
    agreed = [a for _, _, a in res[0]['counts']]
    differ = [i for i, (a, b) in enumerate(zip(*local)) if a != b]
    assert differ, res[0]['counts']
    assert agreed == [min(a, b) for a, b in zip(*local)]
    # at those frames rank 0 had a finished round it did not adopt
    assert all(local[0][i] > agreed[i] for i in differ)


def test_rank_maps_on_its_own_device(runs, tmp_path):
    res = _setup(runs, parallel={'map': 'kf'}, output=str(tmp_path))
    assert all(r['map_device'] == r['device'] for r in res)


@pytest.mark.parametrize('device,cards,world,overlap,want', [
    ('cuda:0', 4, 1, True, 'cuda:1'),     # the two-device pipeline
    ('cuda:3', 4, 1, True, 'cuda:0'),
    ('cuda:0', 1, 1, True, 'cuda:0'),
    ('cuda:0', 4, 1, False, 'cuda:0'),
    ('cuda:1', 4, 4, True, 'cuda:1'),     # a rank on a card of its own
    ('cuda:0', 1, 2, True, 'cuda:0'),     # ranks sharing the card
    ('cpu', 1, 2, True, 'cpu'),
])
def test_map_device_rule(device, cards, world, overlap, want):
    from nice_slam_tpu_torch.engine.slam import map_device_for
    assert map_device_for(torch.device(device), cards, world, overlap) \
        == torch.device(want)


def test_loose_map_rays_draws_differ_per_rank(runs, tmp_path):
    """Under loose with `parallel.map: rays` each rank draws its own
    mapping rays; the tracking draws, and keyframe-sharded mapping's,
    stay in step."""
    rays = _setup(runs, parallel={'map': 'rays'}, output=str(tmp_path))
    assert not np.array_equal(rays[0]['map_draw'], rays[1]['map_draw'])
    np.testing.assert_array_equal(rays[0]['track_draw'],
                                  rays[1]['track_draw'])
    kf = _setup(runs, parallel={'map': 'kf'}, output=str(tmp_path))
    np.testing.assert_array_equal(kf[0]['map_draw'], kf[1]['map_draw'])
    # rank 0 draws as a world of one does
    np.testing.assert_array_equal(rays[0]['map_draw'], kf[0]['map_draw'])


@pytest.mark.parametrize('distinct,force,want', [
    (False, False, 'loose'),    # CPU ranks: one device
    (True, False, 'free'),      # ranks on distinct devices
    (False, True, 'free'),
])
def test_free_rule_follows_distinct_devices(runs, tmp_path, distinct, force,
                                            want):
    """`free` needs two devices.  Ranks with a card each run NCCL: a
    device a rank, whatever cards a rank sees.  Ranks sharing a card, and
    CPU ranks, run gloo: one device.  A world of one counts its cards."""
    from nice_slam_tpu_torch.engine.slam import overlap_devices
    assert overlap_devices(2, 1, 'none') == 2
    assert overlap_devices(1, 1, 'none') == 1
    if distinct:
        assert overlap_devices(1, 2, 'nccl') == overlap_devices(8, 2, 'nccl') \
            == 2
        assert overlap_devices(4, 4, 'nccl') == 4
        assert want == 'free'
        return
    assert overlap_devices(1, 2, 'gloo') == overlap_devices(4, 2, 'gloo') \
        == 1
    # the CPU ranks: the system's own choice
    res = _setup(runs, parallel={'map': 'rays'}, sync='free',
                 force_free=force, output=str(tmp_path))
    assert [r['sync'] for r in res] == [want, want]
    warned = [any("'free'" in w for w in r['warnings']) for r in res]
    assert warned == [want == 'loose'] * 2
    # the rule needs no collective
    assert [r['control_calls'] for r in res] == [0, 0]
