"""The port's overlapped schedules (sync_method loose / free) on the CPU:
the counterparts of tests/test_async.py.  Mapping rounds without BA run on
the port's mapping thread while the tracker renders against its snapshot;
the tracker adopts the newest finished round's snapshot, and under loose
waits for the oldest queued round while its snapshot is more than
every_frame + every_frame // 2 frames behind.

The runs use seed 4 (as the port's other end-to-end tests) and a 200-
iteration first-frame map (the JAX test's config has 400) to keep the
file short; the bound on the per-frame error is the JAX test's.
"""

import threading
import warnings

import numpy as np
import pytest
import torch

from tests.util import make_test_cfg

torch.set_num_threads(2)


def _cfg(sync, n_frames, coarse=False, **extra):
    cfg = make_test_cfg(n_frames=n_frames, coarse=coarse)
    cfg['sync_method'] = sync
    cfg['debug'] = {}   # the invariant checks would join every round
    cfg['mapping']['iters_first'] = 200
    cfg.update(extra)
    return cfg


def _t_err(slam):
    return np.linalg.norm(
        slam.estimate_c2w[:, :3, 3] - slam.gt_c2w[:, :3, 3], axis=-1)


def _hold_round(slam, held_idx, until_idx):
    """Hold the mapping round of frame held_idx until the tracker enters
    frame until_idx, and record, after each tracked frame, (frame, the
    oldest queued round's frame or None, the snapshot's frame)."""
    release = threading.Event()
    timed_out = []
    orig_map, orig_track = slam.map_frame, slam.track
    seen = []

    def holding_map(idx, *a, **kw):
        if idx == held_idx and not kw.get('coarse'):
            if not release.wait(timeout=120):
                timed_out.append(idx)
        return orig_map(idx, *a, **kw)

    def spying_track(idx, *a, **kw):
        if idx == until_idx:
            release.set()
        r = orig_track(idx, *a, **kw)
        pending = slam._pending_refresh
        seen.append((idx, None if pending is None else pending[0],
                     slam._snapshot_idx))
        return r

    slam.map_frame, slam.track = holding_map, spying_track
    return seen, timed_out


def test_loose_tracks_and_gate_forces_refresh(tmp_path):
    """The mapping round of frame 2 is held until the tracker reaches frame
    7, where the snapshot (frame 0's) is 7 frames old: past the loose gate
    (every_frame + every_frame // 2 = 6), so the tracker waits for that
    round.  No queued round outlives the gate, the rounds ran on the
    mapping thread, and the trajectory is within the JAX test's bound."""
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    slam = SlamSystem(_cfg('loose', 10), device='cpu', seed=4,
                      output=str(tmp_path))
    slam.mesher = None
    seen, timed_out = _hold_round(slam, 2, 7)
    slam.run()

    assert not timed_out
    t_err = _t_err(slam)
    assert np.isfinite(t_err).all()
    assert t_err.max() < 0.05, t_err
    assert len(slam.timers.track) == 10
    # mapping every every_frame // 2 = 2 frames, and the last frame
    assert [i for i, *_ in slam.timers.maps] == [0, 2, 4, 6, 8, 9]
    gate = slam.mcfg.every_frame + slam.mcfg.every_frame // 2
    assert gate == 6
    assert any(p is not None for _, p, _ in seen), \
        'no mapping round was ever queued'
    over = [(i, p) for i, p, _ in seen if p is not None and i - p > gate]
    assert not over, f'pending mapping outlived the loose gate: {over}'
    assert all(i - s <= gate for i, _, s in seen), seen
    # frames 1-6 track against frame 0's snapshot; frame 7 waits for 2's
    assert [s for i, _, s in seen if 1 <= i <= 7] == [0] * 6 + [2]
    assert slam.refreshes['forced'] >= 1
    assert slam.refreshes['consumed'] + slam.refreshes['forced'] >= 3
    if slam._pending_refresh is not None:
        assert slam._pending_refresh[1].done()
    assert slam._map_pool is None and slam.map_generator is not \
        slam.generator


def test_free_tracks_with_coarse_rounds(tmp_path):
    """Free, forced on one device, with the coarse mapper: each round runs
    its coarse call on the mapping thread too, and the snapshot carries the
    coarse volume unexpanded.  Free has no gate: with the round of frame 2
    held until frame 8, frame 7 tracks against a 7-frame-old snapshot and
    nothing is forced."""
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    with warnings.catch_warnings():
        warnings.simplefilter('error')   # forced free: no fallback warning
        # the config's visualizer keys warn that the panels are not ported
        warnings.filterwarnings(
            'ignore', message=r'\S+: .* is ignored: the visualizer panels')
        slam = SlamSystem(_cfg('free', 10, coarse=True, sync_force_free=True),
                          device='cpu', seed=4, output=str(tmp_path))
    assert slam.sync_method == 'free'
    slam.mesher = None
    seen, timed_out = _hold_round(slam, 2, 8)
    slam.run()
    assert not timed_out
    t_err = _t_err(slam)
    assert np.isfinite(t_err).all()
    assert t_err.max() < 0.05, t_err
    assert [(i, k) for i, k, *_ in slam.timers.maps] == [
        (0, 'first'), (0, 'coarse')] + [
        (i, k) for i in (2, 4, 6, 8, 9) for k in ('coarse', 'normal')]
    assert (7, 2, 0) in seen, seen
    assert slam.refreshes['forced'] == 0
    decoders, grids = slam._tracking_grids
    assert isinstance(grids['coarse'], torch.Tensor)


def test_ba_activation_counts_the_queued_rounds_keyframes(tmp_path):
    """A round's BA activation reads the keyframe store; the rounds still
    queued count with the keyframes they will append (map_frame's rule:
    idx % keyframe_every == 0 or the last frame but one)."""
    from nice_slam_tpu_torch.engine.keyframes import Keyframe, KeyframeStore
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    slam = SlamSystem(_cfg('loose', 10), device='cpu', seed=4,
                      output=str(tmp_path))
    assert slam.mcfg.keyframe_every == 4 and slam.n_img == 10
    eye = np.eye(4, dtype=np.float32)
    slam.keyframes = KeyframeStore([Keyframe(0, None, None, eye, eye),
                                    Keyframe(4, None, None, eye, eye)])
    assert slam._keyframes_after_rounds() == 2
    slam._rounds.extend([(4, None), (6, None), (8, None)])
    assert slam._keyframes_after_rounds() == 3     # + 8 (= 10 - 2 as well)
    slam._rounds.append((9, None))
    assert slam._keyframes_after_rounds() == 3
    slam._rounds.clear()


def test_free_on_one_device_warns_and_runs_loose(tmp_path):
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    with pytest.warns(UserWarning, match="'free'"):
        slam = SlamSystem(_cfg('free', 4), device='cpu', seed=4,
                          output=str(tmp_path))
    assert slam.sync_method == 'loose'


@pytest.mark.parametrize('every', [1, 2, 4, 5, 9])
def test_map_cadence_matches_jax(tmp_path, every):
    from types import SimpleNamespace

    from nice_slam_tpu.engine.slam import SlamSystem as JSlam
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    for sync in ('strict', 'loose', 'free'):
        cfg = _cfg(sync, 4, sync_force_free=True)
        cfg['mapping']['every_frame'] = every
        slam = SlamSystem(cfg, device='cpu', seed=4, output=str(tmp_path))
        stub = SimpleNamespace(sync_method=sync, mcfg=slam.mcfg)
        assert slam.map_cadence == JSlam.map_cadence.fget(stub)


def test_mapping_error_reaches_run(tmp_path, monkeypatch):
    from nice_slam_tpu_torch.engine import slam as slam_mod
    calls = []

    def failing_map_step(*a, **kw):
        calls.append(1)
        raise FloatingPointError('mapping diverged')

    monkeypatch.setattr(slam_mod, 'map_step', failing_map_step)
    slam = slam_mod.SlamSystem(_cfg('loose', 6), device='cpu', seed=4,
                               output=str(tmp_path))
    slam.mesher = None
    with pytest.raises(FloatingPointError, match='mapping diverged'):
        slam.run()
    assert calls == [1]
    assert slam._map_pool is None
