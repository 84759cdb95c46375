"""Rank-side tasks of tests/test_torch_parallel_e2e.py and
tests/test_torch_parallel_loose.py (run by tests/torch_rank_pool.py in
gloo CPU processes; no JAX here)."""

from __future__ import annotations

import concurrent.futures
import os
import time

import numpy as np
import torch

from tests.util import make_test_cfg


def slam_run(world, parallel: dict, output: str, seed: int = 4):
    """A 5-frame SlamSystem run on the test scene with `parallel`, on the
    world's ranks; returns the poses, the ground truth and what the rank
    wrote."""
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    cfg = make_test_cfg(n_frames=5)
    cfg['parallel'] = parallel
    slam = SlamSystem(cfg, device='cpu', seed=seed, output=output)
    slam.run()
    # every rank past run(), so rank 0's files are complete (each is
    # written beside its name and renamed) when the directory is listed
    world.sum_list([torch.zeros(1)])
    written = sorted(os.path.relpath(os.path.join(d, f), output)
                     for d, _, files in os.walk(output) for f in files
                     ) if os.path.isdir(output) else []
    return dict(poses=np.asarray(slam.estimate_c2w),
                gt=np.asarray(slam.gt_c2w), world=slam.world.size,
                tracked=slam.timers.summary()['frames_tracked'],
                written=written)


def loose_cfg(parallel: dict, sync: str, n_frames: int, **extra) -> dict:
    """tests/test_torch_async.py's overlapped config on the ranks (and for
    the JAX package's run of the same setting)."""
    cfg = make_test_cfg(n_frames=n_frames, coarse=False)
    cfg['sync_method'] = sync
    cfg['debug'] = {}   # the invariant checks would join every round
    cfg['mapping']['iters_first'] = 200
    cfg['parallel'] = parallel
    cfg.update(extra)
    return cfg


def loose_run(world, parallel: dict, output: str, sync: str = 'loose',
              n_frames: int = 10, seed: int = 4, force_free: bool = False,
              delay_rank: int | None = None, delay_s: float = 0.0):
    """An overlapped SlamSystem run of the test scene on the ranks (no
    meshes).  With `delay_rank`, that rank's mapping rounds start
    `delay_s` late and every other rank waits for its own queued rounds
    before it counts them, so the ranks' local counts of finished rounds
    differ.  Returns the poses, the adoption record and, per frame where
    the ranks agreed, (frame, this rank's count, the agreed count)."""
    import warnings

    from nice_slam_tpu_torch.engine.slam import SlamSystem
    cfg = loose_cfg(parallel, sync, n_frames,
                    **({'sync_force_free': True} if force_free else {}))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        slam = SlamSystem(cfg, device='cpu', seed=seed, output=output)
    slam.mesher = None
    # the control group is made once per process and kept: count this
    # run's collectives on it
    calls = slam._control.stats.calls
    counts, frame = [], [None]
    agree, adopt_rounds = slam._control.min, slam._adopt_rounds

    def recording_min(k):
        agreed = agree(k)
        counts.append((frame[0], k, agreed))
        return agreed

    def settling_adopt_rounds(idx):
        frame[0] = idx
        if delay_rank is not None and world.rank != delay_rank:
            concurrent.futures.wait([f for _, f in slam._rounds])
        return adopt_rounds(idx)

    slam._control.min = recording_min
    slam._adopt_rounds = settling_adopt_rounds
    if world.rank == delay_rank:
        map_async = slam._map_async

        def delayed_map_async(*a, **kw):
            time.sleep(delay_s)
            return map_async(*a, **kw)

        slam._map_async = delayed_map_async
    try:
        slam.run()
    finally:
        # the control group is kept for the process's next systems
        del slam._control.min
    return dict(poses=np.asarray(slam.estimate_c2w),
                gt=np.asarray(slam.gt_c2w), sync=slam.sync_method,
                adoptions=list(slam.adoptions),
                refreshes=dict(slam.refreshes), counts=counts,
                control_calls=slam._control.stats.calls - calls,
                maps=[(i, k) for i, k, _, _ in slam.timers.maps],
                warnings=[str(w.message) for w in caught])


def overlap_setup(world, parallel: dict, sync: str = 'loose',
                  force_free: bool = False, output: str = ''):
    """A SlamSystem built (not run) on the ranks: its schedule, its
    mapper's device, the warnings of its construction and a draw from
    each of its generators."""
    import warnings

    from nice_slam_tpu_torch.engine.slam import SlamSystem
    cfg = loose_cfg(parallel, sync, 4,
                    **({'sync_force_free': True} if force_free else {}))
    # the control group is made once per process and kept: count this
    # system's collectives on it
    control = world.copy('control', backend='gloo')
    calls = control.stats.calls
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        slam = SlamSystem(cfg, device='cpu', seed=4, output=output)
    return dict(sync=slam.sync_method, map_device=str(slam.map_device),
                device=str(world.device),
                warnings=[str(w.message) for w in caught],
                map_draw=torch.rand(8, generator=slam.map_generator).numpy(),
                track_draw=torch.rand(8, generator=slam.generator).numpy(),
                control_calls=control.stats.calls - calls)
