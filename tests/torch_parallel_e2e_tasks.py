"""Rank-side tasks of tests/test_torch_parallel_e2e.py (run by
tests/torch_rank_pool.py in gloo CPU processes; no JAX here)."""

from __future__ import annotations

import os

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
