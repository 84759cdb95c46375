"""Seed scan of the end-to-end test scene for both packages, on the CPU.

    JAX_PLATFORMS=cpu python scripts/port_seed_scan.py [--seeds 0 1 2 3 4] \
        [--package jax torch] [--frames 9] [--init-from-jax]

Runs `SlamSystem` of the JAX package and of the port on
`tests.util.make_test_cfg(n_frames=9)` (the scene of both packages'
`test_short_end_to_end_run`) for each seed, and prints one JSON line per
run: the largest and the mean per-frame translation error and whether the
run meets that test's bars (max < 0.02 m, mean < 0.01 m).  The two
packages draw different initial values and pixels from the same seed, so
the scan compares pass rates, not seeds.  With `--init-from-jax` the port
starts from the JAX package's initial grids and decoders for the same seed
(only the pixel draws then differ), which separates the effect of the
initial model from that of the draws.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def run_jax(cfg: dict, seed: int):
    import jax
    jax.config.update('jax_platforms', 'cpu')
    from nice_slam_tpu.engine.slam import SlamSystem
    with tempfile.TemporaryDirectory() as out:
        slam = SlamSystem(cfg, nice=True, output=out, seed=seed)
        slam.run()
    return slam.estimate_c2w, slam.gt_c2w


def jax_initial_model(cfg: dict, seed: int):
    """The JAX package's initial grids and decoders for `seed`, as numpy."""
    import jax
    import numpy as np
    from nice_slam_tpu.engine.slam import SlamSystem
    with tempfile.TemporaryDirectory() as out:
        slam = SlamSystem(cfg, nice=True, output=out, seed=seed)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    return to_np(slam.grids), to_np({**slam.opt_dec, **slam.frozen_dec})


def run_torch(cfg: dict, seed: int, init_from_jax: bool = False):
    import torch
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    from nice_slam_tpu_torch.models.convert import (
        decoders_from_numpy, grids_from_numpy)
    with tempfile.TemporaryDirectory() as out:
        slam = SlamSystem(cfg, device='cpu', seed=seed, output=out)
        if init_from_jax:
            grids, decs = jax_initial_model(cfg, seed)
            slam.grids = {k: v.requires_grad_(True)
                          for k, v in grids_from_numpy(grids).items()}
            with torch.no_grad():
                slam.decoders.load_state_dict(
                    decoders_from_numpy(decs, slam.dcfg).state_dict())
        slam.run()
    return slam.estimate_c2w, slam.gt_c2w


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('--seeds', type=int, nargs='+', default=[0, 1, 2, 3, 4])
    ap.add_argument('--package', nargs='+', choices=('jax', 'torch'),
                    default=['jax', 'torch'])
    ap.add_argument('--frames', type=int, default=9)
    ap.add_argument('--init-from-jax', action='store_true')
    args = ap.parse_args()

    import numpy as np

    from tests.util import make_test_cfg

    for package in args.package:
        passed = 0
        for seed in args.seeds:
            t0 = time.perf_counter()
            cfg = make_test_cfg(n_frames=args.frames)
            if package == 'jax':
                est, gt = run_jax(cfg, seed)
            else:
                est, gt = run_torch(cfg, seed, args.init_from_jax)
            err = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=-1)
            ok = bool(err.max() < 0.02 and err.mean() < 0.01)
            passed += ok
            print(json.dumps({'package': package, 'seed': seed,
                              'init_from_jax': (package == 'torch'
                                                and args.init_from_jax),
                              'max_frame_err_m': float(err.max()),
                              'mean_frame_err_m': float(err.mean()),
                              'meets_test_bars': ok,
                              'seconds': time.perf_counter() - t0}),
                  flush=True)
        print(json.dumps({'package': package, 'seeds': args.seeds,
                          'meet_test_bars': passed}), flush=True)


if __name__ == '__main__':
    main()
