"""Accuracy bound for the PyTorch port: the JAX package on the synthetic
config, several seeds, on the CPU.

    JAX_PLATFORMS=cpu python scripts/port_jax_accuracy_bound.py \
        [--config configs/Synthetic/synthetic.yaml] [--seeds 0 1 2] \
        [--package jax|torch] [--device cpu|cuda]

Runs the whole sequence through `SlamSystem` of the JAX package (default)
or of the port (`--package torch`, on `--device`) for each seed and prints
one JSON line per seed with the Horn-aligned ATE RMSE and the largest
per-frame translation error (unaligned; frame 0 is anchored to the ground
truth), then a summary line with the worst seed and 1.5x that worst value:
for the JAX package, the bound that `chip_smoke.py` holds the port's
synthetic run to.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_jax(config: str, seed: int):
    import jax
    jax.config.update('jax_platforms', 'cpu')
    from nice_slam_tpu.engine.slam import SlamSystem
    from nice_slam_tpu.utils.config import load_config
    cfg = load_config(config, 'configs/nice_slam.yaml')
    cfg['verbose'] = False
    cfg['enable_vis'] = False
    cfg.setdefault('meshing', {})['eval_rec'] = False
    with tempfile.TemporaryDirectory() as out:
        slam = SlamSystem(cfg, nice=True, output=out, seed=seed)
        slam.mesher = None   # only the trajectory is scored
        slam.run()
    return slam.estimate_c2w, slam.gt_c2w


def run_torch(config: str, seed: int, device: str):
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    from nice_slam_tpu_torch.utils.config import load_config
    cfg = load_config(config, 'configs/nice_slam.yaml')
    slam = SlamSystem(cfg, device=device, seed=seed, verbose=False)
    slam.run()
    return slam.estimate_c2w, slam.gt_c2w


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('--config', default='configs/Synthetic/synthetic.yaml')
    ap.add_argument('--seeds', type=int, nargs='+', default=[0, 1, 2])
    ap.add_argument('--package', choices=('jax', 'torch'), default='jax')
    ap.add_argument('--device', default='cpu')
    args = ap.parse_args()

    import numpy as np

    from nice_slam_tpu_torch.eval.ate import evaluate_ate

    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.package == 'jax':
            est, gt = run_jax(args.config, seed)
        else:
            est, gt = run_torch(args.config, seed, args.device)
        err = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=-1)
        ate = evaluate_ate(est, gt)
        row = {'package': args.package, 'seed': seed, 'frames': len(err),
               'ate_rmse_m': ate['absolute_translational_error.rmse'],
               'max_frame_err_m': float(err.max()),
               'seconds': time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    worst_rmse = max(r['ate_rmse_m'] for r in rows)
    worst_max = max(r['max_frame_err_m'] for r in rows)
    print(json.dumps({'package': args.package, 'config': args.config,
                      'seeds': args.seeds,
                      'worst_ate_rmse_m': worst_rmse,
                      'worst_max_frame_err_m': worst_max,
                      'bound_ate_rmse_m': 1.5 * worst_rmse,
                      'bound_max_frame_err_m': 1.5 * worst_max}))


if __name__ == '__main__':
    main()
