"""Accuracy bound for the PyTorch port: the JAX package on the synthetic
config, several seeds, on the CPU.

    JAX_PLATFORMS=cpu python scripts/port_jax_accuracy_bound.py \
        [--config configs/Synthetic/synthetic.yaml] [--seeds 0 1 2] \
        [--package jax|torch] [--device cpu|cuda] [--recon]

Runs the whole sequence through `SlamSystem` of the JAX package (default)
or of the port (`--package torch`, on `--device`) for each seed and prints
one JSON line per seed with the Horn-aligned ATE RMSE and the largest
per-frame translation error (unaligned; frame 0 is anchored to the ground
truth), then a summary line with the worst seed and 1.5x that worst value:
for the JAX package, the bound that `chip_smoke.py` holds the port's
synthetic run to.

With --recon the mesher stays on: each run writes its final mesh
(`meshing.resolution` of the config, 128^3 for synthetic.yaml), which is
scored with `calc_3d_metric` (no alignment) against the analytic
ground-truth mesh of the scene (`synthetic_gt_mesh`), and the summary adds
the reconstruction bound: 1.5x the worst seed's accuracy and completion
(cm) and 0.67x the worst completion ratio (%).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_jax(config: str, seed: int, out: str, recon: bool):
    import jax
    jax.config.update('jax_platforms', 'cpu')
    from nice_slam_tpu.engine.slam import SlamSystem
    from nice_slam_tpu.utils.config import load_config
    cfg = load_config(config, 'configs/nice_slam.yaml')
    cfg['verbose'] = False
    cfg['enable_vis'] = False
    cfg.setdefault('meshing', {})['eval_rec'] = False
    slam = SlamSystem(cfg, nice=True, output=out, seed=seed)
    if not recon:
        slam.mesher = None   # only the trajectory is scored
    slam.run()
    return slam.estimate_c2w, slam.gt_c2w, cfg


def run_torch(config: str, seed: int, device: str, out: str, recon: bool):
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    from nice_slam_tpu_torch.utils.config import load_config
    cfg = load_config(config, 'configs/nice_slam.yaml')
    cfg.setdefault('meshing', {})['eval_rec'] = False
    slam = SlamSystem(cfg, device=device, seed=seed, verbose=False,
                      output=out)
    if not recon:
        slam.mesher = None   # only the trajectory is scored
    slam.run()
    return slam.estimate_c2w, slam.gt_c2w, cfg


def score_mesh(out: str, cfg: dict) -> dict:
    """calc_3d_metric of the run's final mesh against the analytic
    ground truth of the synthetic scene."""
    from nice_slam_tpu_torch.eval.recon import calc_3d_metric
    from nice_slam_tpu_torch.io.datasets import synthetic_gt_mesh
    from nice_slam_tpu_torch.mesh.mesher import load_ply
    rec_v, rec_t = load_ply(os.path.join(out, 'mesh', 'final_mesh.ply'))
    gt_v, gt_t = synthetic_gt_mesh(cfg['synthetic']['box'])
    return calc_3d_metric(rec_v, rec_t, gt_v, gt_t, align=False)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('--config', default='configs/Synthetic/synthetic.yaml')
    ap.add_argument('--seeds', type=int, nargs='+', default=[0, 1, 2])
    ap.add_argument('--package', choices=('jax', 'torch'), default='jax')
    ap.add_argument('--device', default='cpu')
    ap.add_argument('--recon', action='store_true',
                    help='keep the mesher on and score the final mesh')
    args = ap.parse_args()

    import numpy as np

    from nice_slam_tpu_torch.eval.ate import evaluate_ate

    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as out:
            if args.package == 'jax':
                est, gt, cfg = run_jax(args.config, seed, out, args.recon)
            else:
                est, gt, cfg = run_torch(args.config, seed, args.device,
                                         out, args.recon)
            recon = score_mesh(out, cfg) if args.recon else {}
        err = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=-1)
        ate = evaluate_ate(est, gt)
        row = {'package': args.package, 'seed': seed, 'frames': len(err),
               'ate_rmse_m': ate['absolute_translational_error.rmse'],
               'max_frame_err_m': float(err.max()), **recon,
               'seconds': time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    worst_rmse = max(r['ate_rmse_m'] for r in rows)
    worst_max = max(r['max_frame_err_m'] for r in rows)
    summary = {'package': args.package, 'config': args.config,
               'seeds': args.seeds,
               'worst_ate_rmse_m': worst_rmse,
               'worst_max_frame_err_m': worst_max,
               'bound_ate_rmse_m': 1.5 * worst_rmse,
               'bound_max_frame_err_m': 1.5 * worst_max}
    if args.recon:
        worst_acc = max(r['accuracy_cm'] for r in rows)
        worst_comp = max(r['completion_cm'] for r in rows)
        worst_ratio = min(r['completion_ratio_%'] for r in rows)
        summary.update(worst_accuracy_cm=worst_acc,
                       worst_completion_cm=worst_comp,
                       worst_completion_ratio_pct=worst_ratio,
                       bound_accuracy_cm=1.5 * worst_acc,
                       bound_completion_cm=1.5 * worst_comp,
                       bound_completion_ratio_pct=0.67 * worst_ratio)
    print(json.dumps(summary))


if __name__ == '__main__':
    main()
