"""Command line: run the port's SLAM on a config and report the ATE.

    python -m nice_slam_tpu_torch configs/Synthetic/synthetic.yaml \
        [--output DIR] [--device cpu] [--seed N]

The scene config layers over configs/nice_slam.yaml (paths relative to the
working directory, as for run.py).  Runs on CUDA unless `--device cpu` is
given.  With --output, writes trajectory.npz (estimated and ground-truth
c2w) and ate.json there.
"""

from __future__ import annotations

import argparse
import json
import os


def main() -> None:
    parser = argparse.ArgumentParser(
        description='nice_slam_tpu_torch: NICE-SLAM on PyTorch/CUDA')
    parser.add_argument('config', type=str, help='path to scene config')
    parser.add_argument('--output', type=str, default=None,
                        help='directory for trajectory.npz and ate.json')
    parser.add_argument('--device', type=str, default=None,
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args()

    import numpy as np

    from nice_slam_tpu_torch.engine.slam import SlamSystem
    from nice_slam_tpu_torch.eval.ate import evaluate_ate
    from nice_slam_tpu_torch.utils.config import load_config

    cfg = load_config(args.config, 'configs/nice_slam.yaml')
    slam = SlamSystem(cfg, device=args.device, seed=args.seed)
    print(f'INFO: running on {slam.device}')
    slam.run()
    ate = evaluate_ate(slam.estimate_c2w, slam.gt_c2w)
    print('INFO: done.', json.dumps({**slam.timers.summary(), **ate}))
    if args.output:
        os.makedirs(args.output, exist_ok=True)
        np.savez(os.path.join(args.output, 'trajectory.npz'),
                 estimate_c2w=slam.estimate_c2w, gt_c2w=slam.gt_c2w)
        with open(os.path.join(args.output, 'ate.json'), 'w') as f:
            json.dump(ate, f, indent=1)


if __name__ == '__main__':
    main()
