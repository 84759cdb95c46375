"""Command line: run the port's SLAM on a config and report the ATE.

    python -m nice_slam_tpu_torch configs/Replica/room0.yaml \
        [--nice | --imap] [--input_folder DIR] [--output DIR] [--resume] \
        [--device cpu] [--seed N] [--live [--live_port P]]

`--nice` (the default) and `--imap` pick the method, NICE-SLAM or iMAP*,
and the base config the scene config layers over: configs/nice_slam.yaml
or configs/imap.yaml (paths relative to the working directory, as for
run.py).  `--input_folder` is the recorded sequence's directory (default:
the config's `data.input_folder`), in the format of the config's `dataset`
(Replica, ScanNet, TUM RGB-D, CoFusion, Azure; io/datasets.py).  Runs on
CUDA unless `--device cpu` is given.  The run's output directory is
--output, else the config's `data.output`: checkpoints go to `ckpts/`, meshes to `mesh/`, one line per
frame to `metrics.jsonl`, and at the end trajectory.npz (estimated and
ground-truth c2w) and ate.json.  --resume restarts from the newest
checkpoint in `ckpts/` (from the first frame when there is none).
--live writes the live dashboard under `live/` as the run goes
(`visualization.live: true`); --live_port P also serves it over HTTP on
port P (0: a free one) and implies --live.

Ranks (one process per device, for the `parallel.*` backends) are brought
up from the JAX package's variables, as run.py does: NSTPU_COORDINATOR
(host:port of rank 0's rendezvous), NSTPU_NUM_PROCESSES, NSTPU_PROCESS_ID,
and NSTPU_CPU_SIM=1 for ranks on the CPU (then pass --device cpu).  Every
rank runs the whole sequence; rank 0 alone writes the output directory.
"""

from __future__ import annotations

import argparse
import json
import os


def main() -> None:
    parser = argparse.ArgumentParser(
        description='nice_slam_tpu_torch: NICE-SLAM and iMAP* on '
        'PyTorch/CUDA')
    parser.add_argument('config', type=str, help='path to scene config')
    parser.add_argument('--input_folder', type=str, default=None,
                        help="the sequence's directory (default: the "
                             "config's data.input_folder)")
    group = parser.add_mutually_exclusive_group()
    group.add_argument('--nice', action='store_true', default=True,
                       help='NICE-SLAM (the default)')
    group.add_argument('--imap', dest='nice', action='store_false',
                       help='iMAP*')
    parser.add_argument('--output', type=str, default=None,
                        help="the run's output directory (default: the "
                             "config's data.output)")
    parser.add_argument('--resume', action='store_true',
                        help='resume from the latest checkpoint')
    parser.add_argument('--device', type=str, default=None,
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--live', action='store_true',
                        help='write a self-refreshing live dashboard '
                             'under <output>/live while the run executes')
    parser.add_argument('--live_port', type=int, default=None,
                        help='also serve the live dashboard over HTTP')
    args = parser.parse_args()

    import numpy as np

    from nice_slam_tpu_torch.engine.slam import SlamSystem
    from nice_slam_tpu_torch.eval.ate import evaluate_ate
    from nice_slam_tpu_torch.parallel.distributed import (
        initialize_from_env, shutdown)
    from nice_slam_tpu_torch.utils.ckpt import (
        latest_checkpoint, load_checkpoint)
    from nice_slam_tpu_torch.utils.config import load_config

    default = 'configs/nice_slam.yaml' if args.nice else 'configs/imap.yaml'
    cfg = load_config(args.config, default)
    if args.live or args.live_port is not None:
        vcfg = cfg['visualization'] = dict(cfg.get('visualization') or {},
                                           live=True)
        if args.live_port is not None:
            vcfg['live_port'] = args.live_port
    initialize_from_env()
    try:
        slam = SlamSystem(cfg, nice=args.nice, device=args.device,
                          seed=args.seed, output=args.output,
                          input_folder=args.input_folder)
        print(f'INFO: running on {slam.device}; output folder is '
              f'{slam.output}')
        start = 0
        if args.resume:
            path = latest_checkpoint(os.path.join(slam.output, 'ckpts'))
            if path is not None:
                start = slam.restore(load_checkpoint(path))
                print(f'INFO: resumed from {path} at frame {start}')
        slam.run(start)
        ate = evaluate_ate(slam.estimate_c2w, slam.gt_c2w)
        print('INFO: done.', json.dumps({**slam.timers.summary(), **ate}))
        if slam.writes:
            np.savez(os.path.join(slam.output, 'trajectory.npz'),
                     estimate_c2w=slam.estimate_c2w, gt_c2w=slam.gt_c2w)
            with open(os.path.join(slam.output, 'ate.json'), 'w') as f:
                json.dump(ate, f, indent=1)
    finally:
        shutdown()


if __name__ == '__main__':
    main()
