"""Seed spread of the pretrained-mode transfer (tests/test_pretrained_mode.py)
in the JAX package and in the port, on the CPU, from the same blobs.

    JAX_PLATFORMS=cpu python scripts/port_pretrained_transfer_seeds.py \
        --blobs DIR [--train jax|jax-defaults|port|port-test] \
        [--train-seed S] [--package jax|torch] [--seeds 0 1 2]

--train first writes DIR/coarse.pt and DIR/middle_fine.pt: with `jax`
the JAX tool as tests/test_pretrained_mode.py trains them (8 frames at
60x80, iters_first 400, iters 40, on the training box), with
`jax-defaults` the JAX tool at its defaults (12 frames at 120x160,
iters_first 800, iters 60, seed 0), with `port-test` and `port` the
port's tool in those two ways (its default seed 4), on the CPU;
--train-seed S trains from seed S instead of the tool's default.  Then,
for each seed, the transfer of that test (9 frames at 60x80 on the
unseen box, fix_fine, no train_middle, var_floor 1e-10, no mesh) runs
through the package's SlamSystem, and one JSON line per seed gives the
largest, mean and last-frame translation error beside the test's bars
(0.06, 0.03, 0.055 m) and whether all three hold.  Seeds split over
several processes run in parallel; the port's numbers change with the
thread count (OMP_NUM_THREADS), its float sums' order.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TRAIN_BOX = [[-1, 1], [-0.8, 0.8], [-1, 1]]
TEST_BOX = [[-1.2, 0.9], [-0.7, 0.9], [-0.9, 1.1]]
BARS_M = (0.06, 0.03, 0.055)


def train(kind: str, coarse_p: str, mf_p: str, seed: int | None = None
          ) -> None:
    test = dict(n_frames=8, h=60, w=80, iters_first=400, iters=40,
                box=TRAIN_BOX)
    if seed is not None:
        test['seed'] = seed
    if kind.startswith('jax'):
        sys.path.insert(0, os.path.join(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))), 'tools'))
        from pretrain_decoders import train_decoders
        from nice_slam_tpu.models.pretrain import save_torch_pretrain
        kw = test if kind == 'jax' else {} if seed is None else {'seed': seed}
        save_torch_pretrain(train_decoders(**kw), coarse_p, mf_p)
    else:
        from nice_slam_tpu_torch.models.pretrain import save_torch_pretrain
        from nice_slam_tpu_torch.tools.pretrain_decoders import (
            train_decoders)
        kw = test if kind == 'port-test' else {} if seed is None else {
            'seed': seed}
        save_torch_pretrain(train_decoders(device='cpu', **kw), coarse_p,
                            mf_p)


def transfer_cfg(coarse_p: str, mf_p: str) -> dict:
    from nice_slam_tpu_torch.tools._small_config import small_config
    cfg = small_config(n_frames=9, h=60, w=80)
    cfg['synthetic']['box'] = TEST_BOX
    bound = (np.asarray(TEST_BOX) + np.array([-0.3, 0.3])).tolist()
    cfg['mapping']['bound'] = bound
    cfg['mapping']['marching_cubes_bound'] = bound
    cfg['pretrained_decoders'] = {'coarse': coarse_p, 'middle_fine': mf_p}
    cfg['mapping'].update(fix_fine=True, train_middle=False)
    cfg['tracking']['var_floor'] = 1.0e-10
    return cfg


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--blobs', required=True)
    ap.add_argument('--train',
                    choices=('jax', 'jax-defaults', 'port', 'port-test'))
    ap.add_argument('--train-seed', type=int,
                    help="the training run's seed (default: the tool's)")
    ap.add_argument('--package', choices=('jax', 'torch'), default='jax')
    ap.add_argument('--seeds', type=int, nargs='*', default=[0, 1, 2])
    args = ap.parse_args()
    coarse_p = os.path.join(args.blobs, 'coarse.pt')
    mf_p = os.path.join(args.blobs, 'middle_fine.pt')
    if args.train:
        os.makedirs(args.blobs, exist_ok=True)
        train(args.train, coarse_p, mf_p, args.train_seed)
    for seed in args.seeds:
        cfg = transfer_cfg(coarse_p, mf_p)
        with tempfile.TemporaryDirectory() as out:
            if args.package == 'jax':
                import jax
                jax.config.update('jax_platforms', 'cpu')
                from nice_slam_tpu.engine.slam import SlamSystem
                slam = SlamSystem(cfg, nice=True, output=out, seed=seed)
            else:
                from nice_slam_tpu_torch.engine.slam import SlamSystem
                slam = SlamSystem(cfg, device='cpu', seed=seed, output=out)
            slam.mesher = None
            slam.run()
        err = np.linalg.norm(slam.estimate_c2w[:, :3, 3]
                             - slam.gt_c2w[:, :3, 3], axis=-1)
        got = (float(err.max()), float(err.mean()), float(err[-1]))
        print(json.dumps({
            'package': args.package, 'seed': seed, 'max_m': got[0],
            'mean_m': got[1], 'last_m': got[2], 'bars_m': BARS_M,
            'holds': all(g < b for g, b in zip(got, BARS_M)),
            'frame_err_m': [round(float(e), 4) for e in err]}), flush=True)


if __name__ == '__main__':
    main()
