"""Accuracy bound for the PyTorch port: the JAX package on the synthetic
config, several seeds, on the CPU.

    JAX_PLATFORMS=cpu python scripts/port_jax_accuracy_bound.py \
        [--config configs/Synthetic/synthetic.yaml] [--seeds 0 1 2] \
        [--package jax|torch] [--device cpu|cuda] [--recon] \
        [--sync strict|loose|free] [--imap] [--disk replica|...] \
        [--parallel N [--parallel-map rays|kf|none]] \
        [--session-precision NAME]

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

--sync sets the config's `sync_method` (default: the config's own).  The
JAX package then runs on one local device, as the port does: its 'free'
falls back to 'loose' there, and its two-device pipeline stays off.

--parallel N (JAX package only) runs it on N forced host devices
(`--xla_force_host_platform_device_count=N`, as tests/conftest.py does)
with `parallel: {track: rays, map: rays}`: one controller drives the N
devices, and under --sync loose or free its sharded mapping is dispatched
asynchronously and adopted when ready (the setting the port runs as N
ranks).  --parallel-map kf shares the mapping window's frames instead,
--parallel-map none leaves mapping on one device (the tracking rays stay
shared).

--imap runs iMAP* (`SlamSystem(cfg, nice=False)`) with configs/imap.yaml
as the base config, as `run.py --imap` does (e.g. --config
configs/Synthetic/synthetic_imap.yaml).

--disk KIND first writes the config's analytic scene to a temporary
directory in dataset KIND's on-disk format with the port's writer
(nice_slam_tpu_torch/tools/make_fixture_dataset.write_scene: JPEG color at
quality 97, uint16 PNG depth), then runs every seed through that format's
loader from those files: the JAX package decodes them with cv2, the port
with its own codecs.  The mesh is scored against the same analytic scene.

--session-precision NAME sets the config's session-wide
`matmul_precision` (e.g. bfloat16, tensorfloat32).  The JAX package then
runs under tests/tpu_matmul_rule.py, which lowers its products on the CPU
as the TPU's matrix unit computes them (XLA:CPU would compute them in
float32); the port computes the rule itself.  A run whose poses go
non-finite prints its row with `finite: false` and the first such frame,
and the summary then sets no bound.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def base_config(nice: bool) -> str:
    return 'configs/nice_slam.yaml' if nice else 'configs/imap.yaml'


def run_jax(cfg: dict, seed: int, out: str, recon: bool,
            nice: bool = True):
    import contextlib

    import jax
    jax.config.update('jax_platforms', 'cpu')
    from nice_slam_tpu.engine.slam import SlamSystem
    cfg = copy.deepcopy(cfg)
    cfg['verbose'] = False
    cfg['enable_vis'] = False
    cfg.setdefault('meshing', {})['eval_rec'] = False
    rule = contextlib.nullcontext()
    if cfg.get('matmul_precision', 'float32') not in ('float32', 'highest'):
        from tests.tpu_matmul_rule import tpu_matmul_rule
        rule = tpu_matmul_rule()
    with rule:
        slam = SlamSystem(cfg, nice=nice, output=out, seed=seed)
        if not recon:
            slam.mesher = None   # only the trajectory is scored
        slam.run()
    return slam.estimate_c2w, slam.gt_c2w


def run_torch(cfg: dict, seed: int, device: str, out: str, recon: bool,
              nice: bool = True):
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    cfg = copy.deepcopy(cfg)
    cfg.setdefault('meshing', {})['eval_rec'] = False
    slam = SlamSystem(cfg, nice=nice, device=device, seed=seed,
                      verbose=False, output=out)
    if not recon:
        slam.mesher = None   # only the trajectory is scored
    slam.run()
    return slam.estimate_c2w, slam.gt_c2w


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
    ap.add_argument('--sync', choices=('strict', 'loose', 'free'),
                    help="the config's sync_method (default: as loaded)")
    ap.add_argument('--imap', action='store_true',
                    help='iMAP* over configs/imap.yaml (default: NICE over '
                    'configs/nice_slam.yaml)')
    ap.add_argument('--disk', choices=('replica', 'scannet', 'tumrgbd',
                                       'cofusion', 'azure'),
                    help="read the config's analytic scene from files in "
                    "this dataset's format, written by the port's writer")
    ap.add_argument('--parallel', type=int, default=0, metavar='N',
                    help='the JAX package on N forced host devices with '
                    'parallel: {track: rays, map: rays}')
    ap.add_argument('--parallel-map', choices=('rays', 'kf', 'none'),
                    default='rays',
                    help="with --parallel: the config's parallel.map")
    ap.add_argument('--session-precision', metavar='NAME',
                    help="the config's matmul_precision (the JAX package "
                    "under the TPU's rule, tests/tpu_matmul_rule.py)")
    args = ap.parse_args()
    if args.parallel:
        if args.package != 'jax':
            ap.error('--parallel runs the JAX package (the port runs ranks: '
                     'chip_smoke.py parallel_loose)')
        # before the first import of jax
        os.environ['XLA_FLAGS'] = (
            os.environ.get('XLA_FLAGS', '') + ' --xla_force_host_platform_'
            f'device_count={args.parallel}').strip()

    import numpy as np

    from nice_slam_tpu_torch.eval.ate import evaluate_ate
    from nice_slam_tpu_torch.tools.make_fixture_dataset import write_scene
    from nice_slam_tpu_torch.utils.config import load_config

    cfg = load_config(args.config, base_config(not args.imap))
    if args.sync is not None:
        cfg['sync_method'] = args.sync
    if args.parallel:
        cfg['parallel'] = {'track': 'rays', 'map': args.parallel_map}
    if args.session_precision:
        cfg['matmul_precision'] = args.session_precision
    rows = []
    with tempfile.TemporaryDirectory() as data:
        t0 = time.perf_counter()
        if args.disk:
            cfg = write_scene(cfg, args.disk, data)
        write_s = time.perf_counter() - t0
        for seed in args.seeds:
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory() as out:
                if args.package == 'jax':
                    est, gt = run_jax(cfg, seed, out, args.recon,
                                      nice=not args.imap)
                else:
                    est, gt = run_torch(cfg, seed, args.device, out,
                                        args.recon, nice=not args.imap)
                finite = bool(np.isfinite(est).all())
                recon = (score_mesh(out, cfg) if args.recon and finite
                         else {})
            err = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=-1)
            if finite:
                ate = evaluate_ate(est, gt)
                extra = {'ate_rmse_m':
                         ate['absolute_translational_error.rmse'],
                         'max_frame_err_m': float(err.max())}
            else:
                bad = ~np.isfinite(est).reshape(len(est), -1).all(axis=1)
                extra = {'first_non_finite_frame': int(np.argmax(bad)),
                         'max_frame_err_m_before': float(
                             err[:int(np.argmax(bad))].max(initial=0.0))}
            row = {'package': args.package, 'seed': seed,
                   'frames': len(err), 'finite': finite, **extra, **recon,
                   'seconds': time.perf_counter() - t0}
            rows.append(row)
            print(json.dumps(row), flush=True)
    summary = {'package': args.package, 'config': args.config,
               'method': 'imap' if args.imap else 'nice',
               'sync_method': args.sync or 'as loaded', 'seeds': args.seeds,
               'parallel_devices': args.parallel or None,
               'parallel': cfg.get('parallel'),
               'matmul_precision': cfg.get('matmul_precision', 'float32'),
               'disk': args.disk, 'write_s': write_s,
               'all_finite': all(r['finite'] for r in rows)}
    if not summary['all_finite']:
        print(json.dumps(summary))   # no bound from a non-finite seed
        return
    worst_rmse = max(r['ate_rmse_m'] for r in rows)
    worst_max = max(r['max_frame_err_m'] for r in rows)
    summary.update(worst_ate_rmse_m=worst_rmse,
                   worst_max_frame_err_m=worst_max,
                   bound_ate_rmse_m=1.5 * worst_rmse,
                   bound_max_frame_err_m=1.5 * worst_max)
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
