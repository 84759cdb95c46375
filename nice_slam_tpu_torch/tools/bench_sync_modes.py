"""The sync modes side by side on the card: strict against loose (and
free); the port's `scripts/bench_sync_modes.py`.

    python -m nice_slam_tpu_torch.tools.bench_sync_modes [n_frames] \
        [modes...] [--device cuda|cpu]

Runs the same synthetic sequence (default 100 frames, modes `strict
loose`) at Replica-like budgets under each mode through `SlamSystem` and
prints one JSON line per mode: wall seconds, frames per second with the
first calls included, the largest and mean per-frame translation error,
the Horn-aligned ATE RMSE, and the run's `PhaseTimers.summary()`; plus the
card (`device`) and each row kernel's launches over the run (`launches`).

The config is the test suite's small synthetic scene
(`tools/_small_config.small_config`, the copy of tests/util.make_test_cfg)
at 680x1200 with the JAX script's overrides: 200 px x 10 tracking
iterations; mapping every 5 frames, keyframes every 5, a window of 5,
1000 px, 400 iterations first and 60 after, no intermediate meshes; 32 +
16 samples a ray; the final mesh at 128^3; no invariant checks.
`sync_force_free: true`, since the script measures the modes: without it
`free` on one card would run `loose`.  `mode` is the schedule the system
ran, so a `free` row that fell back would say `loose`.

Left out as TPU machinery: the compile cache.  The run's output goes to a
temporary directory.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np

from nice_slam_tpu_torch.engine.slam import SlamSystem, resolve_device
from nice_slam_tpu_torch.eval.ate import evaluate_ate
from nice_slam_tpu_torch.tools._small_config import small_config
from nice_slam_tpu_torch.utils import measure
from nice_slam_tpu_torch.utils.config import deep_update


def mode_config(mode: str, n_frames: int, *, h: int = 680, w: int = 1200,
                update: dict | None = None) -> dict:
    """The small synthetic scene at h x w under `mode` with the script's
    budgets, then `update` laid over it."""
    cfg = small_config(n_frames=n_frames, h=h, w=w)
    cfg['sync_method'] = mode
    cfg['sync_force_free'] = True
    cfg['debug'] = {}
    cfg['synthetic']['n_frames'] = n_frames
    cfg['meshing']['resolution'] = 128
    cfg['tracking'].update(pixels=200, iters=10)
    cfg['mapping'].update(every_frame=5, keyframe_every=5,
                          mapping_window_size=5, pixels=1000,
                          iters_first=400, iters=60,
                          mesh_freq=100000)
    cfg['rendering'].update(N_samples=32, N_surface=16)
    deep_update(cfg, update or {})
    return cfg


def run_mode(mode: str, n_frames: int, device, **sizes) -> dict:
    """One run under `mode`; the JSON line's object."""
    dev = resolve_device(device)
    measure.reset_launch_counts()
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        slam = SlamSystem(mode_config(mode, n_frames, **sizes), nice=True,
                          device=dev, output=out, verbose=False)
        slam.run()
        measure.sync(dev)
        wall = time.perf_counter() - t0
    t_err = np.linalg.norm(
        slam.estimate_c2w[:, :3, 3] - slam.gt_c2w[:, :3, 3], axis=-1)
    ate = evaluate_ate(slam.estimate_c2w, slam.gt_c2w)
    return {
        'mode': slam.sync_method,
        'wall_s': wall,
        'fps_incl_compiles': n_frames / wall,
        'max_terr_m': float(t_err.max()),
        'mean_terr_m': float(t_err.mean()),
        'ate_rmse_m': float(ate['absolute_translational_error.rmse']),
        **slam.timers.summary(),
        'device': measure.card(dev),
        'launches': measure.launch_counts(),
    }


def main(n_frames: int = 100, modes=('strict', 'loose'), device=None,
         **sizes) -> list:
    """Run each mode and print its line; returns the lines' objects.
    `sizes` (h, w, and `update`, a config laid over the script's) exist
    for the CPU tests; the defaults are the JAX script's."""
    rows = []
    for mode in modes:
        rows.append(run_mode(mode, n_frames, device, **sizes))
        print(json.dumps(rows[-1]), flush=True)
    return rows


def cli(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description='strict against loose (and free) on the same synthetic '
        'sequence; one JSON line per mode.')
    ap.add_argument('args', nargs='*', metavar='[n_frames] [modes...]',
                    help='frames (default 100), then modes (default strict '
                    'loose)')
    ap.add_argument('--device', default=None, help='cuda (default) or cpu')
    ns = ap.parse_args(argv)
    n = int(ns.args[0]) if ns.args and ns.args[0].isdigit() else 100
    modes = [a for a in ns.args if not a.isdigit()] or ['strict', 'loose']
    bad = set(modes) - {'strict', 'loose', 'free'}
    if bad:
        ap.error(f'unknown modes {sorted(bad)}')
    main(n, modes, ns.device)


if __name__ == '__main__':
    cli()
