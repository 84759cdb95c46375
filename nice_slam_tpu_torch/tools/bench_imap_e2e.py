"""The iMAP* accuracy soak at the Replica-iMAP budgets, end to end on the
card; the port's `scripts/bench_imap_e2e.py`.

    python -m nice_slam_tpu_torch.tools.bench_imap_e2e [n_frames] [scale] \
        [--device cuda|cpu]

Runs the whole system in iMAP* mode (one hidden-256 MLP, density
compositing, 12 importance samples, the free-space regulation, StepLR) on
`n_frames` (default 40) frames of the analytic scene at 240x320 and the
reference's iMAP budgets: tracking 5000 px x 50 iterations (lr 0.001,
color weight 0.5, no dynamic-pixel rejection); mapping 5000 px x 300
iterations every 5 frames over a window of 5, 1500 iterations first,
keyframes every 5 frames, global keyframe selection, color weight 0.05,
decoder lr 2e-4; 32 + 12 samples a ray, no occupancy.

`scale` (default 0.4) scales the scene: the Fourier embedding assumes the
reference's scaled coordinates (~0.8 units for an 8 m room at its scale
0.1), where the 2 m box lands at 0.4.  `value` is the Horn-aligned ATE
RMSE divided by `scale` (metres of the unscaled scene).

The config is the test suite's small synthetic scene
(`tools/_small_config.small_config`) with the JAX script's overrides
(`imap_config`), `model.decoder_matmul_precision: bfloat16` among them:
the decoder's products run one bfloat16 pass each on the tensor cores,
summed in float32 (models/precision.py).  The kernels are built before
the clock starts.

Prints one JSON line with the JAX script's keys (`value`, the scaled ATE
RMSE, the raw mean per-frame error, `PhaseTimers.summary()`) plus the card
(`device`), each row kernel's launches over the run (`launches`: all 0,
the iMAP* path has no kernel of the TPU package's) and the peak device
memory (`peak_mem_gb`, None on the CPU).  The run's output goes to a
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


def imap_config(n: int = 40, scale: float = 0.4, *, h: int = 240,
                w: int = 320, update: dict | None = None) -> dict:
    """The JAX script's config (bench_imap_e2e.py:35-47) at h x w, then
    `update` laid over it."""
    cfg = small_config(n_frames=n, nice=False, coarse=False, h=h, w=w)
    cfg['synthetic']['n_frames'] = n
    cfg['rendering'].update(N_samples=32, N_surface=0, N_importance=12)
    cfg['occupancy'] = False
    cfg['scale'] = scale
    cfg['tracking'].update(pixels=5000, iters=50, lr=0.001,
                           w_color_loss=0.5, handle_dynamic=False)
    cfg['mapping'].update(pixels=5000, iters=300, iters_first=1500,
                          every_frame=5, keyframe_every=5,
                          mapping_window_size=5,
                          keyframe_selection_method='global',
                          w_color_loss=0.05, imap_decoders_lr=0.0002)
    cfg['model']['decoder_matmul_precision'] = 'bfloat16'
    cfg['debug'] = {}
    deep_update(cfg, update or {})
    return cfg


def main(n: int = 40, scale: float = 0.4, device=None, **sizes) -> dict:
    """Run the soak; returns the JSON line's object.  `sizes` (h, w, and
    `update`, a config laid over the script's) exist for the CPU tests; the
    defaults are the JAX script's."""
    dev = resolve_device(device)
    cfg = imap_config(n, scale, **sizes)
    measure.build_kernels(dev)
    measure.reset_launch_counts()
    measure.reset_peak(dev)
    with tempfile.TemporaryDirectory(prefix='imap_e2e_') as out:
        t0 = time.perf_counter()
        slam = SlamSystem(cfg, nice=False, device=dev, output=out,
                          verbose=False)
        slam.run()
        measure.sync(dev)
        wall = time.perf_counter() - t0
    t_err = np.linalg.norm(
        slam.estimate_c2w[:, :3, 3] - slam.gt_c2w[:, :3, 3], axis=-1)
    ate = evaluate_ate(slam.estimate_c2w, slam.gt_c2w)
    rmse_scaled = float(ate['absolute_translational_error.rmse'])
    return {
        'metric': 'imap_e2e_ate_rmse_m', 'frames': n, 'scale': scale,
        'wall_s': wall,
        'value': rmse_scaled / scale,
        'ate_rmse_scaled_m': rmse_scaled,
        'raw_mean_terr_scaled_m': float(t_err.mean()),
        **slam.timers.summary(),
        'device': measure.card(dev),
        'launches': measure.launch_counts(),
        'peak_mem_gb': measure.peak_mem_gb(dev),
    }


def cli(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description='The iMAP* accuracy soak at the Replica-iMAP budgets; '
        'prints one JSON line.')
    ap.add_argument('n_frames', nargs='?', type=int, default=40)
    ap.add_argument('scale', nargs='?', type=float, default=0.4)
    ap.add_argument('--device', default=None, help='cuda (default) or cpu')
    args = ap.parse_args(argv)
    print(json.dumps(main(args.n_frames, args.scale, args.device)),
          flush=True)


if __name__ == '__main__':
    cli()
