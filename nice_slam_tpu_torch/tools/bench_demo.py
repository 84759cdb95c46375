"""The whole system at the reference's Demo budget, end to end on the card;
the port's `scripts/bench_demo.py`.

    python -m nice_slam_tpu_torch.tools.bench_demo [n_frames] \
        [--pretrained] [--sync=MODE] [--seed S] [--device cuda|cpu]

The reference's one stated end-to-end number is its Demo run (a
500-frame ScanNet subset that "takes a few minutes").  This runs the
whole system at that budget on `n_frames` (default 500) frames of the
analytic scene at 480x640: tracking 1000 px x 30 iterations (lr 0.0005,
edges of 20 px), mapping 1000 px x 10 iterations every 10 frames over a
window of 10 (400 iterations first), the coarse mapper, keyframes every 50
frames, a 256^3 mesh every 50 frames, a checkpoint every 500 frames and at
the last, under `sync_method: loose` unless `--sync` names another mode.
Under loose and free the mapping cadence is every_frame // 2, every 5
frames (`SlamSystem.map_cadence`).  The last frame is always mapped,
meshed and checkpointed, so a cut run still writes one of each.

`--pretrained` reads `pretrained/coarse.pt` and `middle_fine.pt` in the
reference's pretrained mode: fix_fine, no train_middle, the tracking
variance floor 1e-10.  The default runs from scratch.  `--seed` is
`SlamSystem`'s (the initial volumes and decoders, the pixel draws), 0 by
default as in the JAX script.  A seed draws other initial models in the
two packages.  From scratch, the first-frame map from the port's seed-0
model leaves the fine decoder at its initialization, and the JAX package
does the same from that model; from the JAX package's seed-0 model both
train it (`scripts/port_first_frame_scan.py --demo --volumes`).  The run
then tracks on that map.

The config is the test suite's small synthetic scene
(`tools/_small_config.small_config`, the copy of tests/util.make_test_cfg)
with the JAX script's overrides (`demo_config`).  The kernels are built
before the clock starts, so `value` (the wall seconds of construction and
`run()`) and `fps_incl_compiles` include the first calls only.

Prints one JSON line with the JAX script's keys (`value` the wall seconds,
the largest and mean per-frame translation error, `PhaseTimers.summary()`)
plus the seed, each frame's error (`frame_err_m`, to 0.1 mm), `meshes`
(extractions, beside `mesh_s`) and `s_per_mesh`, the checkpoints written
(`checkpoints`), the mode the system ran (`mode`), the card (`device`),
each row kernel's launches over the run (`launches`) and the peak device
memory (`peak_mem_gb`, None on the CPU).  The run's output goes to a
temporary directory.

Left out as TPU machinery: the compile cache.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from nice_slam_tpu_torch.engine.slam import SlamSystem, resolve_device
from nice_slam_tpu_torch.tools._small_config import small_config
from nice_slam_tpu_torch.utils import measure
from nice_slam_tpu_torch.utils.config import deep_update

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def demo_config(n_frames: int = 500, pretrained: bool = False,
                sync: str = 'loose', *, h: int = 480, w: int = 640,
                update: dict | None = None) -> dict:
    """The JAX script's config (bench_demo.py:39-57) at h x w, then
    `update` laid over it."""
    cfg = small_config(n_frames=n_frames, h=h, w=w)
    cfg['sync_method'] = sync
    cfg['debug'] = {}
    cfg['synthetic']['n_frames'] = n_frames
    cfg['meshing']['resolution'] = 256
    cfg['tracking'].update(pixels=1000, iters=30, lr=0.0005,
                           ignore_edge_W=20, ignore_edge_H=20)
    cfg['mapping'].update(every_frame=10, mesh_freq=50, ckpt_freq=500,
                          keyframe_every=50, mapping_window_size=10,
                          pixels=1000, iters_first=400, iters=10)
    if pretrained:
        cfg['pretrained_decoders'] = {
            'coarse': os.path.join(REPO, 'pretrained', 'coarse.pt'),
            'middle_fine': os.path.join(REPO, 'pretrained',
                                        'middle_fine.pt')}
        cfg['mapping'].update(fix_fine=True, train_middle=False)
        cfg['tracking']['var_floor'] = 1.0e-10
    deep_update(cfg, update or {})
    return cfg


def main(n_frames: int = 500, pretrained: bool = False, sync: str = 'loose',
         device=None, seed: int = 0, **sizes) -> dict:
    """Run the Demo budget; returns the JSON line's object.  `sizes` (h, w,
    and `update`, a config laid over the script's) exist for the CPU
    tests; the defaults are the JAX script's."""
    dev = resolve_device(device)
    cfg = demo_config(n_frames, pretrained, sync, **sizes)
    measure.build_kernels(dev)
    measure.reset_launch_counts()
    measure.reset_peak(dev)
    with tempfile.TemporaryDirectory(prefix='demo_') as out:
        t0 = time.perf_counter()
        slam = SlamSystem(cfg, nice=True, device=dev, seed=seed,
                          output=out, verbose=False)
        slam.run()
        measure.sync(dev)
        total_s = time.perf_counter() - t0
        ckpts = [f for f in os.listdir(os.path.join(out, 'ckpts'))
                 if f.endswith('.ckpt')]
    t_err = np.linalg.norm(
        slam.estimate_c2w[:, :3, 3] - slam.gt_c2w[:, :3, 3], axis=-1)
    summ = slam.timers.summary()
    meshes = len(slam.timers.meshes)
    return {
        'metric': 'demo_500_wall_s',
        'pretrained': pretrained,
        'sync': sync,
        'seed': seed,
        'mode': slam.sync_method,
        'value': total_s,
        'unit': 's',
        'frames': n_frames,
        'fps_incl_compiles': n_frames / total_s,
        'ate_like_max_terr_m': float(t_err.max()),
        'ate_like_mean_terr_m': float(t_err.mean()),
        'frame_err_m': [round(float(e), 4) for e in t_err],
        **summ,
        'meshes': meshes,
        's_per_mesh': summ['mesh_s'] / meshes if meshes else None,
        'checkpoints': len(ckpts),
        'device': measure.card(dev),
        'launches': measure.launch_counts(),
        'peak_mem_gb': measure.peak_mem_gb(dev),
    }


def cli(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description='The whole system at the Demo budget; prints one JSON '
        'line.')
    ap.add_argument('n_frames', nargs='?', type=int, default=500)
    ap.add_argument('--pretrained', action='store_true',
                    help="the repository's pretrained decoders, fix_fine")
    ap.add_argument('--sync', default='loose',
                    choices=('strict', 'loose', 'free'))
    ap.add_argument('--seed', type=int, default=0,
                    help="SlamSystem's seed (default 0)")
    ap.add_argument('--device', default=None, help='cuda (default) or cpu')
    args = ap.parse_args(argv)
    print(json.dumps(main(args.n_frames, args.pretrained, args.sync,
                          args.device, args.seed)), flush=True)


if __name__ == '__main__':
    cli()
