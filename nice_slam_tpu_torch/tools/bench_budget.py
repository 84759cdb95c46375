"""Steady-state throughput of the port at a shipped scene config's budget,
on the card; the port's `scripts/bench_budget.py`.

    python -m nice_slam_tpu_torch.tools.bench_budget \
        [replica|scannet|tum|apartment|CONFIG.yaml] [--device cuda|cpu]

Every parameter (the camera with its crop_edge / crop_size, the grid
lengths, the scene bound, the pixel and iteration budgets, the window,
every_frame) is read from the shipped config through the port's
`utils/config.py`, layered over configs/nice_slam.yaml.  Prints the budget
on stderr, {"scene", "cam", "grid_shapes", "track", "map"} (track =
[pixels, iterations], map = [pixels, iterations, window, every_frame]),
then one JSON line on stdout: `value` = track s + map s / every_frame, the
strict schedule's seconds a frame, beside the tracked frame's and the
mapping call's seconds, plus the card (`device`) and each row kernel's
launches over the timed calls (`launches`).

The workload is `bench.py`'s at the config's budgets: random grids and
decoders from seed 0, a noise frame from default_rng(0) at the cropped
size, the camera [1, 0, 0, 0, 0.5, 0, 0.5], a window of copies of the
frame with BA on, the color decoder (and the fine one unless fix_fine)
trainable.  After one untimed call of each kind (it builds the kernels):
tracking the best of 3 frames, mapping the best of 3 calls, each from a
fresh copy of the state (the port's mapper updates it in place).

NSTPU_MM_PRECISION, when set, is the decoders' matmul precision
(`DecoderConfig.mm_precision`, models/precision.py: e.g. bfloat16, one
bfloat16 pass a product on the tensor cores), as in the JAX script and
its `tum` case (scripts/bench_tum.py); the rest of the step stays true
float32.  Left out as TPU machinery: the compile re-roll salt loop and the
compile cache.  TF32 stays off, as in `SlamSystem`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from nice_slam_tpu_torch import bench
from nice_slam_tpu_torch.engine.slam import resolve_device
from nice_slam_tpu_torch.models import precision
from nice_slam_tpu_torch.utils import config as cfgutil
from nice_slam_tpu_torch.utils import measure

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SCENES = {
    'replica': 'configs/Replica/room0.yaml',
    'scannet': 'configs/ScanNet/scene0000.yaml',
    'tum': 'configs/TUM_RGBD/freiburg1_desk.yaml',
    'apartment': 'configs/Apartment/apartment.yaml',
}
CAM7 = (1.0, 0.0, 0.0, 0.0, 0.5, 0.0, 0.5)


def load(name: str) -> tuple[str, dict]:
    """(the scene's config path, the config over configs/nice_slam.yaml)."""
    scene = SCENES.get(name, name)
    return scene, cfgutil.load_config(
        os.path.join(REPO, scene), os.path.join(REPO,
                                                'configs/nice_slam.yaml'))


def budget_line(scene: str, cfg: dict) -> dict:
    """The stderr line: the budget as the config gives it."""
    from nice_slam_tpu_torch.models.grids import static_grid_shapes
    intr = cfgutil.intrinsics_from_cfg(cfg)
    tcfg = cfgutil.tracker_config_from_cfg(cfg)
    mcfg = cfgutil.mapper_config_from_cfg(cfg)
    shapes = static_grid_shapes(cfgutil.grid_config_from_cfg(cfg))
    return {'scene': scene, 'cam': [intr.H, intr.W],
            'grid_shapes': {k: list(v) for k, v in shapes},
            'track': [tcfg.pixels, tcfg.iters],
            'map': [mcfg.pixels, mcfg.iters, mcfg.window_size,
                    int(cfg['mapping']['every_frame'])]}


def decoder_config(cfg: dict):
    """The config's decoders, their products at NSTPU_MM_PRECISION when
    it is set (a name of models/precision.py; ValueError for another)."""
    dcfg = cfgutil.decoder_config_from_cfg(cfg)
    mm_precision = os.environ.get('NSTPU_MM_PRECISION')
    if mm_precision:
        precision.passes(mm_precision)
        dcfg = dcfg._replace(mm_precision=mm_precision)
    return dcfg


def main(name: str = 'scannet', device=None) -> dict:
    """Run the budget bench of scene `name` (or a config path); returns the
    stdout line's object."""
    dev = resolve_device(device)
    measure.true_f32()
    scene, cfg = load(name)
    print(json.dumps(budget_line(scene, cfg)), file=sys.stderr, flush=True)
    mcfg = cfgutil.mapper_config_from_cfg(cfg)
    every = int(cfg['mapping']['every_frame'])
    wl = bench.make_workload(
        dev, gcfg=cfgutil.grid_config_from_cfg(cfg),
        dcfg=decoder_config(cfg),
        rcfg=cfgutil.render_config_from_cfg(cfg),
        intr=cfgutil.intrinsics_from_cfg(cfg),
        tcfg=cfgutil.tracker_config_from_cfg(cfg), mcfg=mcfg, cam7=CAM7)
    gen = torch.Generator(device=dev).manual_seed(0)
    tg = bench.track_grids(wl)
    bench.run_track(wl, tg, generator=gen)
    bench.run_map(wl, bench.map_state(wl), generator=gen)
    measure.reset_launch_counts()
    track_s = min(measure.wall_s(
        lambda: bench.run_track(wl, tg, generator=gen), dev)[1]
        for _ in range(3))
    map_s = float('inf')
    for _ in range(3):
        state = bench.map_state(wl)
        map_s = min(map_s, measure.wall_s(
            lambda: bench.run_map(wl, state, generator=gen), dev)[1])
    return {
        'metric': f'{name}_budget_s_per_frame',
        'value': track_s + map_s / every,
        'track_s_per_frame': track_s,
        'map_s_per_call': map_s,
        'map_iters_per_s': mcfg.iters / map_s,
        'every_frame': every,
        'scene_config': scene,
        'device': measure.card(dev),
        'launches': measure.launch_counts(),
    }


def cli(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="The port's steady-state s/frame at a shipped config's "
        'budget; prints one JSON line.')
    ap.add_argument('scene', nargs='?', default='scannet',
                    help=f'{" | ".join(SCENES)} or a config path')
    ap.add_argument('--device', default=None, help='cuda (default) or cpu')
    args = ap.parse_args(argv)
    print(json.dumps(main(args.scene, args.device)), flush=True)


if __name__ == '__main__':
    cli()
