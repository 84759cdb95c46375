"""The tracker's and the mapper's real calls at the Replica budget, with
the expanded volume layout and with the direct one, on the card; the
port's `scripts/profile_steps.py`.

    python -m nice_slam_tpu_torch.tools.profile_steps [--device cuda|cpu]

At bench.py's workload (`nice_slam_tpu_torch.bench`: room0's bound, a
680x1200 noise frame, random volumes and decoders from seed 0): a tracked
frame of 200 px x 10 iterations (`bench.run_track`, the mean of 20 frames
launched back to back) and a mapping call of 1000 px x 60 iterations over
a window of 5 (`bench.run_map`, the mean of 5 calls, each from a fresh
copy of the state made outside the timed window), each after one untimed
call, then the strict schedule's frames a second,
1 / (frame s + call s / 5).

Two layouts of the volumes: `expanded`, the port's (each point gathers one
corner-expanded row, ops/trilinear.ExpandedGrid; the tracker samples the
volumes expanded once for the color stage, the mapper expands them in
every iteration), and `baseline`, the JAX script's name for the direct
layout (each point gathers its 8 corner rows from the flat volumes).  The
JAX package switches with `SceneModel(expanded=False)`; the port's
`SceneModel` has no such field, so `direct_layout()` makes the tracker's
and the mapper's `prepare_grids` hand the flat volumes through, and
`sample_grid_feature` then takes the direct path.  It restores both on
exit.

Prints the JAX script's three lines per layout, then one JSON line of the
same numbers with the card (`device`) and each row kernel's launches over
both layouts' calls (`launches`; the direct layout launches none).

Left out as TPU machinery: the compile cache.  TF32 stays off, as in
`SlamSystem`.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import torch

from nice_slam_tpu_torch import bench
from nice_slam_tpu_torch.engine import mapper as M
from nice_slam_tpu_torch.engine import tracker as T
from nice_slam_tpu_torch.engine.slam import resolve_device
from nice_slam_tpu_torch.utils import measure


@contextlib.contextmanager
def direct_layout():
    """The tracker and the mapper sample the flat volumes: their
    `prepare_grids` returns the volumes as given."""
    saved = T.prepare_grids, M.prepare_grids
    T.prepare_grids = M.prepare_grids = lambda grids, *_, **__: grids
    try:
        yield
    finally:
        T.prepare_grids, M.prepare_grids = saved


def time_layout(wl, expanded: bool, gen, device, *, track_frames: int,
                map_calls: int) -> dict:
    """Mean s of a tracked frame and of a mapping call in one layout."""
    tg = bench.track_grids(wl) if expanded else wl.grids
    layout = contextlib.nullcontext() if expanded else direct_layout()
    with layout:
        bench.run_track(wl, tg, generator=gen)
        _, track_s = measure.wall_s(
            lambda: [bench.run_track(wl, tg, generator=gen)
                     for _ in range(track_frames)], device)
        bench.run_map(wl, bench.map_state(wl), generator=gen)
        map_s = 0.0
        for _ in range(map_calls):
            state = bench.map_state(wl)
            map_s += measure.wall_s(
                lambda: bench.run_map(wl, state, generator=gen), device)[1]
    return {'track_s': track_s / track_frames, 'map_s': map_s / map_calls}


def main(device=None, *, h: int = 680, w: int = 1200, track_frames: int = 20,
         map_calls: int = 5, map_iters: int = 60) -> dict:
    """Time both layouts; prints the JAX script's lines and returns the
    JSON line's object.  The keyword sizes exist for the CPU tests and the
    chip smoke test; the defaults are the JAX script's."""
    dev = resolve_device(device)
    measure.true_f32()
    measure.build_kernels(dev)
    wl = bench.workload(dev, h=h, w=w, map_iters=map_iters)
    gen = torch.Generator(device=dev).manual_seed(0)
    win = wl.mcfg.window_size
    row = {'metric': 'profile_steps', 'track': [wl.tcfg.pixels,
                                                wl.tcfg.iters],
           'map': [wl.mcfg.pixels, map_iters, win]}
    measure.reset_launch_counts()
    for tag, expanded in (('baseline', False), ('expanded', True)):
        t = time_layout(wl, expanded, gen, dev, track_frames=track_frames,
                        map_calls=map_calls)
        tms, mms = t['track_s'] * 1e3, t['map_s'] * 1e3
        fps = 1.0 / (t['track_s'] + t['map_s'] / win)
        print(f'[{tag}] track frame ({wl.tcfg.pixels}px x {wl.tcfg.iters} '
              f'iters): {tms:7.2f} ms', flush=True)
        print(f'[{tag}] map call ({wl.mcfg.pixels}px x {map_iters} iters, '
              f'window {win}): {mms:7.2f} ms  '
              f'({map_iters / t["map_s"]:.1f} iters/s)', flush=True)
        print(f'[{tag}] e2e strict-schedule fps: {fps:.2f}', flush=True)
        row[tag] = {'track_ms': tms, 'map_ms': mms,
                    'map_iters_per_s': map_iters / t['map_s'],
                    'strict_fps': fps}
    row.update(device=measure.card(dev), launches=measure.launch_counts())
    return row


def cli(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="The tracker's and the mapper's calls at the Replica "
        'budget in the expanded and the direct volume layout.')
    ap.add_argument('--device', default=None, help='cuda (default) or cpu')
    args = ap.parse_args(argv)
    print(json.dumps(main(args.device)), flush=True)


if __name__ == '__main__':
    cli()
