"""iMAP* mapping and tracking throughput of the port at the Replica iMAP
budget, on the card; the port's `scripts/bench_imap.py`.

    python -m nice_slam_tpu_torch.tools.bench_imap [n_map_iters] \
        [--device cuda|cpu]

The budget where the reference spends the most arithmetic per point: one
mapping call of `n_map_iters` (default 100) iterations over 5000 px drawn
from a window of 5 frames with BA (the first pose fixed), global keyframe
selection, 32 + 12 importance samples a ray, density compositing (and so
the free-space regulation), perturb 0, color weight 0.1, the scene at
scale 0.1 (room0's bound, depth in [0.1, 0.3)), the nerf embedding; the
window rendered in passes of at most 4096 rays (`max_rays_per_pass`,
which engine/mapper.py honours: 1000 rays a frame, five passes).  Then
one tracked frame of 5000 px x 50 iterations (cam lr 0.001, color weight
0.5, variance floor 1e-10, no dynamic-pixel rejection, edges of 20 px).
The frames are noise from default_rng(0) at 680x1200 (fx = fy = 600, cx
599.5, cy 339.5), the decoder random from seed 0.  Each is timed as the
best of 3 calls after one untimed first call; the mapping calls each
start from a fresh copy of the decoder, which the port's mapper updates
in place.

Prints the JAX script's two lines, with the first call's seconds where it
gives the compile's, then one JSON line of the same numbers with the card
(`device`) and each row kernel's launches over the run (`launches`: all
0, since the iMAP* path has no kernel of the TPU package's).

Left out as TPU machinery: the fault canary, which ran only on the TPU
(off it the JAX script keeps the 4096-ray passes too), and the compile
cache.  TF32 stays off, as in `SlamSystem`.
"""

from __future__ import annotations

import argparse
import copy
import json

import numpy as np
import torch

from nice_slam_tpu_torch.core.cameras import Intrinsics, tensor_from_c2w
from nice_slam_tpu_torch.engine import mapper as M
from nice_slam_tpu_torch.engine import tracker as T
from nice_slam_tpu_torch.engine.slam import resolve_device
from nice_slam_tpu_torch.models.decoders import (
    DecoderConfig, init_imap_decoder)
from nice_slam_tpu_torch.render.renderer import RenderConfig, SceneModel
from nice_slam_tpu_torch.utils import measure

N_FRAMES = 5          # mapping_window_size
MAP_PIXELS = 5000     # split across the window; tracking draws as many
TRACK_ITERS = 50
SCALE = 0.1
ROOM0_BOUND = [[-1.3, 7.4], [-3.1, 3.2], [-1.7, 2.3]]
MAX_RAYS_PER_PASS = 4096


def frames(h: int, w: int) -> tuple[np.ndarray, np.ndarray]:
    """The window's frames from default_rng(0): colors [5, h, w, 3] in
    [0, 1), depths [5, h, w] in [0.1, 0.3), float32."""
    rng = np.random.default_rng(0)
    colors = rng.random((N_FRAMES, h, w, 3)).astype(np.float32)
    depths = (1.0 + rng.random((N_FRAMES, h, w)) * 2.0).astype(
        np.float32) * np.float32(SCALE)
    return colors, depths


def main(n_map_iters: int = 100, device=None, *, h: int = 680,
         w: int = 1200, pixels: int = MAP_PIXELS,
         track_iters: int = TRACK_ITERS) -> dict:
    """Run the iMAP* bench; prints the two text lines and returns the JSON
    line's object.  `h`, `w`, `pixels` (mapping and tracking alike) and
    `track_iters` exist for the CPU tests; the defaults are the JAX
    script's."""
    dev = resolve_device(device)
    measure.true_f32()
    intr = Intrinsics(H=h, W=w, fx=w / 2, fy=w / 2, cx=(w - 1) / 2,
                      cy=(h - 1) / 2)
    dcfg = DecoderConfig(pos_embedding_method='nerf')
    model = SceneModel(decoder=dcfg, kind='imap', bound=torch.tensor(
        ROOM0_BOUND, dtype=torch.float32, device=dev) * SCALE)
    rcfg = RenderConfig(n_samples=32, n_surface=0, n_importance=12,
                        occupancy=False, perturb=0.0)
    mcfg = M.MapperConfig(pixels=pixels, iters=n_map_iters, ba=True,
                          window_size=N_FRAMES, keyframe_selection='global',
                          w_color_loss=0.1,
                          max_rays_per_pass=MAX_RAYS_PER_PASS)
    gen = torch.Generator().manual_seed(0)
    decoders = torch.nn.ModuleDict({'imap': init_imap_decoder(
        dcfg, generator=gen, device='cpu')}).to(dev)
    colors, depths = (torch.from_numpy(a).to(dev) for a in frames(h, w))
    cams = tensor_from_c2w(torch.eye(4, device=dev)[None].repeat(
        N_FRAMES, 1, 1))
    lr_tab = M.lr_table(mcfg, n_map_iters, 1.0, True, nice=False)
    stage_idx = M.stage_schedule(mcfg, n_map_iters, nice=False)
    cam_mask = torch.ones(N_FRAMES, device=dev)
    cam_mask[0] = 0.0
    draws = torch.Generator(device=dev).manual_seed(0)

    def run_map(decs):
        return M.map_step(
            decs, {}, cams, trainable=('imap',), masks=None,
            cam_mask=cam_mask, lr_tab=lr_tab, stage_idx=stage_idx,
            colors=colors, depths=depths, model=model, rcfg=rcfg, mcfg=mcfg,
            intr=intr, pix_per_frame=pixels // N_FRAMES,
            generator=draws)

    tcfg = T.TrackerConfig(pixels=pixels, iters=track_iters,
                           cam_lr=0.001, w_color_loss=0.5, var_floor=1e-10,
                           handle_dynamic=False, separate_lr=False,
                           ignore_edge_w=20, ignore_edge_h=20)

    def run_track():
        return T.track_frame(decoders, {}, colors[0], depths[0], cams[0],
                             model=model, rcfg=rcfg, tcfg=tcfg, intr=intr,
                             generator=draws)

    measure.reset_launch_counts()
    map_first_s = measure.wall_s(lambda: run_map(copy.deepcopy(decoders)),
                                 dev)[1]
    map_s = float('inf')
    for _ in range(3):
        decs = copy.deepcopy(decoders)
        map_s = min(map_s, measure.wall_s(lambda: run_map(decs), dev)[1])
    print(f'iMAP mapping: {n_map_iters} iters in {map_s:.3f} s '
          f'= {n_map_iters / map_s:.1f} iters/s  '
          f'(first call {map_first_s:.0f} s)', flush=True)

    track_first_s = measure.wall_s(run_track, dev)[1]
    track_s = min(measure.wall_s(run_track, dev)[1] for _ in range(3))
    print(f'iMAP tracking: {track_iters} iters x {pixels} px in '
          f'{track_s:.3f} s/frame  (first call {track_first_s:.0f} s)',
          flush=True)
    return {'metric': 'imap_budget', 'map_iters': n_map_iters,
            'map_pixels': pixels,
            'map_s_per_call': map_s, 'map_iters_per_s': n_map_iters / map_s,
            'map_first_call_s': map_first_s, 'track_iters': track_iters,
            'track_pixels': pixels, 'track_s_per_frame': track_s,
            'track_first_call_s': track_first_s,
            'device': measure.card(dev),
            'launches': measure.launch_counts()}


def cli(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description='iMAP* mapping and tracking throughput of the port at '
        'the Replica iMAP budget.')
    ap.add_argument('n_map_iters', nargs='?', type=int, default=100)
    ap.add_argument('--device', default=None, help='cuda (default) or cpu')
    args = ap.parse_args(argv)
    print(json.dumps(main(args.n_map_iters, args.device)), flush=True)


if __name__ == '__main__':
    cli()
