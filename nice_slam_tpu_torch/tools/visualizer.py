"""Offline replay of a run: the estimated trajectory over the
reconstruction, as an image sequence; the port's counterpart of
`tools/visualizer.py`.

Each replayed pose (every `--stride`-th frame up to the newest
checkpoint's mapped frame) gives one row of tiles in
`<output>/replay/%05d.jpg`: the color that `render_image` renders from
the checkpoint's map at 320 pixels wide (on the card, through the port's
kernels), the newest mesh's depth (mesh/native.rasterize_depth), and the
trajectory so far in x-z.  `--no-rgb` skips the volume renders, the
expensive part; `--save_video` also writes `<output>/replay.mp4` when
`ffmpeg` is on PATH.  The images are utils/draw.py's (no matplotlib).

The matmul precision of the renders: the JAX tool builds its model outside
a SlamSystem and never sets `jax_default_matmul_precision`, so on a TPU
its products take the matrix unit's default, one bfloat16 pass, whatever
the config's `matmul_precision` says.  This tool follows it: the rays at
'bfloat16', the decoders at `model.decoder_matmul_precision` or else
'bfloat16' (the fused kernel's one-pass mode on the card).

    python -m nice_slam_tpu_torch.tools.visualizer configs/Replica/room0.yaml \
        [--output DIR] [--stride 10] [--save_video] [--no-rgb] [--device cpu]

Runs on CUDA unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess

import numpy as np
import torch

REPLAY_W = 320


# the JAX tool's session precision: never set, the TPU's default
SESSION_PRECISION = 'bfloat16'


def load_scene(cfg: dict, state: dict, device):
    """(decoders, grids, model) of a NICE checkpoint, the model with the
    fused decoders (as the mesher and the panels render) at the JAX tool's
    precision (`SESSION_PRECISION`; the module note)."""
    from nice_slam_tpu_torch.models.decoders import init_nice_decoders
    from nice_slam_tpu_torch.models.grids import static_grid_shapes
    from nice_slam_tpu_torch.render.renderer import (
        SceneModel, with_fused_eval)
    from nice_slam_tpu_torch.utils import config as cfgutil
    dcfg = cfgutil.decoder_config_from_cfg(
        {**cfg, 'matmul_precision': SESSION_PRECISION})
    gcfg = cfgutil.grid_config_from_cfg(cfg)
    decoders = init_nice_decoders(dcfg, generator=None, device='cpu')
    for name, sd in state['decoders'].items():
        decoders[name].load_state_dict(
            {k: torch.as_tensor(v) for k, v in sd.items()})
    grids = {k: torch.as_tensor(v).reshape(-1, v.shape[-1]).to(device)
             for k, v in state['grids'].items()}
    model = with_fused_eval(SceneModel(
        decoder=dcfg, bound=torch.tensor(gcfg.bound_np, device=device),
        coarse_bound=torch.tensor(gcfg.coarse_bound_np, device=device),
        grid_shapes=static_grid_shapes(gcfg),
        matmul_precision=SESSION_PRECISION))
    return decoders.to(device), grids, model


def replay(cfg: dict, output: str, *, stride: int = 10, rgb: bool = True,
           device=None) -> list[str]:
    """Write the replay frames of the run in `output`; returns their
    paths."""
    from nice_slam_tpu_torch.engine.slam import resolve_device
    from nice_slam_tpu_torch.mesh.mesher import load_ply
    from nice_slam_tpu_torch.mesh.native import rasterize_depth
    from nice_slam_tpu_torch.render.renderer import render_image
    from nice_slam_tpu_torch.utils import draw
    from nice_slam_tpu_torch.utils.ckpt import (
        latest_checkpoint, load_checkpoint)
    from nice_slam_tpu_torch.utils.config import (
        intrinsics_from_cfg, render_config_from_cfg)

    device = resolve_device(device)
    intr = intrinsics_from_cfg(cfg)
    ckpt = latest_checkpoint(os.path.join(output, 'ckpts'))
    if ckpt is None:
        raise SystemExit(f'no checkpoint under {output}/ckpts')
    state = load_checkpoint(ckpt)
    n = int(state['mapping_idx']) + 1
    est = np.asarray(state['estimate_c2w'][:n])
    mesh_dir = os.path.join(output, 'mesh')
    meshes = sorted(f for f in os.listdir(mesh_dir) if f.endswith('.ply')) \
        if os.path.isdir(mesh_dir) else []
    if not meshes:
        raise SystemExit(f'no mesh under {output}/mesh')
    verts, tris = load_ply(os.path.join(mesh_dir, meshes[-1]))

    renderer = None
    if rgb:
        decoders, grids, model = load_scene(cfg, state, device)
        rcfg = render_config_from_cfg(cfg)
        rintr = intr.scaled_to(
            max(int(intr.H * REPLAY_W / intr.W) // 2 * 2, 2), REPLAY_W)

        def renderer(c2w):
            _, _, color = render_image(
                decoders, grids, torch.as_tensor(c2w, dtype=torch.float32,
                                                 device=device),
                rintr, stage='color', model=model, rcfg=rcfg)
            return draw.rgb_bytes(color.cpu().numpy())

    frames_dir = os.path.join(output, 'replay')
    os.makedirs(frames_dir, exist_ok=True)
    s = REPLAY_W / intr.W
    h, w = int(intr.H * s), REPLAY_W
    # the camera looks along -z with y up; the rasterizer's looks along
    # +z: flip the pose's y and z axes
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    paths = []
    for k, i in enumerate(range(0, n, stride)):
        c2w = est[i].astype(np.float64)
        d = rasterize_depth(verts, tris,
                            np.linalg.inv(c2w @ flip).astype(np.float32),
                            intr.fx * s, intr.fy * s, intr.cx * s,
                            intr.cy * s, h, w)
        tiles, titles = [], []
        if renderer is not None:
            tiles.append(renderer(c2w))
            titles.append(f'rendered color @ frame {i}')
        tiles.append(draw.colormap(d, float(d.min()), float(d.max())))
        titles.append(f'mesh depth @ frame {i}')
        tiles.append(draw.plot([
            {'xy': est[:i + 1][:, [0, 2], 3], 'color': 'b'},
            {'xy': est[i:i + 1][:, [0, 2], 3], 'color': 'r', 'kind': 'o'}],
            h, w))
        titles.append('trajectory (x-z)')
        paths.append(draw.save(os.path.join(frames_dir, f'{k:05d}.jpg'),
                               draw.compose(tiles, titles, len(tiles))))
    return paths


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('config', type=str)
    parser.add_argument('--output', type=str, default=None)
    parser.add_argument('--stride', type=int, default=10)
    parser.add_argument('--save_video', action='store_true')
    parser.add_argument('--no-rgb', dest='rgb', action='store_false',
                        help='skip the volume-rendered color tiles')
    parser.add_argument('--device', type=str, default=None,
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)

    from nice_slam_tpu_torch.utils.config import load_config
    cfg = load_config(args.config, 'configs/nice_slam.yaml')
    output = args.output or cfg['data']['output']
    paths = replay(cfg, output, stride=args.stride, rgb=args.rgb,
                   device=args.device)
    frames_dir = os.path.join(output, 'replay')
    print(f'{len(paths)} replay frames in {frames_dir}')
    if args.save_video and shutil.which('ffmpeg'):
        out_mp4 = os.path.join(output, 'replay.mp4')
        subprocess.run(['ffmpeg', '-y', '-framerate', '10', '-i',
                        os.path.join(frames_dir, '%05d.jpg'), '-c:v',
                        'libx264', '-pix_fmt', 'yuv420p', out_mp4],
                       check=False, capture_output=True)
        print(f'video: {out_mp4}')


if __name__ == '__main__':
    main()
