"""Write the analytic scene to disk in a real dataset's on-disk format,
plus a ready-to-run scene YAML; the port's own copy of
`tools/make_fixture_dataset.py`, writing with the port's codecs
(io/codecs.py, io/exr.py) so that it runs where no image library is
installed.

The formats: Replica `results/frame*.jpg` + `depth*.png` + `traj.txt`;
ScanNet `frames/{color,depth,pose}` (optionally one frame with an all -inf
pose, ScanNet's untracked frames); TUM RGB-D `rgb.txt` / `depth.txt` /
`groundtruth.txt` with offset timestamps to associate and one unmatched
groundtruth row; CoFusion `colour/*.png` + `depth_noise/*.exr`; Azure
`color/`, `depth/` and `scene/trajectory.log`.  Color is JPEG at quality 97
(PNG for CoFusion), depth uint16 PNG at the dataset's `png_depth_scale`.

    python -m nice_slam_tpu_torch.tools.make_fixture_dataset \\
        <replica|scannet|tumrgbd|cofusion|azure> <outdir> \\
        [--frames N] [--height H] [--width W] [--scannet_nan_frame I]

Then:  python -m nice_slam_tpu_torch <outdir>/config.yaml [--device cpu]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import copy
import os

import numpy as np

from nice_slam_tpu_torch.io import codecs
from nice_slam_tpu_torch.io.datasets import (
    SyntheticBox, _flip_yz)
from nice_slam_tpu_torch.io.exr import write_exr

# quantization scales per dataset (the shipped configs')
DEPTH_SCALE = {'replica': 6553.5, 'scannet': 1000.0, 'tumrgbd': 5000.0,
               'azure': 1000.0, 'cofusion': 1.0}
BOX = np.array([[-2.0, 2.0], [-1.6, 1.6], [-2.0, 2.0]])


def make_frames(n, h, w, fx, fy, cx, cy, noise=0.003, step=0.02, *,
                box=BOX, radius=0.3):
    """[(color, depth, c2w)] of the analytic scene: OpenGL-convention
    poses and their renders, one frame a CPU core at a time (the renderer
    releases the interpreter lock).

    `noise` is the multiplicative depth-noise sigma.  Real RGB-D sensors
    are noisy and the noise matters: a noiseless depth image lets the
    occupancy fit drive logits into sigmoid saturation, and the map dies.
    """
    cfg = {'dataset': 'synthetic', 'cam': {
        'H': h, 'W': w, 'fx': fx, 'fy': fy, 'cx': cx, 'cy': cy},
        'synthetic': {'n_frames': n, 'box': np.asarray(box).tolist(),
                      'radius': radius, 'noise': noise, 'step': step}}
    ds = SyntheticBox(cfg, None, 1.0)

    def frame(i):
        _, color, depth, _ = ds[i]
        return color, depth, ds.poses[i].copy()

    with concurrent.futures.ThreadPoolExecutor(os.cpu_count()) as pool:
        return list(pool.map(frame, range(n)))


def _color_u8(color):
    return (color * 255).astype(np.uint8)


def _write_color_jpg(path, color):
    codecs.write_jpeg(path, _color_u8(color), quality=97)


def _write_color_png(path, color):
    codecs.write_png(path, _color_u8(color))


def _write_depth_png(path, depth, scale):
    codecs.write_png(path, np.round(depth * scale).astype(np.uint16))


def _write_depth_exr(path, depth):
    write_exr(path, {'Y': depth.astype(np.float32)}, compression='zip')


def _quat_from_rot(r):
    """Rotation matrix -> (qx, qy, qz, qw), Shepperd."""
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return ((r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
                (r[1, 0] - r[0, 1]) / s, 0.25 * s)
    i = int(np.argmax(np.diag(r)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(r[i, i] - r[j, j] - r[k, k] + 1.0) * 2
    q = [0.0, 0.0, 0.0, (r[k, j] - r[j, k]) / s]
    q[i] = 0.25 * s
    q[j] = (r[j, i] + r[i, j]) / s
    q[k] = (r[k, i] + r[i, k]) / s
    return q[0], q[1], q[2], q[3]


def write_dataset(kind, out, frames, h, w, fx, fy, cx, cy,
                  scannet_nan_frame: int | None = None,
                  color_upscale: int = 1):
    """The frames in `kind`'s on-disk format under `out`.  ScanNet only:
    `scannet_nan_frame` gets an all -inf pose (ScanNet's untracked frames),
    and `color_upscale` > 1 writes color that many times the depth's size
    (real ScanNet: 1296x968 color, 640x480 depth)."""
    os.makedirs(out, exist_ok=True)
    scale = DEPTH_SCALE[kind]

    if kind == 'replica':
        os.makedirs(f'{out}/results', exist_ok=True)
        with open(f'{out}/traj.txt', 'w') as f:
            for i, (color, depth, pose) in enumerate(frames):
                _write_color_jpg(f'{out}/results/frame{i:06d}.jpg', color)
                _write_depth_png(f'{out}/results/depth{i:06d}.png', depth,
                                 scale)
                # traj.txt stores the pre-flip (CV-convention) matrix
                f.write(' '.join(f'{v:.9f}'
                                 for v in _flip_yz(pose).reshape(-1)) + '\n')

    elif kind == 'scannet':
        for sub in ('color', 'depth', 'pose'):
            os.makedirs(f'{out}/frames/{sub}', exist_ok=True)
        for i, (color, depth, pose) in enumerate(frames):
            if color_upscale > 1:
                color = np.repeat(np.repeat(color, color_upscale, axis=0),
                                  color_upscale, axis=1)
            _write_color_jpg(f'{out}/frames/color/{i}.jpg', color)
            _write_depth_png(f'{out}/frames/depth/{i}.png', depth, scale)
            m = _flip_yz(pose)
            if i == scannet_nan_frame:
                m = np.full((4, 4), -np.inf)  # ScanNet's untracked frames
            np.savetxt(f'{out}/frames/pose/{i}.txt', m)

    elif kind == 'tumrgbd':
        os.makedirs(f'{out}/rgb', exist_ok=True)
        os.makedirs(f'{out}/depth', exist_ok=True)
        t0 = 1305031100.0  # TUM-era epoch timestamps
        frgb = open(f'{out}/rgb.txt', 'w')
        fdep = open(f'{out}/depth.txt', 'w')
        fgt = open(f'{out}/groundtruth.txt', 'w')
        for f in (frgb, fdep, fgt):
            f.write('# fixture sequence\n# file: synthetic\n# header\n')
        # np.loadtxt(skiprows=1) on groundtruth: keep exactly the comment
        # structure the loader relies on (comments start with #)
        for i, (color, depth, pose) in enumerate(frames):
            t = t0 + i / 30.0
            _write_color_jpg(f'{out}/rgb/{t:.6f}.jpg', color)
            _write_depth_png(f'{out}/depth/{t + 0.011:.6f}.png', depth,
                             scale)
            frgb.write(f'{t:.6f} rgb/{t:.6f}.jpg\n')
            fdep.write(f'{t + 0.011:.6f} depth/{t + 0.011:.6f}.png\n')
            m = _flip_yz(pose)   # CV-convention groundtruth
            qx, qy, qz, qw = _quat_from_rot(m[:3, :3])
            tx, ty, tz = m[:3, 3]
            # groundtruth at a slightly offset timestamp (associated)
            fgt.write(f'{t + 0.004:.6f} {tx:.6f} {ty:.6f} {tz:.6f} '
                      f'{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}\n')
        # an extra unmatched groundtruth row the association must skip
        fgt.write(f'{t0 - 5.0:.6f} 0 0 0 0 0 0 1\n')
        for f in (frgb, fdep, fgt):
            f.close()

    elif kind == 'cofusion':
        os.makedirs(f'{out}/colour', exist_ok=True)
        os.makedirs(f'{out}/depth_noise', exist_ok=True)
        for i, (color, depth, pose) in enumerate(frames):
            _write_color_png(f'{out}/colour/Color{i:04d}.png', color)
            _write_depth_exr(f'{out}/depth_noise/Depth{i:04d}.exr', depth)

    elif kind == 'azure':
        os.makedirs(f'{out}/color', exist_ok=True)
        os.makedirs(f'{out}/depth', exist_ok=True)
        os.makedirs(f'{out}/scene', exist_ok=True)
        with open(f'{out}/scene/trajectory.log', 'w') as f:
            for i, (color, depth, pose) in enumerate(frames):
                _write_color_jpg(f'{out}/color/{i:05d}.jpg', color)
                _write_depth_png(f'{out}/depth/{i:05d}.png', depth, scale)
                f.write(f'{i} {i} {i + 1}\n')
                for row in _flip_yz(pose):
                    f.write(' '.join(f'{v:.9f}' for v in row) + '\n')
    else:
        raise ValueError(f'unknown dataset kind {kind}')


def write_scene(cfg: dict, kind: str, out: str) -> dict:
    """The analytic scene of a `synthetic` config (its `synthetic` section,
    at its camera) written under `out` in `kind`'s format.  Returns the
    config that reads those files back: `dataset` = kind,
    `data.input_folder` = out, `cam.png_depth_scale` = the format's; the
    `synthetic` section stays, for scoring a mesh against the scene.  The
    Replica, ScanNet and Azure loaders give back the scene's world frame;
    TUM rebases it on the first pose."""
    cam, syn = cfg['cam'], cfg.get('synthetic', {})
    frames = make_frames(
        int(syn.get('n_frames', 40)), cam['H'], cam['W'], cam['fx'],
        cam['fy'], cam['cx'], cam['cy'], noise=float(syn.get('noise', 0.003)),
        step=float(syn.get('step', 0.02)),
        box=np.array(syn.get('box', [[-3, 3], [-2.5, 2.5], [-2, 2]]),
                     dtype=np.float64),
        radius=float(syn.get('radius', 0.8)))
    write_dataset(kind, out, frames, cam['H'], cam['W'], cam['fx'],
                  cam['fy'], cam['cx'], cam['cy'])
    cfg = copy.deepcopy(cfg)
    cfg['dataset'] = kind
    cfg.setdefault('data', {})['input_folder'] = out
    cfg['cam']['png_depth_scale'] = DEPTH_SCALE[kind]
    return cfg


def effective_bound(kind, frames):
    """Scene bound in the frame the LOADER outputs.

    TUM rebases the first (CV-convention) pose to identity before the
    OpenGL flip, which maps world points X -> D (X - t0) with
    D = diag(1,-1,-1) when the first rotation is identity — an axis-aligned
    transform of the box.  Other loaders reproduce the original world.
    """
    pad = 0.4
    b = BOX.copy()
    if kind == 'tumrgbd':
        t0 = frames[0][2][:3, 3]
        shifted = b - t0[:, None]
        b = np.stack([shifted[0], -shifted[1][::-1], -shifted[2][::-1]])
    return (b + np.array([-pad, pad])).tolist()


def write_config(kind, out, frames, h, w, fx, fy, cx, cy):
    import yaml
    bound = effective_bound(kind, frames)
    cfg = {
        'dataset': kind,
        'coarse': True,
        'sync_method': 'strict',
        'scale': 1,
        'verbose': True,
        'occupancy': True,
        'grid_len': {'coarse': 2.0, 'middle': 0.32, 'fine': 0.16,
                     'color': 0.16, 'bound_divisible': 0.32},
        'cam': {'H': h, 'W': w, 'fx': fx, 'fy': fy, 'cx': cx, 'cy': cy,
                'png_depth_scale': DEPTH_SCALE[kind], 'crop_edge': 0},
        'rendering': {'N_samples': 32, 'N_surface': 16, 'N_importance': 0,
                      'lindisp': False, 'perturb': 0.0},
        'tracking': {'ignore_edge_W': 8, 'ignore_edge_H': 8,
                     'use_color_in_tracking': True, 'handle_dynamic': True,
                     'vis_freq': 10000, 'vis_inside_freq': 10000,
                     'w_color_loss': 0.5, 'seperate_LR': False,
                     'const_speed_assumption': True, 'var_floor': 1.0e-4,
                     'no_vis_on_first_frame': True, 'gt_camera': False,
                     'lr': 0.002, 'pixels': 200, 'iters': 10, 'device': ''},
        'mapping': {'device': '', 'color_refine': True,
                    'middle_iter_ratio': 0.4, 'fine_iter_ratio': 0.6,
                    'every_frame': 5, 'BA': False, 'BA_cam_lr': 0.001,
                    'fix_fine': False, 'fix_color': False,
                    'train_middle': True,
                    'no_vis_on_first_frame': True,
                    'no_mesh_on_first_frame': True,
                    'no_log_on_first_frame': True,
                    'vis_freq': 10000, 'vis_inside_freq': 10000,
                    'mesh_freq': 100000, 'ckpt_freq': 100000,
                    'keyframe_every': 5, 'mapping_window_size': 5,
                    'w_color_loss': 0.2, 'frustum_feature_selection': True,
                    'keyframe_selection_method': 'overlap',
                    'save_selected_keyframes_info': False,
                    'lr_first_factor': 5, 'lr_factor': 1,
                    'pixels': 1000, 'iters_first': 400, 'iters': 60,
                    'imap_decoders_lr': 0.001,
                    'stage': {
                        'coarse': {'decoders_lr': 0.0, 'coarse_lr': 0.001,
                                   'middle_lr': 0.0, 'fine_lr': 0.0,
                                   'color_lr': 0.0},
                        'middle': {'decoders_lr': 0.0, 'coarse_lr': 0.0,
                                   'middle_lr': 0.1, 'fine_lr': 0.0,
                                   'color_lr': 0.0},
                        'fine': {'decoders_lr': 0.001, 'coarse_lr': 0.0,
                                 'middle_lr': 0.005, 'fine_lr': 0.005,
                                 'color_lr': 0.0},
                        'color': {'decoders_lr': 0.005, 'coarse_lr': 0.0,
                                  'middle_lr': 0.005, 'fine_lr': 0.005,
                                  'color_lr': 0.005}},
                    'bound': bound,
                    'marching_cubes_bound': bound},
        'meshing': {'level_set': 0, 'resolution': 128, 'eval_rec': False,
                    'clean_mesh': True, 'depth_test': False,
                    'mesh_coarse_level': False,
                    'clean_mesh_bound_scale': 1.02,
                    'get_largest_components': False,
                    'color_mesh_extraction_method': 'direct_point_query',
                    'remove_small_geometry_threshold': 0.2},
        'model': {'c_dim': 32, 'coarse_bound_enlarge': 2,
                  'pos_embedding_method': 'fourier'},
        'pretrained_decoders': {},
        'data': {'dim': 3, 'input_folder': out,
                 'output': os.path.join(out, 'output')},
    }
    path = os.path.join(out, 'config.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('kind', choices=list(DEPTH_SCALE))
    ap.add_argument('outdir')
    ap.add_argument('--frames', type=int, default=30)
    ap.add_argument('--height', type=int, default=240)
    ap.add_argument('--width', type=int, default=320)
    ap.add_argument('--scannet_nan_frame', type=int, default=None)
    args = ap.parse_args(argv)

    h, w = args.height, args.width
    fx = fy = 0.5 * w
    cx, cy = 0.5 * w - 0.5, 0.5 * h - 0.5
    frames = make_frames(args.frames, h, w, fx, fy, cx, cy)
    write_dataset(args.kind, args.outdir, frames, h, w, fx, fy, cx, cy,
                  scannet_nan_frame=args.scannet_nan_frame)
    path = write_config(args.kind, args.outdir, frames, h, w, fx, fy, cx, cy)
    print(f'{args.kind} fixture: {args.frames} frames at {w}x{h} under '
          f'{args.outdir}; run: python -m nice_slam_tpu_torch {path}')


if __name__ == '__main__':
    main()
