"""Scene YAML for a user's own RGB-D capture; the port's counterpart of
`tools/prep_own_data.py`.  Reads the capture's `intrinsic.json`
(Open3D / Azure Kinect format) and every tenth depth PNG (the port's
decoder), bounds the points they see from an identity pose, and writes a
config that inherits configs/Own/own.yaml.

    python -m nice_slam_tpu_torch.tools.prep_own_data \
        --folder Datasets/MyScene --output_config configs/Own/myscene.yaml \
        [--depth_scale 1000] [--max_depth 8]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--folder', type=str, required=True)
    parser.add_argument('--output_config', type=str, required=True)
    parser.add_argument('--depth_scale', type=float, default=1000.0)
    parser.add_argument('--max_depth', type=float, default=8.0)
    args = parser.parse_args(argv)

    import yaml

    from nice_slam_tpu_torch.io.codecs import read_png

    with open(os.path.join(args.folder, 'intrinsic.json')) as f:
        intr = json.load(f)
    w, h = intr['width'], intr['height']
    mat = np.asarray(intr['intrinsic_matrix']).reshape(3, 3, order='F')
    fx, fy, cx, cy = mat[0, 0], mat[1, 1], mat[0, 2], mat[1, 2]

    lo = np.full(3, np.inf)
    hi = np.full(3, -np.inf)
    depth_files = sorted(
        glob.glob(os.path.join(args.folder, 'depth', '*.png')))[::10]
    if not depth_files:
        raise SystemExit(f'{args.folder}: no depth/*.png')
    for p in depth_files:
        d = read_png(p).astype(np.float64)
        d /= args.depth_scale
        d[d > args.max_depth] = 0
        jj, ii = np.nonzero(d > 0)
        z = d[jj, ii]
        # no poses yet: the points seen from an identity pose, a symmetric
        # envelope around the camera
        x = (ii - cx) / fx * z
        y = -(jj - cy) / fy * z
        pts = np.stack([x, y, -z], axis=-1)
        lo = np.minimum(lo, pts.min(axis=0))
        hi = np.maximum(hi, pts.max(axis=0))
    lo -= 0.5
    hi += 0.5

    cfg = {
        'inherit_from': 'configs/Own/own.yaml',
        'cam': {'H': int(h), 'W': int(w), 'fx': float(fx), 'fy': float(fy),
                'cx': float(cx), 'cy': float(cy),
                'png_depth_scale': args.depth_scale},
        'mapping': {
            'bound': [[float(a), float(b)] for a, b in zip(lo, hi)],
            'marching_cubes_bound':
                [[float(a), float(b)] for a, b in zip(lo, hi)]},
        'data': {'input_folder': args.folder,
                 'output': os.path.join(
                     'output', os.path.basename(args.folder.rstrip('/')))},
    }
    os.makedirs(os.path.dirname(args.output_config) or '.', exist_ok=True)
    with open(args.output_config, 'w') as f:
        yaml.safe_dump(cfg, f, default_flow_style=None)
    print(f'wrote {args.output_config}; bound {lo.round(2)}..{hi.round(2)}')


if __name__ == '__main__':
    main()
