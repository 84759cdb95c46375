"""Cull a mesh to the part the sequence's cameras see: the faces with a
vertex inside some frame's image are kept, the rest dropped, the unused
vertices removed; the port's counterpart of `tools/cull_mesh.py` (it
prepares a ground-truth mesh for a fair reconstruction score).

    python -m nice_slam_tpu_torch.tools.cull_mesh configs/Replica/room0.yaml \
        --input_mesh gt.ply [--output_mesh gt_culled.ply]

The cameras are the ground-truth poses of the config's dataset (its
`data.input_folder`).  Runs on the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('config', type=str)
    parser.add_argument('--input_mesh', type=str, required=True)
    parser.add_argument('--output_mesh', type=str, default=None)
    args = parser.parse_args(argv)

    from nice_slam_tpu_torch.io.datasets import get_dataset
    from nice_slam_tpu_torch.mesh.mesher import load_ply, save_ply
    from nice_slam_tpu_torch.utils.config import (
        intrinsics_from_cfg, load_config)

    cfg = load_config(args.config, 'configs/nice_slam.yaml')
    intr = intrinsics_from_cfg(cfg)
    ds = get_dataset(cfg)
    verts, tris = load_ply(args.input_mesh)

    seen = np.zeros((len(verts),), dtype=bool)
    homo = np.concatenate([verts, np.ones((len(verts), 1))], axis=1)
    for i in range(len(ds)):
        c2w = ds.poses[i].copy()
        c2w[:3, 3] *= ds.scale
        w2c = np.linalg.inv(c2w)
        cam = (homo @ w2c.T)[:, :3]
        z = cam[:, 2] + 1e-5
        u = (intr.fx * (-cam[:, 0]) + intr.cx * z) / z
        v = (intr.fy * cam[:, 1] + intr.cy * z) / z
        seen |= (u > 0) & (u < intr.W) & (v > 0) & (v < intr.H) & (z < 0)

    keep = seen[tris].any(axis=1)
    tris = tris[keep]
    used = np.unique(tris)
    remap = np.full((len(verts),), -1, dtype=np.int64)
    remap[used] = np.arange(len(used))
    out = args.output_mesh or args.input_mesh.replace('.ply', '_culled.ply')
    save_ply(out, verts[used], remap[tris].astype(np.int32))
    print(f'culled mesh saved to {out} '
          f'({keep.sum()}/{len(keep)} faces kept)')


if __name__ == '__main__':
    main()
