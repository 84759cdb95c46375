"""Reconstruction metrics of a mesh against a ground-truth mesh; the
port's counterpart of `tools/eval_recon.py`, over `eval/recon.py`.

    python -m nice_slam_tpu_torch.tools.eval_recon \
        --rec_mesh out/mesh/final_mesh_eval_rec.ply --gt_mesh gt/room0.ply \
        [-3d] [-2d] [--n_imgs N] [--view_sampling reference|uniform]

-3d prints accuracy, completion (cm) and the completion ratio (%, within
5 cm) after ICP alignment; -2d the depth L1 over rendered views, whose
'reference' sampling rejects views that see only the points of a
`<gt_mesh>_pc_unseen.npy` beside the ground-truth mesh when that file
exists.  Runs on the CPU.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--rec_mesh', type=str, required=True)
    parser.add_argument('--gt_mesh', type=str, required=True)
    parser.add_argument('-2d', dest='metric_2d', action='store_true')
    parser.add_argument('-3d', dest='metric_3d', action='store_true')
    parser.add_argument('--n_imgs', type=int, default=1000)
    parser.add_argument('--view_sampling', type=str, default='reference',
                        choices=['reference', 'uniform'],
                        help="'reference': origins sampled in the ground "
                             "truth's oriented box, with the unseen-point "
                             'rejection when *_pc_unseen.npy exists next '
                             'to the ground-truth mesh')
    args = parser.parse_args(argv)

    from nice_slam_tpu_torch.eval.recon import calc_2d_metric, calc_3d_metric
    from nice_slam_tpu_torch.mesh.mesher import load_ply

    rec_v, rec_t = load_ply(args.rec_mesh)
    gt_v, gt_t = load_ply(args.gt_mesh)

    if args.metric_3d:
        m = calc_3d_metric(rec_v, rec_t, gt_v, gt_t)
        for k, v in m.items():
            print(f'{k}: {v:.4f}')
    if args.metric_2d:
        import numpy as np
        unseen_path = args.gt_mesh.replace('.ply', '_pc_unseen.npy')
        unseen = np.load(unseen_path) if os.path.isfile(unseen_path) \
            else None
        m = calc_2d_metric(rec_v, rec_t, gt_v, gt_t, n_imgs=args.n_imgs,
                           view_sampling=args.view_sampling,
                           unseen_pts=unseen)
        for k, v in m.items():
            print(f'{k}: {v}')


if __name__ == '__main__':
    main()
