"""Train NICE decoders on the analytic scene and export them as
reference-layout pretrained blobs (coarse.pt, middle_fine.pt); the port's
counterpart of `tools/pretrain_decoders.py`.

The ConvONet blobs cannot be fetched offline, so this makes the same kind
of artifact: decoders trained from scratch on one scene (every decoder
trainable, the middle one included), to be frozen and reused on other
scenes the way the reference consumes its blobs (`fix_fine: true`,
`train_middle: false`).

    python -m nice_slam_tpu_torch.tools.pretrain_decoders [OUTDIR] \
        [--frames N] [--iters-first I] [--seed S] [--device cpu]

OUTDIR defaults to `pretrained`.  Runs on CUDA unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch


def train_decoders(n_frames=12, h=120, w=160, iters_first=800, iters=60,
                   box=None, seed=4, verbose=False, device=None):
    """Run a from-scratch SLAM session on the analytic scene (`box`, its
    bound padded by 0.3; the default box otherwise) with every decoder
    trainable, and return its decoders (an nn.ModuleDict).

    The default seed is 4, not the JAX tool's 0: from the port's seed 0
    the first frame's map diverges on this scene (every decoder gradient
    0, ROADMAP section 3), and the decoders would come back untrained.
    A run whose middle or fine decoder did not move raises."""
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    from nice_slam_tpu_torch.tools._small_config import small_config

    cfg = small_config(n_frames=n_frames, h=h, w=w)
    if box is not None:
        cfg['synthetic']['box'] = box
        bound = (np.asarray(box) + np.array([-0.3, 0.3])).tolist()
        cfg['mapping']['bound'] = bound
        cfg['mapping']['marching_cubes_bound'] = bound
    cfg['mapping'].update(iters_first=iters_first, iters=iters,
                          train_middle=True, fix_fine=False,
                          fix_color=False)
    cfg['verbose'] = verbose
    with tempfile.TemporaryDirectory(prefix='pretrain_') as out:
        slam = SlamSystem(cfg, nice=True, device=device, seed=seed,
                          output=out)
        init = {name: [p.detach().clone() for p in
                       slam.decoders[name].parameters()]
                for name in ('middle', 'fine')}
        slam.run()
    still = [name for name, params in init.items()
             if all(torch.equal(a, b) for a, b in
                    zip(params, slam.decoders[name].parameters()))]
    if still:
        raise RuntimeError(f'the {" and ".join(still)} decoder(s) did not '
                           f'move from their initialization (seed {seed}: '
                           f'the first frame did not map); pick another '
                           f'seed')
    return slam.decoders


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('outdir', nargs='?', default='pretrained')
    ap.add_argument('--frames', type=int, default=12)
    ap.add_argument('--iters-first', type=int, default=800)
    ap.add_argument('--seed', type=int, default=4)
    ap.add_argument('--device', type=str, default=None,
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    from nice_slam_tpu_torch.models.pretrain import save_torch_pretrain
    decoders = train_decoders(n_frames=args.frames,
                              iters_first=args.iters_first, seed=args.seed,
                              verbose=True, device=args.device)
    os.makedirs(args.outdir, exist_ok=True)
    coarse_p = os.path.join(args.outdir, 'coarse.pt')
    mf_p = os.path.join(args.outdir, 'middle_fine.pt')
    save_torch_pretrain(decoders, coarse_p, mf_p)
    print(f'wrote {coarse_p} and {mf_p}')


if __name__ == '__main__':
    main()
