"""The decoder matmul-precision study on the card: float32 against three
and one bfloat16 passes a product; the port's `scripts/bench_precision.py`.

    python -m nice_slam_tpu_torch.tools.bench_precision [n_map_iters] \
        [--orbit-frames N] [--seed S] [--device cuda|cpu]

`DecoderConfig.mm_precision` (`model.decoder_matmul_precision`,
models/precision.py) sets the precision of the decoder stack's products
alone; pose math, sampling, compositing and the losses stay true float32.
For each of float32, BF16_BF16_F32_X3 and bfloat16 (the JAX script's
three) it measures:

  1. iMAP* mapping iterations a second at the Replica iMAP budget, the
     matmul-bound path: one mapping call of `n_map_iters` (default 60)
     iterations at 680x1200 over 5 frames x 1000 px with BA (the first
     pose fixed), global keyframe selection, 32 + 12 samples a ray,
     density compositing, colour weight 0.1, the nerf embedding, the scene
     at scale 0.1 (room0's bound), rays in passes of at most 4096; the
     frames are noise from default_rng(0), the decoder random from
     `--seed`.  One untimed call, then one timed, each from a fresh copy
     of the decoder; the final loss of the timed call.
  2. The short strict NICE orbit (the test suite's synthetic scene at
     120x160, `--orbit-frames` frames, default 8, SlamSystem seed
     `--seed`): its mean per-frame translation error over frames 1 on.

Prints the JAX script's lines (`device:`, one `imap map [...]` line and one
`orbit NICE e2e [...]` line per precision), then one JSON line of the same
numbers with the card (`device`, nvidia-smi's name and power limit), each
row kernel's launches over the run (`launches`: the orbit's) and the peak
device memory (`peak_mem_gb`, None on the CPU).  Left out as TPU
machinery: the compile cache.  TF32 stays off, as in `SlamSystem`.
"""

from __future__ import annotations

import argparse
import copy
import json
import tempfile
import time

import numpy as np
import torch

from nice_slam_tpu_torch.core.cameras import Intrinsics, tensor_from_c2w
from nice_slam_tpu_torch.engine import mapper as M
from nice_slam_tpu_torch.engine.slam import SlamSystem, resolve_device
from nice_slam_tpu_torch.models.decoders import (
    DecoderConfig, init_imap_decoder)
from nice_slam_tpu_torch.render.renderer import RenderConfig, SceneModel
from nice_slam_tpu_torch.tools import bench_imap
from nice_slam_tpu_torch.tools._small_config import small_config
from nice_slam_tpu_torch.utils import measure

PRECISIONS = ('float32', 'BF16_BF16_F32_X3', 'bfloat16')


def imap_setup(n_iters: int, mm_precision: str | None, dev, *,
               h: int = 680, w: int = 1200,
               pixels: int = bench_imap.MAP_PIXELS) -> dict:
    """The JAX script's `time_imap` set-up (bench_precision.py:34-66)."""
    n_frames = bench_imap.N_FRAMES
    intr = Intrinsics(H=h, W=w, fx=w / 2, fy=w / 2, cx=(w - 1) / 2,
                      cy=(h - 1) / 2)
    dcfg = DecoderConfig(pos_embedding_method='nerf',
                         mm_precision=mm_precision)
    model = SceneModel(kind='imap', decoder=dcfg, bound=torch.tensor(
        bench_imap.ROOM0_BOUND, dtype=torch.float32, device=dev)
        * bench_imap.SCALE)
    rcfg = RenderConfig(n_samples=32, n_surface=0, n_importance=12,
                        occupancy=False, perturb=0.0)
    mcfg = M.MapperConfig(pixels=pixels, iters=n_iters, ba=True,
                          window_size=n_frames, keyframe_selection='global',
                          w_color_loss=0.1,
                          max_rays_per_pass=bench_imap.MAX_RAYS_PER_PASS)
    return dict(intr=intr, dcfg=dcfg, model=model, rcfg=rcfg, mcfg=mcfg,
                n_frames=n_frames, pixels=pixels)


def time_imap(n_iters: int, mm_precision: str | None, dev, *, seed: int = 0,
              **sizes) -> tuple[float, float, float]:
    """(iterations a second, the final loss, the first call's s) of one
    mapping call at the Replica iMAP budget under `mm_precision`."""
    s = imap_setup(n_iters, mm_precision, dev, **sizes)
    intr, mcfg, n_frames = s['intr'], s['mcfg'], s['n_frames']
    gen = torch.Generator().manual_seed(seed)
    decoders = torch.nn.ModuleDict({'imap': init_imap_decoder(
        s['dcfg'], generator=gen, device='cpu')}).to(dev)
    colors, depths = (torch.from_numpy(a).to(dev)
                      for a in bench_imap.frames(intr.H, intr.W))
    cams = tensor_from_c2w(torch.eye(4, device=dev)[None].repeat(
        n_frames, 1, 1))
    lr_tab = M.lr_table(mcfg, n_iters, 1.0, True, nice=False)
    stage_idx = M.stage_schedule(mcfg, n_iters, nice=False)
    cam_mask = torch.ones(n_frames, device=dev)
    cam_mask[0] = 0.0
    draws = torch.Generator(device=dev).manual_seed(seed)

    def run():
        return M.map_step(
            copy.deepcopy(decoders), {}, cams.clone(), trainable=('imap',),
            masks=None, cam_mask=cam_mask, lr_tab=lr_tab,
            stage_idx=stage_idx, colors=colors, depths=depths,
            model=s['model'], rcfg=s['rcfg'], mcfg=mcfg, intr=intr,
            pix_per_frame=s['pixels'] // n_frames, generator=draws)

    first_s = measure.wall_s(run, dev)[1]
    (_, losses), dt = measure.wall_s(run, dev)
    return n_iters / dt, float(losses[-1]), first_s


def orbit_config(mm_precision: str | None, n_frames: int = 8, *,
                 h: int = 120, w: int = 160) -> dict:
    """The JAX script's orbit config (bench_precision.py:78-84)."""
    cfg = small_config(n_frames=n_frames, h=h, w=w)
    cfg['model']['decoder_matmul_precision'] = mm_precision
    return cfg


def orbit_ate(mm_precision: str | None, dev, n_frames: int = 8, *,
              seed: int = 0, **sizes) -> float:
    """The short strict NICE orbit; its mean per-frame error (m) over
    frames 1 on."""
    cfg = orbit_config(mm_precision, n_frames, **sizes)
    with tempfile.TemporaryDirectory(prefix='precision_') as out:
        slam = SlamSystem(cfg, nice=True, device=dev, output=out, seed=seed,
                          verbose=False)
        slam.run()
    est = slam.estimate_c2w[:n_frames]
    gt = slam.gt_c2w[:n_frames]
    return float(np.mean(np.linalg.norm(est[1:, :3, 3] - gt[1:, :3, 3],
                                        axis=-1)))


def main(n_iters: int = 60, device=None, *, orbit_frames: int = 8,
         seed: int = 0, orbit_sizes: dict | None = None, **sizes) -> dict:
    """Run the study; prints the JAX script's lines and returns the JSON
    line's object.  `sizes` (h, w, pixels of the iMAP* call) and
    `orbit_sizes` (h, w of the orbit) exist for the CPU tests; the
    defaults are the JAX script's."""
    dev = resolve_device(device)
    measure.true_f32()
    measure.build_kernels(dev)
    print(f'device: {measure.card(dev)}', flush=True)
    measure.reset_launch_counts()
    measure.reset_peak(dev)
    imap = {}
    for prec in PRECISIONS:
        mm = None if prec == 'float32' else prec
        its, loss, first_s = time_imap(n_iters, mm, dev, seed=seed, **sizes)
        imap[prec] = {'iters_per_s': its, 'final_loss': loss,
                      'first_call_s': first_s}
        print(f'imap map [{prec:16s}]: {its:7.1f} iters/s '
              f'(final loss {loss:.4f})', flush=True)
    orbit = {}
    for prec in PRECISIONS:
        mm = None if prec == 'float32' else prec
        t0 = time.perf_counter()
        err = orbit_ate(mm, dev, orbit_frames, seed=seed,
                        **(orbit_sizes or {}))
        orbit[prec] = {'mean_err_m': err,
                       'wall_s': time.perf_counter() - t0}
        print(f'orbit NICE e2e [{prec:16s}]: mean traj err '
              f'{err * 100:.3f} cm', flush=True)
    return {'metric': 'decoder_precision', 'map_iters': n_iters,
            'orbit_frames': orbit_frames, 'seed': seed, 'imap': imap,
            'orbit': orbit, 'device': measure.card(dev),
            'launches': measure.launch_counts(),
            'peak_mem_gb': measure.peak_mem_gb(dev)}


def cli(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description='The decoder matmul-precision study: iMAP* mapping '
        'iterations a second and the NICE orbit error at float32, three '
        'and one bfloat16 passes.')
    ap.add_argument('n_map_iters', nargs='?', type=int, default=60)
    ap.add_argument('--orbit-frames', type=int, default=8)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default=None, help='cuda (default) or cpu')
    args = ap.parse_args(argv)
    print(json.dumps(main(args.n_map_iters, args.device,
                          orbit_frames=args.orbit_frames, seed=args.seed)),
          flush=True)


if __name__ == '__main__':
    cli()
