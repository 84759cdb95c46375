"""The tracked frame's cost attributed piece by piece, by ablation, on the
card; the port's `scripts/ablate_track_step.py`.

    python -m nice_slam_tpu_torch.tools.ablate_track_step [--device cuda|cpu]

Times the production tracked frame at the Replica budget (200 px x 10
iterations, 32 + 16 samples, the color stage on volumes corner-expanded
once outside the frame) and then the same frame with one piece taken away
at a time:

  full          the production call, `bench.run_track` (`track_frame`)
  fwd_only      the loss alone at each iteration (`tracking_loss` without
                a graph): no gradient, no Adam step
  no_sort       `torch.sort` the identity on its values, as the JAX
                script's `jnp.sort`: the samples merged without the depth
                sort (WRONG math, timing only: `utils/measure.no_sort`)
  no_color      the depth loss alone (`use_color` off: no color decoder
                term)
  pix1000       1000 px instead of 200 (how sublinear is the cost?)
  iters1        one iteration (the frame's fixed cost)

Every case is built here from the port's pieces; nothing in the package
is switched.  The workload is bench.py's (room0's bound, the default
volumes and decoders from seed 0, a 680x1200 noise frame) with the JAX
script's depth (1.5 everywhere) and camera [1, 0, 0, 0, 2, 0, 0.3]; every
case draws its pixels from the same per-iteration draws (seed 0).  Each is
the best of 5 calls after one untimed call.

Prints the JAX script's line per case, then one JSON line of the same
numbers with `full_matches_production` (the `full` case's losses equal, to
the bit, those of one more production call on the same draws, made after
every case and context has run), the card (`device`) and each row
kernel's launches over the run (`launches`).

Left out as TPU machinery: the compile cache.  TF32 stays off, as in
`SlamSystem`.
"""

from __future__ import annotations

import argparse
import json

import torch

from nice_slam_tpu_torch import bench
from nice_slam_tpu_torch.core.sampling import sample_pixels
from nice_slam_tpu_torch.engine import tracker as T
from nice_slam_tpu_torch.engine.slam import resolve_device
from nice_slam_tpu_torch.utils import measure

CAM7 = (1.0, 0.0, 0.0, 0.0, 2.0, 0.0, 0.3)
DEPTH_M = 1.5


def ablation_workload(device, *, h: int = 680, w: int = 1200,
                      map_iters: int = 60) -> bench.Workload:
    """bench.py's workload with the ablation scripts' depth and camera."""
    wl = bench.workload(device, h=h, w=w, map_iters=map_iters)
    return wl._replace(depth=torch.full_like(wl.depth, DEPTH_M),
                       cam7=torch.tensor(CAM7, device=device))


def track_draws(wl: bench.Workload, pixels: int, iters: int, seed: int = 0
                ) -> list:
    """`iters` per-iteration (i, j) pixel draws of `pixels` away from the
    tracker's edges, as `track_frame` draws them."""
    t, intr = wl.tcfg, wl.intr
    gen = torch.Generator(device=wl.cam7.device).manual_seed(seed)
    return [sample_pixels(pixels, t.ignore_edge_h, intr.H - t.ignore_edge_h,
                          t.ignore_edge_w, intr.W - t.ignore_edge_w,
                          generator=gen, device=wl.cam7.device)
            for _ in range(iters)]


def forward_only(wl: bench.Workload, grids: dict, draws) -> torch.Tensor:
    """The tracking loss at the initial pose for each draw: [iters]."""
    with torch.no_grad():
        return torch.stack([T.tracking_loss(
            wl.cam7, wl.decoders, grids, wl.color, wl.depth, i, j,
            model=wl.model, rcfg=wl.rcfg, tcfg=wl.tcfg, intr=wl.intr)
            for i, j in draws])


def cases(wl: bench.Workload, grids: dict, draws, draws1000) -> dict:
    """{label: (a no-argument call returning the losses, iterations)}."""
    tcfg = wl.tcfg

    def run(w=wl, d=draws):
        return bench.run_track(w, grids, draws=d)[2]

    def no_sort():
        with measure.no_sort():
            return run()

    return {
        'full': (run, tcfg.iters),
        'fwd_only': (lambda: forward_only(wl, grids, draws), tcfg.iters),
        'no_sort': (no_sort, tcfg.iters),
        'no_color': (lambda: run(wl._replace(
            tcfg=tcfg._replace(use_color=False))), tcfg.iters),
        'pix1000': (lambda: run(wl._replace(
            tcfg=tcfg._replace(pixels=1000)), draws1000), tcfg.iters),
        'iters1': (lambda: run(wl._replace(tcfg=tcfg._replace(iters=1)),
                               draws[:1]), 1),
    }


def main(device=None, *, h: int = 680, w: int = 1200, reps: int = 5
         ) -> dict:
    """Time every case; prints the JAX script's lines and returns the JSON
    line's object.  `h`, `w` and `reps` exist for the CPU tests and the
    chip smoke test; the defaults are the JAX script's."""
    dev = resolve_device(device)
    measure.true_f32()
    measure.build_kernels(dev)
    wl = ablation_workload(dev, h=h, w=w)
    tg = bench.track_grids(wl)
    draws = track_draws(wl, wl.tcfg.pixels, wl.tcfg.iters)
    draws1000 = track_draws(wl, 1000, wl.tcfg.iters)
    measure.reset_launch_counts()
    row = {'metric': 'ablate_track_step', 'pixels': wl.tcfg.pixels,
           'iters': wl.tcfg.iters, 'cases': {}}
    full_losses = None
    for label, (fn, k_iters) in cases(wl, tg, draws, draws1000).items():
        losses = fn()
        best = float('inf')
        for _ in range(reps):
            losses, sec = measure.wall_s(fn, dev)
            best = min(best, sec)
        ms = best * 1e3
        print(f'{label:14s} {ms:8.2f} ms / {k_iters} iters '
              f'= {ms / k_iters:6.3f} ms/iter', flush=True)
        row['cases'][label] = {'ms': ms, 'iters': k_iters,
                               'ms_per_iter': ms / k_iters}
        if label == 'full':
            full_losses = losses
    production = bench.run_track(wl, tg, draws=draws)[2]
    row.update(full_matches_production=bool(torch.equal(full_losses,
                                                        production)),
               device=measure.card(dev), launches=measure.launch_counts())
    return row


def cli(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="The tracked frame's cost attributed by ablation; "
        'prints one line per case and one JSON line.')
    ap.add_argument('--device', default=None, help='cuda (default) or cpu')
    args = ap.parse_args(argv)
    print(json.dumps(main(args.device)), flush=True)


if __name__ == '__main__':
    cli()
