"""The mapping call's cost attributed piece by piece, by ablation, on the
card; the port's `scripts/ablate_map_step.py`.

    python -m nice_slam_tpu_torch.tools.ablate_map_step [--device cuda|cpu]

Times the production mapping call at the Replica budget (1000 px x 60
iterations over a window of 5, the middle / fine / color stage schedule,
32 + 16 samples) and then the same call with one piece taken away at a
time:

  full            the production call, `bench.run_map` (`map_step`)
  fwd_only        the window loss alone at each iteration (no graph): no
                  gradient, no Adam step
  no_grid_grad    no gradient to the volumes (`map_iterations` with the
                  volumes detached before their expansion: no fold, no
                  scatter, no volume update)
  no_dec_grad     the decoders not optimized (no trainable decoder)
  no_cam_grad     the window poses not optimized (no BA)
  no_sort         `torch.sort` the identity on its values, as the JAX
                  script's `jnp.sort`: the samples merged without the depth
                  sort (WRONG math, timing only: `utils/measure.no_sort`)
  frozen_expand   the volumes expanded once before the call and that
                  expansion used in every iteration (WRONG math: stale
                  features after each step, timing only; `frozen_expand`)

The difference (full - ablated) is that piece's cost in place.  Every case
is built here from the port's pieces (`map_step`, `map_iterations`,
`render_rays`); nothing in the package is switched, and the two
wrong-math cases patch only inside a context that restores the patch on
exit, also on an error.

The workload is bench.py's (room0's bound, the default volumes and
decoders from seed 0, a window of 5 copies of a 680x1200 noise frame, BA
on with the first pose fixed) with the JAX script's depth (1.5
everywhere), camera [1, 0, 0, 0, 2, 0, 0.3], stage learning rates (middle
0.1; fine 0.005 on the middle and fine volumes; color 0.005 on the
decoders and the three volumes) and trainable fine and color decoders;
every case draws its pixels from the same per-iteration draws (seed 0)
and starts from a fresh copy of the state made outside the timed window.
Each is the best of 3 calls after one untimed call.

Prints the JAX script's line per case and its closing line, then one JSON
line of the same numbers with `full_matches_production` (the `full`
case's losses equal, to the bit, those of one more production call on the
same draws, made after every case and context has run), the card
(`device`) and each row kernel's launches over the run (`launches`).

Left out as TPU machinery: the compile cache.  TF32 stays off, as in
`SlamSystem`.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import torch

from nice_slam_tpu_torch import bench
from nice_slam_tpu_torch.core.sampling import ray_bound_exit
from nice_slam_tpu_torch.engine import mapper as M
from nice_slam_tpu_torch.engine.slam import resolve_device
from nice_slam_tpu_torch.models.grids import prepare_grids
from nice_slam_tpu_torch.render.renderer import render_rays
from nice_slam_tpu_torch.tools.ablate_track_step import ablation_workload
from nice_slam_tpu_torch.utils import measure

N_ITERS = 60
# (decoders, coarse, middle, fine, color) learning rates a stage
STAGE_LR = (('coarse', (0.0, 0.0, 0.0, 0.0, 0.0)),
            ('middle', (0.0, 0.0, 0.1, 0.0, 0.0)),
            ('fine', (0.0, 0.0, 0.005, 0.005, 0.0)),
            ('color', (0.005, 0.0, 0.005, 0.005, 0.005)))


def map_workload(device, *, h: int = 680, w: int = 1200,
                 n_iters: int = N_ITERS) -> bench.Workload:
    """The ablation workload with the JAX script's stage learning rates
    and trainable fine and color decoders."""
    wl = ablation_workload(device, h=h, w=w, map_iters=n_iters)
    mcfg = wl.mcfg._replace(stage_lr=STAGE_LR, fix_fine=False)
    return wl._replace(mcfg=mcfg,
                       lr_tab=M.lr_table(mcfg, n_iters, 1.0, True),
                       stage_idx=M.stage_schedule(mcfg, n_iters, True))


def map_draws(wl: bench.Workload, seed: int = 0) -> list:
    """Per-iteration (i, j) [window, pixels / window] draws, as the
    mapping call draws them."""
    gen = torch.Generator(device=wl.cam7.device).manual_seed(seed)
    win = wl.mcfg.window_size
    return [M.draw_window_pixels(win, wl.mcfg.pixels // win, wl.intr,
                                 generator=gen, device=wl.cam7.device)
            for _ in range(len(wl.lr_tab))]


def _window(wl: bench.Workload):
    win = wl.mcfg.window_size
    return (wl.cam7.repeat(win, 1),
            wl.color[None].expand(win, *wl.color.shape),
            wl.depth[None].expand(win, *wl.depth.shape))


def map_call(wl: bench.Workload, state: tuple, draws, *,
             trainable=('color', 'fine'), cams: bool = True, prepare=None):
    """`bench.run_map` through `map_iterations` with the trainable
    decoders, the window poses' training (`cams`) and the volumes'
    preparation chosen: (cams [F, 7], losses [iters])."""
    grids, decoders = state
    cam7s, colors, depths = _window(wl)
    return M.map_iterations(
        decoders, grids, cam7s, trainable=trainable, masks=None,
        cam_mask=wl.cam_mask if cams else None, lr_tab=wl.lr_tab,
        stage_idx=wl.stage_idx, colors=colors, depths=depths,
        model=wl.model, rcfg=wl.rcfg, mcfg=wl.mcfg, intr=wl.intr,
        pix_per_frame=wl.mcfg.pixels // wl.mcfg.window_size,
        draw=lambda it: M.as_map_draws(draws[it]), prepare=prepare)


def forward_only(wl: bench.Workload, state: tuple, draws):
    """The window loss of every iteration at the initial state, as
    `map_iterations` computes it, without a graph: (cams, losses)."""
    grids, decoders = state
    cam7s, colors, depths = _window(wl)
    losses = []
    with torch.no_grad():
        for it, (i, j) in enumerate(draws):
            stage = M.STAGE_ORDER[int(wl.stage_idx[it])]
            o, d, dgt, cgt = M.window_rays(cam7s, colors, depths, i, j,
                                           wl.intr)
            inside = ray_bound_exit(o, d, wl.model.bound) >= dgt
            d_render = torch.where(inside, dgt, torch.zeros_like(dgt))
            depth, _, color, _ = render_rays(
                decoders, prepare_grids(grids, wl.model.grid_shapes,
                                        stage=stage),
                o, d, stage=stage, model=wl.model, rcfg=wl.rcfg,
                gt_depth=d_render if stage != 'coarse' else None,
                d_max=torch.amax(d_render))
            err = torch.abs(dgt - depth)
            loss = torch.sum(torch.where((dgt > 0) & inside, err,
                                         torch.zeros_like(err)))
            if stage == 'color':
                col = torch.abs(cgt - color)
                loss = loss + wl.mcfg.w_color_loss * torch.sum(
                    torch.where(inside[:, None], col, torch.zeros_like(col)))
            losses.append(loss)
    return cam7s, torch.stack(losses)


@contextlib.contextmanager
def frozen_expand(grids: dict, grid_shapes: tuple):
    """The mapper's every expansion replaced by one made of `grids` here
    (WRONG math, for timing only: the features go stale after the first
    step, and the volumes get no gradient); restored on exit, also on an
    error."""
    with torch.no_grad():
        pre = prepare_grids({k: g.detach() for k, g in grids.items()},
                            grid_shapes)
    saved = M.prepare_grids
    M.prepare_grids = lambda *_, **__: pre
    try:
        yield
    finally:
        M.prepare_grids = saved


def cases(wl: bench.Workload, draws) -> dict:
    """{label: a call of a fresh state (`bench.map_state`) returning
    (cams, losses)}."""
    shapes = wl.model.grid_shapes

    def full(state):
        return bench.run_map(wl, state, draws=draws)

    def detached(g, stage):
        return prepare_grids({k: v.detach() for k, v in g.items()}, shapes,
                             stage=stage)

    def no_sort(state):
        with measure.no_sort():
            return full(state)

    def frozen(state):
        with frozen_expand(state[0], shapes):
            return full(state)

    return {
        'full': full,
        'fwd_only': lambda state: forward_only(wl, state, draws),
        'no_grid_grad': lambda state: map_call(wl, state, draws,
                                               prepare=detached),
        'no_dec_grad': lambda state: map_call(wl, state, draws,
                                              trainable=()),
        'no_cam_grad': lambda state: map_call(wl, state, draws, cams=False),
        'frozen_expand': frozen,
        'no_sort': no_sort,
    }


def main(device=None, *, h: int = 680, w: int = 1200, reps: int = 3,
         n_iters: int = N_ITERS) -> dict:
    """Time every case; prints the JAX script's lines and returns the JSON
    line's object.  The keyword sizes exist for the CPU tests and the chip
    smoke test; the defaults are the JAX script's."""
    dev = resolve_device(device)
    measure.true_f32()
    measure.build_kernels(dev)
    wl = map_workload(dev, h=h, w=w, n_iters=n_iters)
    draws = map_draws(wl)
    measure.reset_launch_counts()
    row = {'metric': 'ablate_map_step', 'pixels': wl.mcfg.pixels,
           'iters': n_iters, 'window': wl.mcfg.window_size, 'cases': {}}
    full_losses = None
    for label, fn in cases(wl, draws).items():
        _, losses = fn(bench.map_state(wl))
        best = float('inf')
        for _ in range(reps):
            state = bench.map_state(wl)
            (_, losses), sec = measure.wall_s(lambda: fn(state), dev)
            best = min(best, sec)
        ms = best * 1e3
        print(f'{label:18s} {ms:8.1f} ms / {n_iters} iters '
              f'= {ms / n_iters:6.3f} ms/iter', flush=True)
        row['cases'][label] = {'ms': ms, 'ms_per_iter': ms / n_iters}
        if label == 'full':
            full_losses = losses
    print(f'\nfull = {row["cases"]["full"]["ms"]:.1f} ms; deltas vs full '
          'attribute each part.', flush=True)
    _, production = bench.run_map(wl, bench.map_state(wl), draws=draws)
    row.update(full_matches_production=bool(torch.equal(full_losses,
                                                        production)),
               device=measure.card(dev), launches=measure.launch_counts())
    return row


def cli(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="The mapping call's cost attributed by ablation; "
        'prints one line per case and one JSON line.')
    ap.add_argument('--device', default=None, help='cuda (default) or cpu')
    args = ap.parse_args(argv)
    print(json.dumps(main(args.device)), flush=True)


if __name__ == '__main__':
    cli()
