"""The hot path's pieces timed one by one on the card; the port's
`scripts/profile_components.py`.

    python -m nice_slam_tpu_torch.tools.profile_components \
        [--device cuda|cpu]

At room0's bound rounded to 0.32 with the default volumes and decoders
(random, from seed 0), 32 + 16 samples a ray, it times:
  * trilinear sampling of the middle, fine and color volumes at 48,000
    points (1000 rays x 48 samples) drawn uniformly in the bound;
  * `nice_eval`'s color stage forward at those points;
  * `render_rays`' color stage forward for 1000 rays (origin (2, 0, 0.3),
    a fan of directions, sensor depth 1.5);
  * a mapping grad iteration over those rays: the gradient of
    |1.5 - depth| + |color - 0.5| over the volumes and the color decoder;
  * the grad iteration of the coarse, middle and fine stages (depth loss,
    the gradient over the volumes);
  * a tracking grad iteration: 200 of the rays from the camera
    [1, 0, 0, 0, 2, 0, 0.3], the gradient of the variance-weighted depth
    loss over the camera.
Each as the median ms of 20 calls synchronized after each
(`ms_per_call`) and as the ms per call of 20 calls launched back to back
and synchronized once (`ms_pipelined`), after one warm-up call
(`utils/measure.timeit`, the JAX script's `timeit`); the gradients by
`torch.autograd.grad`, the forwards without a graph.

The JAX script samples the flat volumes directly (8 corner rows a point),
the `baseline` rows here.  The `expanded` rows take the port's layout
(one corner-expanded row a point, ops/trilinear.ExpandedGrid): expanded
once outside the timed call for the forwards and the tracking gradient
(as the tracker keeps them), and inside it for the mapping gradients (as
the mapper expands them every iteration).

Prints the grids' shapes and sizes and one line per piece and layout,
then one JSON line of the same numbers with the card (`device`) and each
row kernel's launches over the run (`launches`).

Left out as TPU machinery: the compile cache.  TF32 stays off, as in
`SlamSystem`.
"""

from __future__ import annotations

import argparse
import json

import torch

from nice_slam_tpu_torch.core.cameras import c2w_from_tensor
from nice_slam_tpu_torch.engine.slam import resolve_device
from nice_slam_tpu_torch.models.decoders import (
    DecoderConfig, init_nice_decoders, nice_eval)
from nice_slam_tpu_torch.models.grids import (
    GridConfig, init_grids, prepare_grids, round_bound, static_grid_shapes)
from nice_slam_tpu_torch.ops.trilinear import expand_grid, sample_grid_feature
from nice_slam_tpu_torch.render.renderer import (
    RenderConfig, SceneModel, render_rays)
from nice_slam_tpu_torch.utils import measure

ROOM0_BOUND = [[-1.3, 7.4], [-3.1, 3.2], [-1.7, 2.3]]
CAM7 = (1.0, 0.0, 0.0, 0.0, 2.0, 0.0, 0.3)


def pieces(model, rcfg, decoders, grids, pts, rays, cam7, n_track: int,
           expanded: bool) -> dict:
    """{label: a no-argument call} of every piece in one layout."""
    shapes = dict(model.grid_shapes)
    ro, rd, gtd = rays
    names = list(grids)
    color_params = list(decoders['color'].parameters())

    def fixed(stage):
        # the volumes as the tracker samples them
        if not expanded:
            return grids
        with torch.no_grad():
            return prepare_grids(grids, model.grid_shapes, stage=stage)

    def live(g, stage):
        # the volumes as the mapper samples them, rebuilt in the call
        return prepare_grids(g, model.grid_shapes, stage=stage) \
            if expanded else g

    out = {}
    for name in ('middle', 'fine', 'color'):
        if expanded:
            with torch.no_grad():
                vol = expand_grid(grids[name], shapes[name])
        else:
            vol = grids[name]

        def trilinear(vol=vol, name=name):
            with torch.no_grad():
                return sample_grid_feature(vol, pts, model.bound,
                                           shapes[name])
        out[f'trilinear_{name}'] = trilinear

    exp_color = fixed('color')

    def eval_fwd():
        with torch.no_grad():
            return nice_eval(decoders, exp_color, pts, 'color',
                             model.decoder, model.bound, model.coarse_bound,
                             model.grid_shapes)

    def render_fwd():
        with torch.no_grad():
            return render_rays(decoders, exp_color, ro, rd, stage='color',
                               model=model, rcfg=rcfg, gt_depth=gtd)
    out['nice_eval_color_fwd'] = eval_fwd
    out['render_rays_color_fwd'] = render_fwd

    leaves = {k: g.detach().requires_grad_(True) for k, g in grids.items()}

    def map_grad():
        d, _, c, _ = render_rays(decoders, live(leaves, 'color'), ro, rd,
                                 stage='color', model=model, rcfg=rcfg,
                                 gt_depth=gtd)
        loss = torch.abs(gtd - d).sum() + torch.abs(c - 0.5).sum()
        return torch.autograd.grad(
            loss, [leaves[k] for k in names] + color_params,
            allow_unused=True)
    out['map_grad_iter'] = map_grad

    for stage in ('coarse', 'middle', 'fine'):
        def stage_grad(stage=stage):
            d, _, _, _ = render_rays(decoders, live(leaves, stage), ro, rd,
                                     stage=stage, model=model, rcfg=rcfg,
                                     gt_depth=gtd)
            return torch.autograd.grad(torch.abs(gtd - d).sum(),
                                       [leaves[k] for k in names],
                                       allow_unused=True)
        out[f'map_grad_iter_{stage}'] = stage_grad

    uv_dir, d_tr = rd[:n_track], gtd[:n_track]

    def track_grad():
        c7 = cam7.detach().requires_grad_(True)
        c2w = c2w_from_tensor(c7)
        o = c2w[:3, 3].expand(n_track, 3)
        d = uv_dir @ c2w[:3, :3].T
        dep, var, _, _ = render_rays(decoders, exp_color, o, d,
                                     stage='color', model=model, rcfg=rcfg,
                                     gt_depth=d_tr)
        loss = (torch.abs(d_tr - dep) / torch.sqrt(var + 1e-10)).sum()
        return torch.autograd.grad(loss, [c7])
    out['track_grad_iter'] = track_grad
    return out


def main(device=None, *, n: int = 20, n_pts: int = 48000,
         n_rays: int = 1000, n_track: int = 200) -> dict:
    """Time every piece in both layouts; prints the lines and returns the
    JSON line's object.  The keyword sizes exist for the CPU tests and the
    chip smoke test; the defaults are the JAX script's."""
    dev = resolve_device(device)
    measure.true_f32()
    measure.build_kernels(dev)
    gcfg = GridConfig(bound=round_bound(ROOM0_BOUND, 0.32))
    dcfg = DecoderConfig()
    rcfg = RenderConfig(n_samples=32, n_surface=16)
    model = SceneModel(
        decoder=dcfg, bound=torch.tensor(gcfg.bound_np, device=dev),
        coarse_bound=torch.tensor(gcfg.coarse_bound_np, device=dev),
        grid_shapes=static_grid_shapes(gcfg))
    gen = torch.Generator().manual_seed(0)
    grids = {k: g.to(dev) for k, g in
             init_grids(gcfg, generator=gen, device='cpu').items()}
    decoders = init_nice_decoders(dcfg, generator=gen, device='cpu').to(dev)
    shapes = dict(model.grid_shapes)
    row = {'metric': 'profile_components', 'points': n_pts, 'rays': n_rays,
           'track_rays': n_track, 'grids': {}}
    for name, g in grids.items():
        mb = g.numel() * g.element_size() / 1e6
        print(name, shapes[name], tuple(g.shape), f'{mb:.2f} MB')
        row['grids'][name] = {'shape': list(shapes[name]), 'mb': mb}

    lo, hi = model.bound[:, 0], model.bound[:, 1]
    pts = lo + (hi - lo) * torch.rand((n_pts, 3), generator=gen).to(dev)
    ro = torch.tensor([2.0, 0.0, 0.3], device=dev).expand(n_rays, 3)
    th = torch.linspace(-0.5, 0.5, n_rays, device=dev)
    rd = torch.stack([torch.sin(th), 0.1 * torch.cos(3 * th),
                      -torch.cos(th)], dim=-1)
    gtd = torch.full((n_rays,), 1.5, device=dev)
    cam7 = torch.tensor(CAM7, device=dev)

    measure.reset_launch_counts()
    labels = {'trilinear_middle': f'trilinear middle  {n_pts} pts',
              'trilinear_fine': f'trilinear fine    {n_pts} pts',
              'trilinear_color': f'trilinear color   {n_pts} pts',
              'nice_eval_color_fwd': f'nice_eval color fwd {n_pts}',
              'render_rays_color_fwd': f'render_rays color fwd {n_rays}',
              'map_grad_iter': f'map grad iter ({n_rays} rays)',
              'map_grad_iter_coarse': 'map grad iter stage=coarse ',
              'map_grad_iter_middle': 'map grad iter stage=middle ',
              'map_grad_iter_fine': 'map grad iter stage=fine   ',
              'track_grad_iter': f'track grad iter ({n_track} rays)'}
    row['rows'] = {}
    for tag, expanded in (('baseline', False), ('expanded', True)):
        rows = row['rows'][tag] = {}
        for key, fn in pieces(model, rcfg, decoders, grids, pts,
                              (ro, rd, gtd), cam7, n_track,
                              expanded).items():
            lat, thr = measure.timeit(fn, dev, n)
            print(f'[{tag}] {labels[key]}: {lat:8.3f} ms/call  {thr:8.3f} '
                  'ms pipelined', flush=True)
            rows[key] = {'ms_per_call': lat, 'ms_pipelined': thr}
    row.update(device=measure.card(dev), launches=measure.launch_counts())
    return row


def cli(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="The hot path's pieces timed one by one, in the direct "
        'and the expanded volume layout.')
    ap.add_argument('--device', default=None, help='cuda (default) or cpu')
    args = ap.parse_args(argv)
    print(json.dumps(main(args.device)), flush=True)


if __name__ == '__main__':
    cli()
