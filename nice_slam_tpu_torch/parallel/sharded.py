"""Ray-sharded tracking and mapping, and the sharded lattice query; port
of `nice_slam_tpu/parallel/sharded.py`.

Every optimization step's loss is a sum over independently rendered rays,
so each rank renders a share of the rays, the loss and the gradients are
summed over the ranks (`RankGroup.sum_list`: one all-reduce an iteration),
and every rank takes the same Adam step on its replicated copy of the
state.

* Tracking (`sharded_track_frame`) draws the same global pixel batch on
  every rank (from the `draws` given, or from generators the ranks keep in
  step) and renders a contiguous 1/size of it; the far clamp's maximum and
  the dynamic-pixel median are taken over the whole batch
  (`engine/tracker.tracking_loss`), so the step is the single-rank step up
  to the order of the sums.  With perturb > 0 a rank's jitter is its slice
  of the batch's.
* Mapping (`ray_sharded_map_step`) has each rank draw pix_per_frame //
  size pixels a frame from a generator of its own (the JAX package folds
  its key with the rank); the far clamp is the rank's own batch maximum,
  as in the JAX package's ray-sharded step.
* `sharded_eval_points` splits a point batch over the ranks (the mesher's
  lattice query): each rank decodes its slice and a gather assembles the
  field, the single rank's values bit for bit where the decoder treats
  points independently (the fused MLP kernel on the card does).
"""

from __future__ import annotations

import torch

from nice_slam_tpu_torch.engine.mapper import (
    as_map_draws, draw_map_iteration, map_iterations)
from nice_slam_tpu_torch.engine.tracker import track_frame
from nice_slam_tpu_torch.parallel.mesh import RankGroup
from nice_slam_tpu_torch.render.renderer import eval_raw


def sharded_track_frame(decoders, grids, gt_color: torch.Tensor,
                        gt_depth: torch.Tensor, cam7_init: torch.Tensor, *,
                        group: RankGroup, **kw):
    """`engine.tracker.track_frame` with the rays shared over `group`
    (JAX: `make_sharded_track_frame`); it raises ValueError unless
    tracking.pixels divides over the ranks."""
    return track_frame(decoders, grids, gt_color, gt_depth, cam7_init,
                       group=group, **kw)


def ray_sharded_map_step(decoders, grids, cams: torch.Tensor, *,
                         group: RankGroup, pix_per_frame: int, draws=None,
                         generator: torch.Generator | None = None, **kw):
    """Ray-sharded `engine.mapper.map_step`.

    pix_per_frame is the window's per-frame budget; this rank renders
    pix_per_frame // size pixels of every frame: `draws[it]` (this rank's
    `MapDraws`) or drawn from `generator`, which is this rank's own.  The
    loss and every gradient are summed over the ranks before the identical
    masked Adam step.  Returns map_step's (cams [F, 7], losses)."""
    local = max(pix_per_frame // group.size, 1)
    n_frames = cams.shape[0]

    def draw(it):
        if draws is not None:
            return as_map_draws(draws[it])
        return draw_map_iteration(n_frames, local, kw['intr'], kw['rcfg'],
                                  generator=generator, device=cams.device)

    return map_iterations(decoders, grids, cams, pix_per_frame=local,
                          draw=draw, reduce=group.sum_list, **kw)


def rows_per_rank(n: int, size: int) -> int:
    """Rows of each rank's slice of an [n, ...] batch split over `size`
    ranks: a multiple of 4, so every [rows, 3] float32 slice of a 16-byte
    aligned batch starts 16-byte aligned (the fused decoder kernel's
    requirement)."""
    return -(-n // (4 * size)) * 4


def sharded_eval_points(decoders, grids, points: torch.Tensor, stage: str,
                        model, group: RankGroup) -> torch.Tensor:
    """Decode points [N, 3] to raw [N, 4] over the ranks of `group`: the
    batch is padded to `rows_per_rank` rows a rank, each rank decodes its
    contiguous slice, and every rank gets the whole result."""
    n = points.shape[0]
    per = rows_per_rank(n, group.size)
    pad = per * group.size - n
    if pad:
        points = torch.nn.functional.pad(points, (0, 0, 0, pad))
    mine = points[group.rank * per:(group.rank + 1) * per]
    raw = eval_raw(decoders, grids, mine, stage, model)
    return group.all_gather_tiled(raw)[:n]
