"""Camera tracking (L3); port of `nice_slam_tpu/engine/tracker.py`.

One frame is `iters` Adam steps on the 7-vector [quat, t] camera: each step
draws pixels away from the image edge, renders the color stage at the
current pose, and minimizes |d_gt - d| / sqrt(var) (with dynamic-pixel
rejection, residual < 10x median) plus a weighted color term.  A fresh Adam
state per frame; the kept pose is the post-step tensor of the lowest-loss
step.  NICE: rays whose bbox exit lies before the sensor depth keep their
slot and are masked, so shapes stay fixed; iMAP* has no such prefilter and
no volumes.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from nice_slam_tpu_torch.core.cameras import (
    Intrinsics, c2w_from_tensor, rays_from_uv)
from nice_slam_tpu_torch.core.sampling import (
    gather_pixels, masked_median, ray_bound_exit, sample_pixels)
from nice_slam_tpu_torch.models.grids import prepare_grids
from nice_slam_tpu_torch.render.renderer import (
    RenderConfig, SceneModel, render_rays)
from nice_slam_tpu_torch.utils.optim import MaskedAdam


class TrackerConfig(NamedTuple):
    """Static tracking hyperparameters (config `tracking.*`)."""

    pixels: int = 200
    iters: int = 10
    cam_lr: float = 0.001
    separate_lr: bool = False
    w_color_loss: float = 0.5
    use_color: bool = True
    ignore_edge_w: int = 20
    ignore_edge_h: int = 20
    handle_dynamic: bool = True
    const_speed: bool = True
    # floor of the depth-variance denominator (see the JAX TrackerConfig)
    var_floor: float = 1e-10


def tracking_loss(cam7: torch.Tensor, decoders: Mapping[str, nn.Module],
                  grids: Mapping, gt_color: torch.Tensor,
                  gt_depth: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
                  *, model: SceneModel, rcfg: RenderConfig,
                  tcfg: TrackerConfig, intr: Intrinsics) -> torch.Tensor:
    """Scalar tracking loss at pose `cam7` over pixels (i=col, j=row)."""
    c2w = c2w_from_tensor(cam7)
    rays_o, rays_d = rays_from_uv(i, j, c2w, intr)
    d_gt = gather_pixels(gt_depth, i, j)
    c_gt = gather_pixels(gt_color, i, j)

    # bbox prefilter (NICE) as a mask
    if model.kind == 'nice':
        inside = ray_bound_exit(rays_o.detach(), rays_d.detach(),
                                model.bound) >= d_gt
    else:
        inside = torch.ones_like(d_gt, dtype=torch.bool)
    # masked rays render with depth 0, so the batch statistics inside the
    # renderer (far clip, zero-depth sweep) see the filtered batch
    d_render = torch.where(inside, d_gt, torch.zeros_like(d_gt))
    depth, var, color, _ = render_rays(
        decoders, grids, rays_o, rays_d, stage='color', model=model,
        rcfg=rcfg, gt_depth=d_render)
    var = var.detach()

    tmp = torch.abs(d_gt - depth) / torch.sqrt(var + tcfg.var_floor)
    if tcfg.handle_dynamic:
        med = masked_median(tmp.detach(), inside)
        mask = (tmp.detach() < 10.0 * med) & (d_gt > 0) & inside
    else:
        mask = (d_gt > 0) & inside

    loss = torch.sum(torch.where(mask, tmp, torch.zeros_like(tmp)))
    if tcfg.use_color:
        col = torch.abs(c_gt - color)
        loss = loss + tcfg.w_color_loss * torch.sum(
            torch.where(mask[:, None], col, torch.zeros_like(col)))
    return loss


def track_frame(decoders: Mapping[str, nn.Module], grids: Mapping,
                gt_color: torch.Tensor, gt_depth: torch.Tensor,
                cam7_init: torch.Tensor, *, model: SceneModel,
                rcfg: RenderConfig, tcfg: TrackerConfig, intr: Intrinsics,
                draws: Sequence[tuple[torch.Tensor, torch.Tensor]]
                | None = None,
                generator: torch.Generator | None = None):
    """Optimize one frame's pose from `cam7_init` [7].

    grids: flat or already corner-expanded volumes (expanded here once when
    flat; the orchestrator passes the expansion it keeps between mapping
    commits); {} for iMAP*.  draws: optional per-iteration (i, j) pixel
    indices; without them each iteration draws from `generator`.
    Returns (best_cam7 [7], last_cam7 [7], losses [iters]).
    """
    if model.kind == 'nice':
        with torch.no_grad():
            grids = prepare_grids(grids, model.grid_shapes, stage='color')
    device = cam7_init.device
    quat = cam7_init[:4].detach().clone().requires_grad_(True)
    trans = cam7_init[4:].detach().clone().requires_grad_(True)
    # optional split learning rates: rotation at 0.2x
    lrs = ((tcfg.cam_lr * 0.2 if tcfg.separate_lr else tcfg.cam_lr),
           tcfg.cam_lr)
    opt = MaskedAdam([quat, trans])
    best_loss = torch.full((), float('inf'), device=device)
    best_cam7 = cam7_init.detach().clone()
    losses = []
    for it in range(tcfg.iters):
        if draws is not None:
            i, j = draws[it]
        else:
            i, j = sample_pixels(
                tcfg.pixels, tcfg.ignore_edge_h, intr.H - tcfg.ignore_edge_h,
                tcfg.ignore_edge_w, intr.W - tcfg.ignore_edge_w,
                generator=generator, device=device)
        loss = tracking_loss(torch.cat([quat, trans]), decoders, grids,
                             gt_color, gt_depth, i, j, model=model,
                             rcfg=rcfg, tcfg=tcfg, intr=intr)
        opt.step(torch.autograd.grad(loss, [quat, trans]), lrs)
        loss = loss.detach()
        with torch.no_grad():
            # the post-step pose, keyed by the pre-step loss
            better = loss < best_loss
            best_loss = torch.where(better, loss, best_loss)
            best_cam7 = torch.where(better, torch.cat([quat, trans]),
                                    best_cam7)
        losses.append(loss)
    last = torch.cat([quat, trans]).detach()
    return best_cam7, last, torch.stack(losses)


def const_speed_init(pre_c2w: np.ndarray, pre_pre_c2w: np.ndarray
                     ) -> np.ndarray:
    """Constant-speed motion model: apply the last relative motion again
    (both 4x4)."""
    delta = pre_c2w @ np.linalg.inv(pre_pre_c2w)
    return delta @ pre_c2w
