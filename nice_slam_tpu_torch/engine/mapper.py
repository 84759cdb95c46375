"""Mapping (L3): joint grid / decoder / pose optimization; port of
`nice_slam_tpu/engine/mapper.py` (NICE and iMAP*, one device).

Each iteration draws pixels from every frame of the keyframe window, renders
the stage the schedule picks (middle -> fine -> color by iteration
fraction, or coarse for the coarse mapper), and takes one masked Adam step
on the volumes, the trainable decoders and, when BA is active, the window
poses.  Learning rates come per iteration from the stage table; frustum
masks freeze the volume entries the current camera does not see.  One Adam
state lives for one mapping call.

The volumes are corner-expanded inside every iteration (the grids change
under Adam): the expansion is the `ops/expand.py` kernel and its backward
the fold kernel.

iMAP* has no volumes: every iteration renders like the color stage, with
no bounding-box mask, at the rate `imap_decoders_lr` decayed by StepLR(200,
0.8), and adds the free-space regulation 0.0005 * sum |sigma| over
densities drawn in [0, 0.85 d] for every window frame.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Sequence

import numpy as np
import torch
from torch import nn

from nice_slam_tpu_torch.core.cameras import (
    Intrinsics, c2w_from_tensor, rays_from_uv)
from nice_slam_tpu_torch.core.sampling import ray_bound_exit
from nice_slam_tpu_torch.models.grids import prepare_grids
from nice_slam_tpu_torch.render.renderer import (
    RenderConfig, SceneModel, regulation_sigma_batched, render_rays)
from nice_slam_tpu_torch.utils.optim import MaskedAdam

# learning-rate table columns
(LR_DECODERS, LR_COARSE, LR_MIDDLE, LR_FINE, LR_COLOR, LR_CAM,
 LR_DEC_MIDDLE) = range(7)
STAGE_ORDER = ('coarse', 'middle', 'fine', 'color')


class MapperConfig(NamedTuple):
    """Static mapping hyperparameters (config `mapping.*`)."""

    pixels: int = 1000
    iters: int = 60
    iters_first: int = 1500
    lr_factor: float = 1.0
    lr_first_factor: float = 5.0
    middle_iter_ratio: float = 0.4
    fine_iter_ratio: float = 0.6
    every_frame: int = 5
    ba: bool = True
    ba_cam_lr: float = 0.001
    fix_fine: bool = True
    fix_color: bool = False
    train_middle: bool = False
    # upper bound on rays rendered per backward pass inside one iteration
    # (0 = the whole window at once); the window is then rendered in frame
    # groups with the gradient accumulated across them
    max_rays_per_pass: int = 0
    frustum_selection: bool = True
    keyframe_every: int = 50
    window_size: int = 5
    w_color_loss: float = 0.2
    keyframe_selection: str = 'overlap'  # 'overlap' | 'global'
    color_refine: bool = True
    stage_lr: tuple = ()    # ((stage, (dec, coarse, mid, fine, color)), ...)
    imap_decoders_lr: float = 0.0002
    middle_decoder_lr: float = 0.005
    coarse_mapper: bool = False


def stage_schedule(mcfg: MapperConfig, n_iters: int, nice: bool = True
                   ) -> np.ndarray:
    """Per-iteration stage indices into STAGE_ORDER (iMAP*: always the
    color stage)."""
    idx = np.zeros((n_iters,), dtype=np.int32)
    if not nice:
        idx[:] = 3
        return idx
    if mcfg.coarse_mapper:
        return idx
    for it in range(n_iters):
        if it <= int(n_iters * mcfg.middle_iter_ratio):
            idx[it] = 1
        elif it <= int(n_iters * mcfg.fine_iter_ratio):
            idx[it] = 2
        else:
            idx[it] = 3
    return idx


def lr_table(mcfg: MapperConfig, n_iters: int, lr_factor: float,
             ba_active: bool, nice: bool = True) -> np.ndarray:
    """[n_iters, 7] learning rates.  NICE: the stage's rates scaled by
    lr_factor; the camera rate only in the color stage with BA active; the
    middle decoder's rate only in the middle stage.  iMAP*: the decoder's
    rate imap_decoders_lr x 0.8^(it // 200) (StepLR), not scaled by
    lr_factor, and the camera rate with BA active."""
    table = np.zeros((n_iters, 7), dtype=np.float32)
    if not nice:
        steps = np.arange(n_iters) // 200
        table[:, LR_DECODERS] = mcfg.imap_decoders_lr * (0.8 ** steps)
        if ba_active:
            table[:, LR_CAM] = mcfg.ba_cam_lr
        return table
    stages = dict(mcfg.stage_lr)
    for it, s_idx in enumerate(stage_schedule(mcfg, n_iters)):
        s = STAGE_ORDER[s_idx]
        dec, c, m, f, col = stages[s]
        table[it, :5] = (dec * lr_factor, c * lr_factor, m * lr_factor,
                         f * lr_factor, col * lr_factor)
        if ba_active and s == 'color':
            table[it, LR_CAM] = mcfg.ba_cam_lr
        if s == 'middle':
            table[it, LR_DEC_MIDDLE] = mcfg.middle_decoder_lr * lr_factor
    return table


def draw_window_pixels(n_frames: int, pix_per_frame: int, intr: Intrinsics,
                       *, generator: torch.Generator, device
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniform pixels over the whole image (no edge crop) for every window
    frame: (i, j), each [F, P] float32."""
    j = torch.randint(0, intr.H, (n_frames, pix_per_frame),
                      generator=generator, device=device)
    i = torch.randint(0, intr.W, (n_frames, pix_per_frame),
                      generator=generator, device=device)
    return i.float(), j.float()


def window_rays(cams: torch.Tensor, colors: torch.Tensor,
                depths: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
                intr: Intrinsics):
    """Rays and ground truth for pixels (i, j) [F, P] of the window frames
    (cams [F, 7], colors [F, H, W, 3], depths [F, H, W]), flattened to
    [F*P] rays."""
    n_frames = cams.shape[0]
    o, d = rays_from_uv(i, j, c2w_from_tensor(cams), intr)      # [F, P, 3]
    f = torch.arange(n_frames, device=cams.device)[:, None]
    jj, ii = j.long(), i.long()
    dgt = depths[f, jj, ii]
    cgt = colors[f, jj, ii]
    return (o.reshape(-1, 3), d.reshape(-1, 3), dgt.reshape(-1),
            cgt.reshape(-1, 3))


def _frame_groups(mcfg: MapperConfig, n_frames: int, pix_per_frame: int
                  ) -> int:
    if not mcfg.max_rays_per_pass:
        return 1
    if pix_per_frame > mcfg.max_rays_per_pass:
        raise ValueError(
            f'mapping.max_rays_per_pass={mcfg.max_rays_per_pass} is below '
            f'the per-frame ray count ({pix_per_frame}); raise it to at '
            f'least pixels/window or disable it (0)')
    groups = -(-n_frames * pix_per_frame // mcfg.max_rays_per_pass)
    while n_frames % groups:   # groups must tile the window
        groups += 1
    return groups


def map_step(decoders: Mapping[str, nn.Module], grids: dict,
             cams: torch.Tensor, *, trainable: Sequence[str],
             masks: Mapping[str, torch.Tensor] | None,
             cam_mask: torch.Tensor | None, lr_tab: np.ndarray,
             stage_idx: np.ndarray, colors: torch.Tensor,
             depths: torch.Tensor, model: SceneModel, rcfg: RenderConfig,
             mcfg: MapperConfig, intr: Intrinsics, pix_per_frame: int,
             draws: Sequence[tuple[torch.Tensor, torch.Tensor]]
             | None = None,
             reg_jitter: Sequence[torch.Tensor] | None = None,
             generator: torch.Generator | None = None):
    """One mapping call: len(lr_tab) iterations with one Adam state.

    grids: {name: flat [M, C] leaf tensor} ({} for iMAP*), updated in
    place; the decoders named in `trainable` are updated in place too.
    cams: [F, 7] window poses; cam_mask: [F] 0/1 trainable-pose mask, or
    None when the poses are constants (no BA).  masks: {name: [M, 1] 0/1}
    frustum masks or None.  draws: optional per-iteration (i, j) [F, P]
    pixel indices; reg_jitter: optional per-iteration [F, P, n_samples]
    uniforms of the regulation's jitter (density compositing only);
    without them each iteration draws from `generator`.
    Returns (cams [F, 7] after the call, losses [n_iters]).
    """
    nice = model.kind == 'nice'
    n_frames = cams.shape[0]
    names = list(grids)
    cams = cams.detach().clone().requires_grad_(cam_mask is not None)
    dec_params = [(name, p) for name in trainable
                  for p in decoders[name].parameters()]
    leaves = ([cams] if cam_mask is not None else []) \
        + [grids[n] for n in names] + [p for _, p in dec_params]
    leaf_masks = ([cam_mask[:, None]] if cam_mask is not None else []) \
        + [masks[n] if masks is not None else None for n in names] \
        + [None] * len(dec_params)
    opt = MaskedAdam(leaves)
    groups = _frame_groups(mcfg, n_frames, pix_per_frame)
    frames_per_group = n_frames // groups

    losses = []
    for it in range(len(lr_tab)):
        stage = STAGE_ORDER[int(stage_idx[it])]
        if draws is not None:
            i, j = draws[it]
        else:
            i, j = draw_window_pixels(n_frames, pix_per_frame, intr,
                                      generator=generator,
                                      device=cams.device)
        o, d, dgt, cgt = window_rays(cams, colors, depths, i, j, intr)
        # bbox prefilter (NICE) as a mask; the far clamp takes the maximum
        # over the whole window's (filtered) depths
        if nice:
            inside = ray_bound_exit(o.detach(), d.detach(),
                                    model.bound) >= dgt
        else:
            inside = torch.ones_like(dgt, dtype=torch.bool)
        d_render = torch.where(inside, dgt, torch.zeros_like(dgt))
        d_max = torch.amax(d_render)
        use_depth = stage != 'coarse'
        # rebuilt every iteration; backward = the fold
        exp = (prepare_grids(grids, model.grid_shapes, stage=stage) if nice
               else grids)
        jitter = None
        if not rcfg.occupancy:
            jitter = (reg_jitter[it] if reg_jitter is not None else
                      torch.rand((n_frames, pix_per_frame, rcfg.n_samples),
                                 generator=generator, device=cams.device))

        grads, loss = None, 0.0
        n_rays = frames_per_group * pix_per_frame
        for g in range(groups):
            sl = slice(g * n_rays, (g + 1) * n_rays)
            depth, _, color, _ = render_rays(
                decoders, exp, o[sl], d[sl], stage=stage, model=model,
                rcfg=rcfg, gt_depth=d_render[sl] if use_depth else None,
                d_max=d_max)
            depth_mask = (dgt[sl] > 0) & inside[sl]
            err = torch.abs(dgt[sl] - depth)
            loss_g = torch.sum(torch.where(depth_mask, err,
                                           torch.zeros_like(err)))
            if stage == 'color':
                col = torch.abs(cgt[sl] - color)
                loss_g = loss_g + mcfg.w_color_loss * torch.sum(
                    torch.where(inside[sl, None], col, torch.zeros_like(col)))
            if jitter is not None:
                # the free-space regulation over this group's frames
                fs = slice(g * frames_per_group, (g + 1) * frames_per_group)
                shape = (frames_per_group, pix_per_frame)
                sigma = regulation_sigma_batched(
                    decoders, exp, o[sl].reshape(shape + (3,)),
                    d[sl].reshape(shape + (3,)), d_render[sl].reshape(shape),
                    model=model, rcfg=rcfg, t_rand=jitter[fs], stage=stage)
                loss_g = loss_g + 0.0005 * torch.sum(torch.abs(sigma))
            g_grads = torch.autograd.grad(loss_g, leaves, allow_unused=True,
                                          retain_graph=g < groups - 1)
            grads = g_grads if grads is None else [
                a if b is None else (b if a is None else a + b)
                for a, b in zip(grads, g_grads)]
            loss = loss + loss_g.detach()

        row = lr_tab[it]
        lrs = ([float(row[LR_CAM])] if cam_mask is not None else []) \
            + [float(row[1 + STAGE_ORDER.index(n)]) for n in names] \
            + [float(row[LR_DEC_MIDDLE] if name == 'middle'
                     else row[LR_DECODERS]) for name, _ in dec_params]
        opt.step(grads, lrs, leaf_masks)
        losses.append(loss)
    return cams.detach(), torch.stack(losses)
