"""Volume renderer (L2); port of `nice_slam_tpu/render/renderer.py` for the
NICE model: near/far from sensor depth and the bbox exit, n_samples
stratified + n_surface near-surface samples merged in depth order, decode,
composite.  Points outside the scene bound get occupancy logit 100 (an
opaque wall at the boundary).
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import torch
from torch import nn

from nice_slam_tpu_torch.core.composite import composite_rays
from nice_slam_tpu_torch.core.sampling import (
    near_far_from_depth, stratified_z_vals, surface_z_vals)
from nice_slam_tpu_torch.models.decoders import DecoderConfig, nice_eval


class RenderConfig(NamedTuple):
    """Static rendering hyperparameters (config `rendering.*`)."""

    n_samples: int = 32
    n_surface: int = 16
    n_importance: int = 0
    lindisp: bool = False
    perturb: float = 0.0
    # pose gradient through the z sampling locations
    # (core.sampling.near_far_from_depth); False = reference semantics
    grad_z: bool = False


class SceneModel(NamedTuple):
    """Static model description plus the scene bounds ([3, 2] tensors on
    the model's device; coarse_bound is the enlarged bound of the coarse
    volume) and the ((name, (nx, ny, nz)), ...) grid shapes."""

    decoder: DecoderConfig
    bound: torch.Tensor
    coarse_bound: torch.Tensor | None = None
    grid_shapes: tuple = ()


def eval_raw(decoders: Mapping[str, nn.Module], grids: Mapping,
             p: torch.Tensor, stage: str, model: SceneModel) -> torch.Tensor:
    """Decode points [N, 3] to raw [N, 4]; out-of-bound -> occupancy 100."""
    raw = nice_eval(decoders, grids, p, stage, model.decoder, model.bound,
                    model.coarse_bound, model.grid_shapes)
    inside = torch.all((p > model.bound[:, 0]) & (p < model.bound[:, 1]),
                       dim=-1)
    occ = torch.where(inside, raw[..., 3], torch.full_like(raw[..., 3],
                                                           100.0))
    return torch.cat([raw[..., :3], occ[..., None]], dim=-1)


def _z_values(rcfg: RenderConfig, rays_o, rays_d, gt_depth, bound, stage,
              d_max=None, generator=None) -> torch.Tensor:
    """Sorted sample depths [N, S]; the coarse stage ignores sensor depth."""
    use_depth = gt_depth is not None and stage != 'coarse'
    near, far = near_far_from_depth(rays_o, rays_d, bound,
                                    gt_depth if use_depth else None,
                                    grad_z=rcfg.grad_z, d_max=d_max)
    z_vals = stratified_z_vals(rcfg.n_samples, near, far,
                               lindisp=rcfg.lindisp, perturb=rcfg.perturb,
                               generator=generator)
    if use_depth and rcfg.n_surface > 0:
        z_surf = surface_z_vals(rcfg.n_surface, gt_depth, d_max=d_max)
        z_vals = torch.sort(torch.cat([z_vals, z_surf], dim=-1),
                            dim=-1).values
    return z_vals


def render_rays(decoders: Mapping[str, nn.Module], grids: Mapping,
                rays_o: torch.Tensor, rays_d: torch.Tensor, *, stage: str,
                model: SceneModel, rcfg: RenderConfig,
                gt_depth: torch.Tensor | None = None,
                d_max: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
    """Render rays [N, 3] -> (depth [N], depth_var [N], color [N, 3],
    weights [N, S]).

    gt_depth: [N] sensor depth, or None (the coarse mapper).  d_max
    overrides the batch depth maximum (the mapper passes the window-global
    one).  generator: draws the stratified jitter when perturb > 0.
    """
    if rcfg.n_importance > 0:
        raise NotImplementedError(
            'rendering.N_importance > 0 (hierarchical resampling, iMAP) is '
            'not ported yet')
    z_vals = _z_values(rcfg, rays_o, rays_d, gt_depth, model.bound, stage,
                       d_max=d_max, generator=generator)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    n_rays, s = z_vals.shape
    raw = eval_raw(decoders, grids, pts.reshape(-1, 3), stage, model)
    return composite_rays(raw.reshape(n_rays, s, 4), z_vals)
