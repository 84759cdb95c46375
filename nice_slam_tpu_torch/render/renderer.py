"""Volume renderer (L2); port of `nice_slam_tpu/render/renderer.py`:
near/far from sensor depth and the bbox exit, n_samples stratified +
n_surface near-surface samples merged in depth order, decode, composite
(occupancy for NICE, density for iMAP*).  Points outside the scene bound
get the value 100 (an opaque wall at the boundary).  With n_importance > 0
(iMAP*) the composited weights place n_importance more samples per ray by
inverse-CDF sampling; only those new points are decoded, and they are
merged with the first ones in depth order before compositing again.
`render_image` renders a whole frame in ray chunks;
`regulation_sigma(_batched)` draws iMAP*'s free-space density samples.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import torch
from torch import nn

from nice_slam_tpu_torch.core.cameras import Intrinsics, rays_full_image
from nice_slam_tpu_torch.core.composite import composite_rays
from nice_slam_tpu_torch.core.sampling import (
    near_far_from_depth, sample_pdf, stratified_z_vals, surface_z_vals)
from nice_slam_tpu_torch.models.decoders import (
    DecoderConfig, imap_eval, nice_eval)
from nice_slam_tpu_torch.models.grids import prepare_grids


class RenderConfig(NamedTuple):
    """Static rendering hyperparameters (config `rendering.*`)."""

    n_samples: int = 32
    n_surface: int = 16
    n_importance: int = 0
    lindisp: bool = False
    perturb: float = 0.0
    occupancy: bool = True    # False: iMAP*'s density compositing
    ray_chunk: int = 100000   # rays per chunk of render_image
    # pose gradient through the z sampling locations
    # (core.sampling.near_far_from_depth); False = reference semantics
    grad_z: bool = False


class SceneModel(NamedTuple):
    """Static model description plus the scene bounds ([3, 2] tensors on
    the model's device; coarse_bound is the enlarged bound of the coarse
    volume) and the ((name, (nx, ny, nz)), ...) grid shapes.  `fused_eval`
    sends the decoder MLPs through the fused forward kernel
    (ops/fused_mlp.py); the eval-only paths (mesher, full-frame renders)
    set it with `model._replace(fused_eval=True)`, tracking and mapping
    keep the plain path.  `kind` is 'nice' (the volumes and the NICE
    decoders) or 'imap' (one decoder under the key 'imap', no volumes, no
    coarse bound)."""

    decoder: DecoderConfig
    bound: torch.Tensor
    coarse_bound: torch.Tensor | None = None
    grid_shapes: tuple = ()
    fused_eval: bool = False
    kind: str = 'nice'


def eval_raw(decoders: Mapping[str, nn.Module], grids: Mapping,
             p: torch.Tensor, stage: str, model: SceneModel) -> torch.Tensor:
    """Decode points [N, 3] to raw [N, 4]; out-of-bound -> 100 (occupancy
    logit or density).  iMAP* ignores `stage` and `grids`."""
    if model.kind == 'nice':
        raw = nice_eval(decoders, grids, p, stage, model.decoder,
                        model.bound, model.coarse_bound, model.grid_shapes,
                        fused=model.fused_eval)
    elif model.kind == 'imap':
        raw = imap_eval(decoders['imap'], p)
    else:
        raise ValueError(f'unknown model kind {model.kind!r}')
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
    weights [N, S]), S = the first samples plus n_importance.

    gt_depth: [N] sensor depth, or None (the coarse mapper).  d_max
    overrides the batch depth maximum (the mapper passes the window-global
    one).  generator: draws the stratified jitter and the importance
    uniforms when perturb > 0 (with perturb 0 the importance uniforms are
    the evenly spaced ones).
    """
    z_vals = _z_values(rcfg, rays_o, rays_d, gt_depth, model.bound, stage,
                       d_max=d_max, generator=generator)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    n_rays, s = z_vals.shape
    raw = eval_raw(decoders, grids, pts.reshape(-1, 3), stage,
                   model).reshape(n_rays, s, 4)
    out = composite_rays(raw, z_vals, rays_d, occupancy=rcfg.occupancy)
    if rcfg.n_importance == 0:
        return out
    weights = out[3]
    z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    z_samples = sample_pdf(z_mid, weights[..., 1:-1], rcfg.n_importance,
                           det=rcfg.perturb == 0.0, generator=generator)
    # the first samples' values are those decoded above: decode only the
    # new points, then put both in depth order by one permutation
    pts_new = rays_o[..., None, :] + rays_d[..., None, :] \
        * z_samples[..., :, None]
    raw_new = eval_raw(decoders, grids, pts_new.reshape(-1, 3), stage,
                       model).reshape(n_rays, rcfg.n_importance, 4)
    z_all, order = torch.sort(torch.cat([z_vals, z_samples], dim=-1),
                              dim=-1, stable=True)
    raw = torch.gather(torch.cat([raw, raw_new], dim=1), 1,
                       order[..., None].expand(-1, -1, 4))
    return composite_rays(raw, z_all, rays_d, occupancy=rcfg.occupancy)


def render_image(decoders: Mapping[str, nn.Module], grids: Mapping,
                 c2w: torch.Tensor, intr: Intrinsics, *, stage: str,
                 model: SceneModel, rcfg: RenderConfig,
                 gt_depth: torch.Tensor | None = None):
    """Render a full frame in chunks of `rcfg.ray_chunk` rays, the last one
    padded to full size (as the JAX package's `lax.map` over fixed
    chunks), under `no_grad`.  `grids` are the stored volumes; the ones the
    stage samples are corner-expanded once for the whole frame.

    Returns (depth [H, W], depth_var [H, W], color [H, W, 3]).
    """
    with torch.no_grad():
        if model.kind == 'nice':
            grids = prepare_grids(grids, model.grid_shapes, stage=stage)
        rays_o, rays_d = rays_full_image(c2w, intr)
        n = intr.H * intr.W
        chunk = min(rcfg.ray_chunk, n)
        pad = (-n) % chunk
        rays_o = torch.nn.functional.pad(rays_o, (0, 0, 0, pad))
        rays_d = torch.nn.functional.pad(rays_d, (0, 0, 0, pad), value=1.0)
        d_flat = (None if gt_depth is None else
                  torch.nn.functional.pad(gt_depth.reshape(-1), (0, pad)))
        outs = []
        for i in range(0, n + pad, chunk):
            depth, var, color, _ = render_rays(
                decoders, grids, rays_o[i:i + chunk], rays_d[i:i + chunk],
                stage=stage, model=model, rcfg=rcfg,
                gt_depth=None if d_flat is None else d_flat[i:i + chunk])
            outs.append((depth, var, color))
        depth, var, color = (torch.cat(x)[:n] for x in zip(*outs))
    return (depth.reshape(intr.H, intr.W), var.reshape(intr.H, intr.W),
            color.reshape(intr.H, intr.W, 3))


def regulation_sigma(decoders: Mapping[str, nn.Module], grids: Mapping,
                     rays_o: torch.Tensor, rays_d: torch.Tensor,
                     gt_depth: torch.Tensor, *, model: SceneModel,
                     rcfg: RenderConfig, t_rand: torch.Tensor,
                     stage: str = 'color') -> torch.Tensor:
    """iMAP*'s free-space regulation: the densities at n_samples jittered
    depths in [0, 0.85 d] along rays [N, 3] with sensor depth d [N].  The
    jitter's uniforms are `t_rand` [N, n_samples].  Returns sigma
    [N * n_samples]."""
    d = gt_depth.reshape(-1, 1)
    z_vals = stratified_z_vals(rcfg.n_samples, torch.zeros_like(d), d * 0.85,
                               perturb=1.0, t_rand=t_rand)
    pts = rays_o[..., None, :] + rays_d[..., None, :] * z_vals[..., :, None]
    return eval_raw(decoders, grids, pts.reshape(-1, 3), stage, model)[:, 3]


def regulation_sigma_batched(decoders: Mapping[str, nn.Module],
                             grids: Mapping, rays_o: torch.Tensor,
                             rays_d: torch.Tensor, gt_depth: torch.Tensor,
                             *, model: SceneModel, rcfg: RenderConfig,
                             t_rand: torch.Tensor,
                             stage: str = 'color') -> torch.Tensor:
    """`regulation_sigma` with a leading frame axis (rays [F, P, 3], depth
    [F, P], jitter uniforms `t_rand` [F, P, n_samples]), decoded in one
    call.  Returns sigma [F * P * n_samples]."""
    f, p = gt_depth.shape
    return regulation_sigma(decoders, grids, rays_o.reshape(f * p, 3),
                            rays_d.reshape(f * p, 3), gt_depth.reshape(-1),
                            model=model, rcfg=rcfg,
                            t_rand=t_rand.reshape(f * p, -1), stage=stage)
