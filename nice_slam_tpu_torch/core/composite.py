"""Alpha compositing of per-sample raw decoder outputs (L0); port of
`nice_slam_tpu/core/composite.py`: the occupancy (NICE) and the density
(iMAP*) modes."""

from __future__ import annotations

import torch


def composite_rays(raw: torch.Tensor, z_vals: torch.Tensor,
                   rays_d: torch.Tensor | None = None, *,
                   occupancy: bool = True):
    """Composite raw [N, S, 4] (r, g, b, occupancy logit or density) along
    each ray with sample depths z_vals [N, S].

    Occupancy: alpha = sigmoid(10 * occ), which needs no sample spacing.
    Density (needs rays_d [N, 3]): alpha = 1 - exp(-relu(sigma) * dist),
    dist the spacing of the samples (the last one 1e10) times |rays_d|.
    Transmittance T_i = prod_{j<i} (1 - alpha_j + 1e-10): the +1e-10 bounds
    cumprod's inputs away from 0, which keeps its backward finite on
    saturated rays; torch.sigmoid is the overflow-free form.

    Returns depth [N], depth variance [N], rgb [N, 3], weights [N, S].
    """
    rgb = raw[..., :3]
    if occupancy:
        alpha = torch.sigmoid(10.0 * raw[..., 3])
    else:
        if rays_d is None:
            raise ValueError('density compositing needs rays_d')
        dists = z_vals[..., 1:] - z_vals[..., :-1]
        dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)],
                          dim=-1)
        dists = dists * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        alpha = 1.0 - torch.exp(-torch.relu(raw[..., 3]) * dists)
    one_minus = 1.0 - alpha + 1e-10
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]), one_minus], dim=-1),
        dim=-1)[..., :-1]
    weights = alpha * trans

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    resid = z_vals - depth_map[..., None]
    depth_var = torch.sum(weights * resid * resid, dim=-1)
    return depth_map, depth_var, rgb_map, weights
