"""Alpha compositing of per-sample raw decoder outputs (L0); port of
`nice_slam_tpu/core/composite.py`, occupancy (NICE) mode."""

from __future__ import annotations

import torch


def composite_rays(raw: torch.Tensor, z_vals: torch.Tensor):
    """Composite raw [N, S, 4] (r, g, b, occupancy logit) along each ray.

    alpha = sigmoid(10 * occ); transmittance T_i = prod_{j<i}
    (1 - alpha_j + 1e-10).  The +1e-10 bounds cumprod's inputs away from 0,
    which keeps its backward finite on saturated rays; torch.sigmoid is the
    overflow-free form.  (Occupancy compositing needs no sample spacing, so
    the ray directions of the density mode do not appear.)

    Returns depth [N], depth variance [N], rgb [N, 3], weights [N, S].
    """
    rgb = raw[..., :3]
    alpha = torch.sigmoid(10.0 * raw[..., 3])
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
