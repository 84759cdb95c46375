"""Pixel and depth-along-ray sampling (L0); port of
`nice_slam_tpu/core/sampling.py`.

Random draws come from an explicit `torch.Generator`.  JAX's Threefry bits
cannot be reproduced in torch, so every caller that draws pixels, jitter or
pdf uniforms can also take them as an input (the parity tests feed the
JAX-drawn ones).
Rays that exit the scene bound before the sensor depth keep their slot and
are masked in the losses, as in the reference package.
"""

from __future__ import annotations

import torch


def sample_pixels(n: int, h0: int, h1: int, w0: int, w1: int, *,
                  generator: torch.Generator, device
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """n uniform pixel coordinates from [h0,h1) x [w0,w1): (i=column,
    j=row), both float32."""
    j = torch.randint(h0, h1, (n,), generator=generator, device=device)
    i = torch.randint(w0, w1, (n,), generator=generator, device=device)
    return i.float(), j.float()


def gather_pixels(image: torch.Tensor, i: torch.Tensor, j: torch.Tensor
                  ) -> torch.Tensor:
    """Per-pixel values at integer coordinates (i=x/col, j=y/row)."""
    return image[j.long(), i.long()]


def ray_bound_exit(rays_o: torch.Tensor, rays_d: torch.Tensor,
                   bound: torch.Tensor) -> torch.Tensor:
    """[N] distance along each ray to its exit from the [3, 2] bound."""
    t = (bound[None, :, :] - rays_o[..., None]) / rays_d[..., None]
    return torch.amin(torch.amax(t, dim=2), dim=1)


def stratified_z_vals(n_samples: int, near: torch.Tensor, far: torch.Tensor,
                      *, lindisp: bool = False, perturb: float = 0.0,
                      generator: torch.Generator | None = None,
                      t_rand: torch.Tensor | None = None) -> torch.Tensor:
    """Evenly spaced samples in [near, far] ([N, 1] each), optionally
    jittered: [N, n_samples].  The jitter's uniforms are `t_rand` [N,
    n_samples] when given, else drawn from `generator`."""
    t_vals = torch.linspace(0.0, 1.0, n_samples, device=near.device)
    if not lindisp:
        z_vals = near * (1.0 - t_vals) + far * t_vals
    else:
        z_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    z_vals = z_vals.expand(near.shape[0], n_samples)
    if perturb > 0.0:
        if t_rand is None:
            if generator is None:
                raise ValueError('perturb > 0 needs a generator or t_rand')
            t_rand = torch.rand(z_vals.shape, generator=generator,
                                device=z_vals.device)
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mids], dim=-1)
        z_vals = lower + (upper - lower) * t_rand
    return z_vals


def surface_z_vals(n_surface: int, gt_depth: torch.Tensor,
                   d_max: torch.Tensor | None = None) -> torch.Tensor:
    """Near-surface samples [0.95 d, 1.05 d] for pixels with depth, a sweep
    [0.001, d_max] for depth-zero pixels; `d_max` defaults to the batch
    maximum.  Returns [N, n_surface]."""
    t_vals = torch.linspace(0.0, 1.0, n_surface, device=gt_depth.device)
    d = gt_depth[..., None]
    z_surf = 0.95 * d * (1.0 - t_vals) + 1.05 * d * t_vals
    far_zero = torch.amax(gt_depth) if d_max is None else d_max
    z_zero = 0.001 * (1.0 - t_vals) + far_zero * t_vals
    has_depth = (gt_depth > 0.0)[..., None]
    return torch.where(has_depth, z_surf, z_zero[None, :])


def near_far_from_depth(rays_o: torch.Tensor, rays_d: torch.Tensor,
                        bound: torch.Tensor, gt_depth: torch.Tensor | None,
                        grad_z: bool = False,
                        d_max: torch.Tensor | None = None):
    """near/far [N, 1] per ray.

    With sensor depth: near = 0.01 d, far = clamp(bbox exit + 0.01, 0,
    1.2 d_max).  Without: near = 0.01, far = bbox exit + 0.01.  Unless
    `grad_z`, the bbox exit is computed on detached rays (the reference's
    gradient semantics)."""
    if not grad_z:
        rays_o = rays_o.detach()
        rays_d = rays_d.detach()
    far_bb = ray_bound_exit(rays_o, rays_d, bound)[..., None] + 0.01
    if gt_depth is None:
        return torch.full_like(far_bb, 0.01), far_bb
    d = gt_depth.reshape(-1, 1)
    near = d * 0.01
    hi = (torch.amax(d) if d_max is None else d_max) * 1.2
    far = torch.minimum(torch.clamp(far_bb, min=0.0), hi)
    return near, far


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               *, u: torch.Tensor | None = None, det: bool = False,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """Inverse-CDF importance sampling (NeRF hierarchical sampling):
    [N, n_samples] new depths from the interval weights [N, M-1] over the
    bin edges `bins` [N, M], detached.

    The uniforms are `u` [N, n_samples] when given; else with `det` the
    evenly spaced linspace(0, 1), else drawn from `generator`.  The bin of
    each u is the count of cdf entries <= u (`searchsorted` with
    right=True); an interval of cdf width below 1e-5 keeps its lower edge.
    """
    weights = weights.detach() + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    shape = cdf.shape[:-1] + (n_samples,)
    if u is None:
        if det:
            u = torch.linspace(0.0, 1.0, n_samples,
                               device=cdf.device).expand(shape)
        else:
            if generator is None:
                raise ValueError('stochastic sample_pdf needs a generator '
                                 'or u')
            u = torch.rand(shape, generator=generator, device=cdf.device)
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    bins = bins.detach()
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bins_b = torch.gather(bins, -1, below)
    bins_a = torch.gather(bins, -1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of x over mask, lower-middle convention (the sorted element at
    (k-1)//2 of the k valid entries)."""
    big = torch.where(mask, x, torch.full_like(x, float('inf')))
    srt = torch.sort(big).values
    k = mask.sum()
    idx = torch.clamp(k - 1, min=0) // 2
    return srt[idx]
