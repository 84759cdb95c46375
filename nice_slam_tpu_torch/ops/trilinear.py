"""Trilinear feature-grid interpolation; port of
`nice_slam_tpu/ops/trilinear.py`.

Semantics of `F.grid_sample(mode='bilinear', padding_mode='border',
align_corners=True)` on grids stored flat as [Nx*Ny*Nz, C] (x-major,
channel-last): a normalized coordinate u in [-1, 1] maps to voxel index
(u+1)/2 * (N-1), clamped to the grid.

The main path samples `ExpandedGrid`s: `expand_grid` builds E[m] = the 8
clamped corner rows of voxel m ([M, 8C], ops/expand.py), so a point needs
one gathered row instead of eight: the row-gather kernel of ops/gather.py,
whose backward is the scatter-add kernel.  Whether the H100 would rather
gather the 8 corners directly is a question for measurements on the card
(chip_smoke.py times both); the layout carries over because the parity
tests need it.
"""

from __future__ import annotations

import dataclasses

import torch

from nice_slam_tpu_torch.ops.expand import ExpandCorners
from nice_slam_tpu_torch.ops.gather import GatherRows, gather_rows


@dataclasses.dataclass(frozen=True)
class ExpandedGrid:
    """Corner-expanded grid: e[m] holds voxel m's 8 corner features in
    (dx, dy, dz)-major order ([M, 8C]); shape is (nx, ny, nz)."""

    e: torch.Tensor
    shape: tuple[int, int, int]


def normalize_coords(p: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """World points [..., 3] -> [-1, 1] within the [3, 2] bound."""
    lo = bound[:, 0]
    hi = bound[:, 1]
    return (p - lo) / (hi - lo) * 2.0 - 1.0


def _voxel_coords(p_nor: torch.Tensor, shape: tuple[int, int, int]):
    """Clamped continuous voxel index [N, 3] -> (floor as int64, frac)."""
    cols = [torch.clamp((p_nor[:, a] + 1.0) * 0.5 * (n - 1.0), 0.0, n - 1.0)
            for a, n in enumerate(shape)]
    idx = torch.stack(cols, dim=-1)
    i0 = torch.floor(idx)
    return i0.long(), idx - i0


def trilinear_interp(grid: torch.Tensor, p_nor: torch.Tensor,
                     shape: tuple[int, int, int]) -> torch.Tensor:
    """Interpolate a flat [M, C] grid of `shape` at normalized points [N, 3]
    (8 gathered corner rows per point) -> [N, C]."""
    nx, ny, nz = shape
    i0, frac = _voxel_coords(p_nor, shape)
    x0, y0, z0 = i0.unbind(-1)
    x1 = torch.clamp(x0 + 1, max=nx - 1)
    y1 = torch.clamp(y0 + 1, max=ny - 1)
    z1 = torch.clamp(z0 + 1, max=nz - 1)
    fx, fy, fz = frac[:, 0:1], frac[:, 1:2], frac[:, 2:3]

    def corner(xi, yi, zi):
        return grid[(xi * ny + yi) * nz + zi]

    c00 = corner(x0, y0, z0) * (1 - fz) + corner(x0, y0, z1) * fz
    c01 = corner(x0, y1, z0) * (1 - fz) + corner(x0, y1, z1) * fz
    c10 = corner(x1, y0, z0) * (1 - fz) + corner(x1, y0, z1) * fz
    c11 = corner(x1, y1, z0) * (1 - fz) + corner(x1, y1, z1) * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


def expand_grid(grid: torch.Tensor, shape: tuple[int, int, int]
                ) -> ExpandedGrid:
    """Differentiable corner expansion of a flat [M, C] grid: the CUDA
    kernels for a CUDA tensor (backward = the fold kernel), the plain
    version for a CPU tensor."""
    shape = tuple(int(v) for v in shape)
    return ExpandedGrid(ExpandCorners.apply(grid, shape), shape)


def trilinear_interp_expanded(eg: ExpandedGrid, p_nor: torch.Tensor
                              ) -> torch.Tensor:
    """Interpolate an `ExpandedGrid` at normalized points [N, 3]: one
    gathered [8C] row per point -> [N, C].  The gather is the CUDA kernel
    for a CUDA tensor (backward = the scatter-add kernel), the plain
    version for a CPU tensor."""
    nx, ny, nz = eg.shape
    c = eg.e.shape[-1] // 8
    i0, frac = _voxel_coords(p_nor, eg.shape)
    m = (i0[:, 0] * ny + i0[:, 1]) * nz + i0[:, 2]
    if torch.is_grad_enabled() and eg.e.requires_grad:
        rows = GatherRows.apply(eg.e, m)
    else:   # no gradient to the table (the tracker's snapshot): no node
        rows = gather_rows(eg.e, m)
    rows = rows.reshape(-1, 2, 2, 2, c)
    fx = frac[:, 0].reshape(-1, 1, 1, 1, 1)
    fy = frac[:, 1].reshape(-1, 1, 1, 1, 1)
    fz = frac[:, 2].reshape(-1, 1, 1, 1, 1)
    wx = torch.cat([1.0 - fx, fx], dim=1)
    wy = torch.cat([1.0 - fy, fy], dim=2)
    wz = torch.cat([1.0 - fz, fz], dim=3)
    return (rows * (wx * wy * wz)).sum(dim=(1, 2, 3))


def sample_grid_feature(grid: torch.Tensor | ExpandedGrid, p: torch.Tensor,
                        bound: torch.Tensor,
                        shape: tuple[int, int, int] | None = None
                        ) -> torch.Tensor:
    """World points [N, 3] -> interpolated features [N, C] from a flat grid
    of `shape`, an `ExpandedGrid` or a blocked volume
    (`parallel.blocks.BlockedGrid`), normalized within `bound`."""
    p_nor = normalize_coords(p, bound)
    if isinstance(grid, ExpandedGrid):
        return trilinear_interp_expanded(grid, p_nor)
    if hasattr(grid, 'slab_h'):   # parallel/blocks.py imports this module
        from nice_slam_tpu_torch.parallel.blocks import (
            trilinear_interp_blocked)
        return trilinear_interp_blocked(grid, p_nor)
    return trilinear_interp(grid, p_nor, shape)
