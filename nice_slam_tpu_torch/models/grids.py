"""Hierarchical feature-grid volumes (L1 state); port of
`nice_slam_tpu/models/grids.py`.

Volumes are flat [Nx*Ny*Nz, c_dim] float32 tensors (x-major, channel-last);
their (nx, ny, nz) shapes come from `grid_shapes`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from nice_slam_tpu_torch.ops.trilinear import ExpandedGrid, expand_grid


class GridConfig(NamedTuple):
    """Static grid geometry (config `grid_len.*`, `model.*`,
    `mapping.bound`)."""

    bound: tuple[tuple[float, float], ...]  # [3][2], after rounding
    coarse_grid_len: float = 2.0
    middle_grid_len: float = 0.32
    fine_grid_len: float = 0.16
    color_grid_len: float = 0.16
    c_dim: int = 32
    coarse_bound_enlarge: float = 2.0
    coarse: bool = True

    @property
    def bound_np(self) -> np.ndarray:
        return np.asarray(self.bound, dtype=np.float32)

    @property
    def coarse_bound_np(self) -> np.ndarray:
        return self.bound_np * self.coarse_bound_enlarge


def round_bound(raw_bound, bound_divisible: float, scale: float = 1.0
                ) -> tuple[tuple[float, float], ...]:
    """Scale the bound and round each upper edge up so the extent divides
    `bound_divisible`."""
    b = np.asarray(raw_bound, dtype=np.float64) * scale
    extent = b[:, 1] - b[:, 0]
    b[:, 1] = (np.floor(extent / bound_divisible).astype(np.int64) + 1) \
        * bound_divisible + b[:, 0]
    return tuple((float(lo), float(hi)) for lo, hi in b)


def grid_shapes(cfg: GridConfig) -> dict[str, tuple[int, int, int]]:
    """Voxel counts per volume, int(extent / grid_len); the coarse volume
    spans the enlarged bound."""
    b = cfg.bound_np
    extent = b[:, 1] - b[:, 0]
    shapes = {
        'middle': tuple(int(v) for v in extent / cfg.middle_grid_len),
        'fine': tuple(int(v) for v in extent / cfg.fine_grid_len),
        'color': tuple(int(v) for v in extent / cfg.color_grid_len),
    }
    if cfg.coarse:
        shapes['coarse'] = tuple(
            int(v) for v in extent * cfg.coarse_bound_enlarge
            / cfg.coarse_grid_len)
    return shapes


def static_grid_shapes(cfg: GridConfig) -> tuple:
    """((name, (nx, ny, nz)), ...) sorted by name."""
    return tuple(sorted(grid_shapes(cfg).items()))


def init_grids(cfg: GridConfig, *, generator: torch.Generator, device
               ) -> dict[str, torch.Tensor]:
    """Flat volumes ~ N(0, 0.01), the fine one N(0, 0.0001)."""
    stds = {'coarse': 0.01, 'middle': 0.01, 'fine': 0.0001, 'color': 0.01}
    grids = {}
    for name, (nx, ny, nz) in sorted(grid_shapes(cfg).items()):
        grids[name] = torch.randn((nx * ny * nz, cfg.c_dim),
                                  generator=generator,
                                  device=device) * stds[name]
    return grids


# Which volumes each render stage samples (models/decoders.nice_eval).
STAGE_NEEDS = {
    'coarse': ('coarse',),
    'middle': ('middle',),
    'fine': ('middle', 'fine'),
    'color': ('middle', 'fine', 'color'),
}


def prepare_grids(grids: dict, grid_shapes_t: tuple,
                  stage: str | None = None) -> dict:
    """Corner-expand the volumes `stage` samples (all when None), for the
    one-gathered-row-per-point path (ops/trilinear.ExpandedGrid).

    The expansion is differentiable (its backward is the fold), so the
    mapper calls this on every iteration and the tracker once per mapping
    commit.  Volumes the stage does not sample pass through unexpanded.
    When fine and color are both needed and share a shape they are
    concatenated channel-wise into one 'finecolor' buffer first, so one
    gathered row serves both; the gradient flows back through the concat
    to both volumes.
    """
    shapes = dict(grid_shapes_t)
    need = set(STAGE_NEEDS[stage] if stage is not None else grids)
    fuse = ('fine' in need and 'color' in need
            and 'fine' in grids and 'color' in grids
            and not isinstance(grids['fine'], ExpandedGrid)
            and not isinstance(grids['color'], ExpandedGrid)
            and shapes.get('fine') == shapes.get('color'))
    out = {}
    for name, g in grids.items():
        if fuse and name in ('fine', 'color'):
            continue
        if name not in need or isinstance(g, ExpandedGrid):
            out[name] = g
        else:
            out[name] = expand_grid(g, shapes[name])
    if fuse:
        both = torch.cat([grids['fine'], grids['color']], dim=-1)
        out['finecolor'] = expand_grid(both, shapes['fine'])
    return out


def grid_world_coords(cfg: GridConfig, name: str) -> np.ndarray:
    """World coordinates of every grid node, [Nx, Ny, Nz, 3]: nodes span
    the bound inclusively (linspace), the coarse one the enlarged bound."""
    nx, ny, nz = grid_shapes(cfg)[name]
    b = cfg.coarse_bound_np if name == 'coarse' else cfg.bound_np
    xs = np.linspace(b[0, 0], b[0, 1], nx)
    ys = np.linspace(b[1, 0], b[1, 1], ny)
    zs = np.linspace(b[2, 0], b[2, 1], nz)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing='ij')
    return np.stack([gx, gy, gz], axis=-1).astype(np.float32)
