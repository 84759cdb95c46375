"""Grid-block tensor parallelism: the feature volumes split into x-slabs
over the ranks of a block group, with a one-plane halo for the trilinear
stencil; port of `nice_slam_tpu/parallel/blocks.py`.

The flat [M, C] volumes are x-major, so a contiguous row range is an
x-slab.  The stencil reads planes x0 and x0 + 1, so a slab plus ONE halo
plane (the next block's first plane) makes every interpolation whose base
cell lies in the slab local.  On a 2-D grid of ranks (`mesh.make_block_grid`:
block x rays):

* every rank draws the rays of its ray share; the ranks of a block group
  (one per block, the same ray share) see the same rays;
* each rank interpolates the points whose base cell lies in its slab (the
  others give zeros) and a sum over the block group assembles the features,
  the forward pass's only exchange between blocks;
* the decoders then run replicated over the block group; in the backward
  pass every rank gets the whole feature gradient, so its slab gradient is
  exact and local, and the halo plane's gradient goes back to the plane's
  owner (`HaloExchange.backward`); the point gradient is summed over the
  block group, like the forward features, so the pose gradients stay
  replicated;
* the slab, pose and decoder gradients are then summed over the ray group
  (the ranks of one block), as in the ray-sharded step.

The halo exchange is an all-gather of every block's first plane built from
`all_reduce` (gloo has no point-to-point send for CUDA tensors), so it runs
on gloo over the CPU, gloo on a shared card and NCCL alike.  The row
lookups are `ops/gather.gather_rows` and `scatter_add_rows`: the port's
kernels on the card.  The corner weighting and the point gradient's
contractions are products at the session's matmul precision
(`BlockedGrid.precision`, models/precision.py), rounded where the JAX
package's `jnp.einsum` puts its `dot_general`s.
"""

from __future__ import annotations

import dataclasses

import torch

from nice_slam_tpu_torch.engine.mapper import (
    as_map_draws, draw_map_iteration, map_iterations)
from nice_slam_tpu_torch.models.precision import SESSION_KEY, matmul, passes
from nice_slam_tpu_torch.ops.gather import gather_rows, scatter_add_rows
from nice_slam_tpu_torch.parallel.mesh import RankGroup


@dataclasses.dataclass(frozen=True)
class BlockedGrid:
    """This rank's view of a blocked volume.

    slab_h: [(local_nx + 1) * ny * nz, C], the owned x-slab with the next
    block's first plane appended (x-major rows); x_start: the global x index
    of the slab's first plane; shape: the true (nx, ny, nz), so border
    clamping matches the whole volume; local_nx: planes per block (nx padded
    up to a multiple of the block count); group: the block group;
    precision: the session's matmul precision (None: float32)."""

    slab_h: torch.Tensor
    x_start: int
    shape: tuple[int, int, int]
    local_nx: int
    group: RankGroup
    precision: str | None = None


class HaloExchange(torch.autograd.Function):
    """slab [local_nx * ny * nz, C] -> slab with the next block's first
    plane appended.  The last block receives the first block's plane, which
    it never reads (its points clamp inside it), so that plane's gradient
    is zero.  Backward: the halo plane's gradient is added to its owner's
    first plane."""

    @staticmethod
    def forward(ctx, slab: torch.Tensor, plane: int, group: RankGroup):
        ctx.plane, ctx.group = plane, group
        firsts = group.all_gather_tiled(slab[:plane].contiguous())
        nxt = (group.rank + 1) % group.size
        return torch.cat([slab, firsts[nxt * plane:(nxt + 1) * plane]])

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        plane, group = ctx.plane, ctx.group
        grad_slab = grad[:-plane].clone()
        halos = group.all_gather_tiled(grad[-plane:].contiguous())
        prev = (group.rank - 1) % group.size
        grad_slab[:plane] += halos[prev * plane:(prev + 1) * plane]
        return grad_slab, None, None


def halo_exchange(slab: torch.Tensor, ny: int, nz: int, group: RankGroup
                  ) -> torch.Tensor:
    """Append the next block's first x-plane to `slab` [local_nx * ny *
    nz, C] (differentiable; see `HaloExchange`)."""
    return HaloExchange.apply(slab, ny * nz, group)


def make_blocked(slab: torch.Tensor, shape: tuple[int, int, int],
                 local_nx: int, group: RankGroup,
                 precision: str | None = None) -> BlockedGrid:
    """This rank's slab as a `BlockedGrid` (the halo exchanged)."""
    _, ny, nz = shape
    return BlockedGrid(halo_exchange(slab, ny, nz, group),
                       group.rank * local_nx, tuple(shape), local_nx, group,
                       precision)


def _corner_geometry(shape, local_nx: int, x_start: int,
                     p_nor: torch.Tensor):
    """Local corner rows [N, 8] ((dx, dy, dz)-major), lerp fractions [N,
    3], the ownership mask [N], the unclipped mask [N, 3] and the sizes."""
    nx, ny, nz = shape
    sizes = torch.tensor([nx, ny, nz], dtype=p_nor.dtype,
                         device=p_nor.device)
    raw = (p_nor + 1.0) * 0.5 * (sizes - 1.0)
    idx = torch.minimum(torch.clamp(raw, min=0.0), sizes - 1.0)
    in_range = (raw >= 0.0) & (raw <= sizes - 1.0)
    i0f = torch.floor(idx)
    frac = idx - i0f
    i0 = i0f.long()
    top = torch.tensor([nx - 1, ny - 1, nz - 1], device=p_nor.device)
    i1 = torch.minimum(i0 + 1, top)
    x0g = i0[:, 0]
    mine = (x0g >= x_start) & (x0g < x_start + local_nx)
    # local x offsets; x1 may land on the halo plane (offset local_nx)
    x0 = torch.clamp(x0g - x_start, 0, local_nx)
    x1 = torch.clamp(i1[:, 0] - x_start, 0, local_nx)
    rows = torch.stack([(x * ny + y) * nz + z
                        for x in (x0, x1)
                        for y in (i0[:, 1], i1[:, 1])
                        for z in (i0[:, 2], i1[:, 2])], dim=1)
    return rows, frac, mine, in_range, sizes


def _axis_weights(frac: torch.Tensor):
    fx, fy, fz = frac[:, 0:1], frac[:, 1:2], frac[:, 2:3]
    return (torch.cat([1.0 - fx, fx], 1), torch.cat([1.0 - fy, fy], 1),
            torch.cat([1.0 - fz, fz], 1))


def _weighted_corners(feats: torch.Tensor, w: torch.Tensor,
                      precision: str | None) -> torch.Tensor:
    """einsum('nkc,nk->nc', feats [N, 8, C], w [N, 8]) at `precision`:
    one product over k per point."""
    if passes(precision, SESSION_KEY) == 0:
        return torch.einsum('nkc,nk->nc', feats, w)
    return matmul(w[:, None, :], feats, precision)[:, 0]


def _axis_gradient(diff: torch.Tensor, wa: torch.Tensor, wb: torch.Tensor,
                   ct: torch.Tensor, precision: str | None) -> torch.Tensor:
    """einsum('nabc,na,nb,nc->n', diff [N, 2, 2, C], wa, wb [N, 2],
    ct [N, C]) at `precision`, along the JAX einsum's contraction path:
    e = diff.ct over c, f = wb (x) wa (a product over no index), then e.f
    over (a, b), each product rounded."""
    if passes(precision, SESSION_KEY) == 0:
        return torch.einsum('nabc,na,nb,nc->n', diff, wa, wb, ct)
    n = diff.shape[0]
    e = matmul(diff.reshape(n, 4, -1), ct[:, :, None], precision)
    f = matmul(wb[:, :, None], wa[:, None, :], precision)      # [N, b, a]
    return matmul(e.reshape(n, 1, 4), f.transpose(1, 2).reshape(n, 4, 1),
                  precision)[:, 0, 0]


class BlockedInterp(torch.autograd.Function):
    """Trilinear interpolation of normalized points [N, 3] against a
    blocked volume, with the gradient routing of the module note: forward,
    the owned points' 8 gathered corners (`gather_rows`) weighted and
    summed over the block group; backward, the slab gradient a local
    `scatter_add_rows` of the owned points' weighted gradients, the point
    gradient computed where the features live and summed over the block
    group."""

    @staticmethod
    def forward(ctx, slab_h, p_nor, shape, local_nx, x_start, group,
                precision):
        rows, frac, mine, in_range, sizes = _corner_geometry(
            shape, local_nx, x_start, p_nor)
        wx, wy, wz = _axis_weights(frac)
        w = (wx[:, :, None, None] * wy[:, None, :, None]
             * wz[:, None, None, :]).reshape(-1, 8)
        c = slab_h.shape[1]
        flat_rows = rows.reshape(-1).contiguous()
        feats = gather_rows(slab_h, flat_rows).reshape(-1, 8, c)
        out = _weighted_corners(feats, w, precision)
        out = torch.where(mine[:, None], out, torch.zeros_like(out))
        out, = group.sum_list([out])
        ctx.save_for_backward(slab_h, flat_rows, w, frac, mine, in_range,
                              sizes)
        ctx.group, ctx.precision = group, precision
        return out

    @staticmethod
    def backward(ctx, ct):
        slab_h, flat_rows, w, frac, mine, in_range, sizes = ctx.saved_tensors
        c = slab_h.shape[1]
        ct_owned = torch.where(mine[:, None], ct, torch.zeros_like(ct))
        d_slab = None
        if ctx.needs_input_grad[0]:
            d_slab = scatter_add_rows(
                (w[:, :, None] * ct_owned[:, None, :]).reshape(-1, c)
                .contiguous(), flat_rows, slab_h.shape[0])
        d_p = None
        if ctx.needs_input_grad[1]:
            feats = gather_rows(slab_h, flat_rows).reshape(-1, 2, 2, 2, c)
            wx, wy, wz = _axis_weights(frac)
            prec = ctx.precision
            gx = _axis_gradient(feats[:, 1] - feats[:, 0], wy, wz,
                                ct_owned, prec)
            gy = _axis_gradient(feats[:, :, 1] - feats[:, :, 0], wx, wz,
                                ct_owned, prec)
            gz = _axis_gradient(feats[:, :, :, 1] - feats[:, :, :, 0], wx,
                                wy, ct_owned, prec)
            d_idx = torch.stack([gx, gy, gz], dim=-1)
            d_p = d_idx * in_range.to(d_idx.dtype) * 0.5 * (sizes - 1.0)
            d_p, = ctx.group.sum_list([d_p])
        return d_slab, d_p, None, None, None, None, None


def trilinear_interp_blocked(bg: BlockedGrid, p_nor: torch.Tensor
                             ) -> torch.Tensor:
    """Trilinear interpolation (align_corners, border clamp) against a
    blocked volume: `ops.trilinear.trilinear_interp`'s values up to the
    order of the sums; see `BlockedInterp` for the gradients."""
    return BlockedInterp.apply(bg.slab_h, p_nor, bg.shape, bg.local_nx,
                               bg.x_start, bg.group, bg.precision)


def plan_blocks(grid_shapes_t: tuple, n_block: int) -> dict[str, dict]:
    """Per volume {'shape', 'local_nx', 'nx_pad', 'rows_pad'}: nx_pad =
    local_nx * n_block >= nx.  Padded planes hold zeros and are never read
    (points clamp to the true nx), so their gradients stay zero."""
    plan = {}
    for name, (nx, ny, nz) in dict(grid_shapes_t).items():
        local_nx = -(-nx // n_block)
        nx_pad = local_nx * n_block
        plan[name] = {'shape': (nx, ny, nz), 'local_nx': local_nx,
                      'nx_pad': nx_pad, 'rows_pad': nx_pad * ny * nz}
    return plan


def pad_for_blocks(flat_grids: dict, plan: dict) -> dict:
    """Zero-pad flat [M, C] volumes to the blocked row count."""
    return {name: torch.nn.functional.pad(
        g, (0, 0, 0, plan[name]['rows_pad'] - g.shape[0]))
        for name, g in flat_grids.items()}


def unpad_from_blocks(padded: dict, plan: dict, grid_shapes_t: tuple
                      ) -> dict:
    """Strip the block padding back off."""
    shapes = dict(grid_shapes_t)
    return {name: g[:shapes[name][0] * shapes[name][1] * shapes[name][2]]
            for name, g in padded.items()}


def block_slab(padded: torch.Tensor, entry: dict, block: int
               ) -> torch.Tensor:
    """Block `block`'s x-slab of a padded flat volume (plan entry
    `entry`)."""
    _, ny, nz = entry['shape']
    n = entry['local_nx'] * ny * nz
    return padded[block * n:(block + 1) * n]


def blocked_map_step(decoders, slabs: dict, cams: torch.Tensor, *,
                     block_group: RankGroup, rays_group: RankGroup,
                     plan: dict, pix_per_frame: int, draws=None,
                     generator: torch.Generator | None = None, **kw):
    """`engine.mapper.map_step` with the volumes split into x-slabs over
    `block_group` and the rays over `rays_group` (`mesh.make_block_grid`).

    slabs: {name: this rank's slab leaf of the padded volume
    (`pad_for_blocks`, `block_slab`)}, updated in place; masks, when
    given, are sliced the same way.  Each rank renders pix_per_frame //
    rays_group.size pixels a frame: `draws[it]`, or drawn from `generator`
    (the same stream on the ranks of one block group).  The slab, pose and
    decoder gradients are summed over `rays_group`.  Returns map_step's
    (cams [F, 7], losses)."""
    if kw['model'].kind != 'nice':
        raise ValueError('blocked mapping splits NICE feature volumes')
    local = max(pix_per_frame // rays_group.size, 1)
    n_frames = cams.shape[0]

    def draw(it):
        if draws is not None:
            return as_map_draws(draws[it])
        return draw_map_iteration(n_frames, local, kw['intr'], kw['rcfg'],
                                  generator=generator, device=cams.device)

    def prepare(grids, stage):
        # every volume, in name order on every rank: the halo exchanges
        # are collectives over the block group
        return {name: make_blocked(grids[name], plan[name]['shape'],
                                   plan[name]['local_nx'], block_group,
                                   kw['model'].matmul_precision)
                for name in sorted(grids)}

    return map_iterations(decoders, slabs, cams, pix_per_frame=local,
                          draw=draw, reduce=rays_group.sum_list,
                          prepare=prepare, **kw)
