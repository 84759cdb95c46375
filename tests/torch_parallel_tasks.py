"""Rank-side tasks of tests/test_torch_parallel.py (run by
tests/torch_rank_pool.py in gloo CPU processes; no JAX here).

Each task takes the world's group and numpy inputs and returns numpy
results.  The world has four ranks; the two-rank cases run on the pairs
(0, 1) and (2, 3) at once, so every two-rank result comes twice."""

from __future__ import annotations

import numpy as np
import torch

from nice_slam_tpu_torch.core.cameras import Intrinsics
from nice_slam_tpu_torch.engine import mapper as tm
from nice_slam_tpu_torch.engine.tracker import TrackerConfig
from nice_slam_tpu_torch.models.convert import (
    decoders_from_numpy, grids_from_numpy)
from nice_slam_tpu_torch.models.decoders import DecoderConfig
from nice_slam_tpu_torch.ops.trilinear import trilinear_interp
from nice_slam_tpu_torch.parallel import blocks, distributed, sharded
from nice_slam_tpu_torch.parallel.mesh import make_block_grid
from nice_slam_tpu_torch.render.renderer import (
    RenderConfig, SceneModel, eval_raw)


def _t(x):
    return None if x is None else torch.tensor(np.asarray(x))


def _np(x):
    return None if x is None else x.detach().cpu().numpy()


def group_of(world, ranks: int):
    """The whole world (ranks == its size) or this rank's pair."""
    if ranks == world.size:
        return world
    return world.split([[0, 1], [2, 3]], tag='pair')


def build(spec: dict):
    """The port's model, decoders and grid leaves from a spec of numpy
    parameters (tests/test_torch_parallel.py `spec_of`)."""
    dcfg = DecoderConfig(**spec['dcfg'])
    model = SceneModel(decoder=dcfg, bound=_t(spec['bound']),
                       coarse_bound=_t(spec.get('coarse_bound')),
                       grid_shapes=spec.get('grid_shapes', ()),
                       kind=spec['kind'])
    decs = decoders_from_numpy(spec['params'], dcfg)
    grids = grids_from_numpy(spec['grids']) if spec.get('grids') else {}
    for g in grids.values():
        g.requires_grad_(True)
    return model, decs, grids


def _draws(seq):
    """Per-iteration MapDraws (or tracker tuples) from numpy tuples."""
    return [tm.MapDraws(*(_t(x) for x in d)) for d in seq]


# -- bring-up and collectives -----------------------------------------------

def bring_up(world):
    import os
    return dict(rank=world.rank, size=world.size, backend=world.backend,
                device=str(world.device),
                process_id=int(os.environ['NSTPU_PROCESS_ID']),
                initialized=torch.distributed.is_initialized())


def collectives(world, seed: int):
    rng = np.random.default_rng(seed + world.rank)
    a = rng.normal(size=(3, 4)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    s = np.float32(rng.normal())
    summed = world.sum_list([_t(a), None, _t(b), torch.tensor(s)])
    piece = rng.normal(size=(2, 3)).astype(np.float32)
    gathered = world.all_gather_tiled(_t(piece))
    mx = world.max(torch.tensor(np.float32(world.rank * 1.5 - 2.0)))
    return dict(a=a, b=b, s=s, piece=piece,
                summed=[_np(x) for x in summed], gathered=_np(gathered),
                max=float(mx), calls=world.stats.calls)


def devices_mismatch(world, cfg: dict, output: str):
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    try:
        SlamSystem(cfg, device='cpu', output=output)
    except ValueError as e:
        return str(e)
    return None


# -- steps --------------------------------------------------------------------

def track(world, spec, tcfg, intr, rcfg, color, depth, cam7, draws,
          ranks: int = 2):
    group = group_of(world, ranks)
    model, decs, grids = build(spec)
    best, last, losses = sharded.sharded_track_frame(
        decs, grids, _t(color), _t(depth), _t(cam7), group=group,
        model=model, rcfg=RenderConfig(**rcfg), tcfg=TrackerConfig(**tcfg),
        intr=Intrinsics(*intr),
        draws=[tuple(_t(x) for x in d) for d in draws])
    return dict(best=_np(best), last=_np(last), losses=_np(losses))


def _map_kwargs(spec, mcfg, rcfg, intr, lr_tab, stage_idx, cam_mask,
                trainable):
    model, decs, grids = build(spec)
    return decs, grids, dict(
        trainable=trainable, masks=None,
        cam_mask=_t(cam_mask), lr_tab=np.asarray(lr_tab),
        stage_idx=np.asarray(stage_idx), model=model,
        rcfg=RenderConfig(**rcfg), mcfg=tm.MapperConfig(**mcfg),
        intr=Intrinsics(*intr))


def _map_result(cams, losses, grids, decs):
    return dict(cams=_np(cams), losses=_np(losses),
                grids={k: _np(g) for k, g in grids.items()},
                dec={name: {k: _np(v) for k, v in m.state_dict().items()}
                     for name, m in decs.items()})


def kf_map(world, spec, mcfg, rcfg, intr, lr_tab, stage_idx, cam_mask,
           trainable, cams, colors, depths, pix, draws):
    """Keyframe-sharded mapping over the whole world; each rank holds only
    its frames' images."""
    decs, grids, kw = _map_kwargs(spec, mcfg, rcfg, intr, lr_tab, stage_idx,
                                  cam_mask, trainable)
    mine = distributed.window_slice(len(cams), world)
    out_cams, losses = distributed.kf_sharded_map_step(
        decs, grids, _t(cams), group=world, colors=_t(colors[mine]),
        depths=_t(depths[mine]), pix_per_frame=pix, draws=_draws(draws),
        **kw)
    return _map_result(out_cams, losses, grids, decs)


def ray_map(world, spec, mcfg, rcfg, intr, lr_tab, stage_idx, cam_mask,
            trainable, cams, colors, depths, pix, draws, ranks: int = 2):
    """Ray-sharded mapping; draws[r]: rank r's own per-iteration draws."""
    group = group_of(world, ranks)
    decs, grids, kw = _map_kwargs(spec, mcfg, rcfg, intr, lr_tab, stage_idx,
                                  cam_mask, trainable)
    out_cams, losses = sharded.ray_sharded_map_step(
        decs, grids, _t(cams), group=group, colors=_t(colors),
        depths=_t(depths), pix_per_frame=pix,
        draws=_draws(draws[group.rank]), **kw)
    return _map_result(out_cams, losses, grids, decs)


def blocked_map(world, spec, mcfg, rcfg, intr, lr_tab, stage_idx, cam_mask,
                trainable, cams, colors, depths, pix, draws, n_block: int):
    """Blocked mapping on an n_block x (4 / n_block) grid of ranks;
    draws[r]: ray share r's draws.  Returns this rank's slabs."""
    block_group, rays_group = make_block_grid(world, n_block)
    decs, grids, kw = _map_kwargs(spec, mcfg, rcfg, intr, lr_tab, stage_idx,
                                  cam_mask, trainable)
    plan = blocks.plan_blocks(kw['model'].grid_shapes, n_block)
    padded = blocks.pad_for_blocks(
        {k: g.detach() for k, g in grids.items()}, plan)
    slabs = {k: blocks.block_slab(padded[k], plan[k], block_group.rank)
             .clone().requires_grad_(True) for k in padded}
    out_cams, losses = blocks.blocked_map_step(
        decs, slabs, _t(cams), block_group=block_group,
        rays_group=rays_group, plan=plan, colors=_t(colors),
        depths=_t(depths), pix_per_frame=pix,
        draws=_draws(draws[rays_group.rank]), **kw)
    res = _map_result(out_cams, losses, slabs, decs)
    res['block'] = block_group.rank
    return res


def eval_points(world, spec, points, stage, ranks: int):
    group = group_of(world, ranks)
    model, decs, grids = build(spec)
    pts = _t(points)
    with torch.no_grad():
        got = sharded.sharded_eval_points(decs, grids, pts, stage, model,
                                          group)
        one = eval_raw(decs, grids, pts, stage, model)
        # one rank's queries of the ranks' slices, side by side
        per = sharded.rows_per_rank(len(pts), group.size)
        padded = torch.nn.functional.pad(pts, (0, 0, 0,
                                               per * group.size - len(pts)))
        slices = torch.cat([eval_raw(decs, grids, padded[r * per:
                                                         (r + 1) * per],
                                     stage, model)
                            for r in range(group.size)])[:len(pts)]
    return dict(sharded=_np(got), one=_np(one), slices=_np(slices))


def blocked_interp(world, grid, shape, points, cot, n_block: int):
    """Blocked interpolation and the gradient of sum(out * cot) with
    respect to this rank's slab; the unsharded values beside them."""
    block_group, _ = make_block_grid(world, n_block)
    plan = blocks.plan_blocks((('g', tuple(shape)),), n_block)['g']
    padded = blocks.pad_for_blocks({'g': _t(grid)}, {'g': plan})['g']
    slab = blocks.block_slab(padded, plan, block_group.rank).clone()
    slab.requires_grad_(True)
    p = _t(points)
    bg = blocks.make_blocked(slab, tuple(shape), plan['local_nx'],
                             block_group)
    out = blocks.trilinear_interp_blocked(bg, p)
    g_slab, = torch.autograd.grad((out * _t(cot)).sum(), [slab])
    full = _t(grid).requires_grad_(True)
    want = trilinear_interp(full, p, tuple(shape))
    g_full, = torch.autograd.grad((want * _t(cot)).sum(), [full])
    return dict(out=_np(out), want=_np(want), g_slab=_np(g_slab),
                g_full=_np(g_full), block=block_group.rank,
                local_rows=int(slab.shape[0]))
