"""Driver entry points of the port; counterpart of the JAX package's
`__graft_entry__.py`.

    entry()              -> (fn, args): a forward step of the flagship
                            model (NICE `render_rays`, color stage) on a
                            256-ray batch, on the card unless
                            `device='cpu'`.
    dryrun_multichip(n)  -> starts n ranks on torch.distributed and runs
                            one step of each parallel backend on tiny
                            shapes (ray-sharded mapping, ray-sharded
                            tracking, keyframe-sharded mapping and, for
                            n >= 2, grid-block tensor parallelism),
                            asserting finite losses.

The ranks of `dryrun_multichip` run on NCCL with one card a rank
(the default: it raises with fewer cards than n), as gloo ranks sharing one
card (`share=True`), or as gloo ranks on the CPU (`device='cpu'`).

    python -m nice_slam_tpu_torch.graft_entry [N] [--share | --device cpu]
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import torch

BOUND = ((-1.0, 1.08), (-0.8, 0.88), (-1.0, 1.08))
N_RAYS = 256
RANK_TIMEOUT_S = 600.0


def _tiny_setup(device):
    """The model of the JAX `_tiny_setup` (its bound and grid lengths,
    the default decoders, 16 + 8 samples) with decoders and volumes drawn
    from seed 0: (model, rcfg, decoders, grids)."""
    from nice_slam_tpu_torch.models.decoders import (
        DecoderConfig, init_nice_decoders)
    from nice_slam_tpu_torch.models.grids import (
        GridConfig, init_grids, static_grid_shapes)
    from nice_slam_tpu_torch.render.renderer import RenderConfig, SceneModel
    gcfg = GridConfig(bound=BOUND)
    dcfg = DecoderConfig()
    gen = torch.Generator().manual_seed(0)
    grids = {k: g.to(device) for k, g in
             init_grids(gcfg, generator=gen, device='cpu').items()}
    decoders = init_nice_decoders(dcfg, generator=gen, device='cpu').to(device)
    model = SceneModel(decoder=dcfg,
                       bound=torch.tensor(gcfg.bound_np, device=device),
                       coarse_bound=torch.tensor(gcfg.coarse_bound_np,
                                                 device=device),
                       grid_shapes=static_grid_shapes(gcfg))
    return model, RenderConfig(n_samples=16, n_surface=8), decoders, grids


def entry(device=None):
    """(fn, args): fn(decoders, grids, rays_o, rays_d, gt_depth) renders
    the rays through the NICE model (the volumes corner-expanded, then
    `render_rays` at the color stage) and returns (depth, var, color);
    args are the JAX `entry()`'s rays and sensor depth with the port's
    random decoders and volumes, on `device` (CUDA by default)."""
    from nice_slam_tpu_torch.engine.slam import resolve_device
    from nice_slam_tpu_torch.models.grids import prepare_grids
    from nice_slam_tpu_torch.render.renderer import render_rays
    device = resolve_device(device)
    model, rcfg, decoders, grids = _tiny_setup(device)
    rays_o = torch.zeros((N_RAYS, 3), device=device) + torch.tensor(
        [0.1, 0.0, 0.0], device=device)
    th = torch.linspace(-0.5, 0.5, N_RAYS, device=device)
    rays_d = torch.stack([torch.sin(th), 0.1 * torch.cos(3 * th),
                          -torch.cos(th)], dim=-1)
    gt_depth = torch.full((N_RAYS,), 0.9, device=device)

    def fn(decoders, grids, rays_o, rays_d, gt_depth):
        with torch.no_grad():
            exp = prepare_grids(grids, model.grid_shapes, stage='color')
            depth, var, color, _ = render_rays(
                decoders, exp, rays_o, rays_d, stage='color', model=model,
                rcfg=rcfg, gt_depth=gt_depth)
        return depth, var, color

    return fn, (decoders, grids, rays_o, rays_d, gt_depth)


# ---------------------------------------------------------------------------
# dryrun_multichip
# ---------------------------------------------------------------------------

def _losses(x: torch.Tensor) -> list:
    x = x.detach().cpu().numpy()
    if not np.isfinite(x).all():
        raise AssertionError(f'non-finite losses {x}')
    return [round(float(v), 2) for v in x]


def _rank_steps(world) -> list[str]:
    """One step of each parallel backend on this rank (the JAX dry run's
    shapes: a 24x32 frame, 8 pixels a rank, 3 iterations); returns the
    lines to print."""
    from nice_slam_tpu_torch.core.cameras import Intrinsics
    from nice_slam_tpu_torch.engine.mapper import (
        MapperConfig, lr_table, stage_schedule)
    from nice_slam_tpu_torch.engine.tracker import TrackerConfig
    from nice_slam_tpu_torch.parallel import blocks, distributed, sharded
    from nice_slam_tpu_torch.parallel.mesh import make_block_grid
    n, dev = world.size, world.device
    model, rcfg, decs, grids = _tiny_setup(dev)
    intr = Intrinsics(H=24, W=32, fx=16.0, fy=16.0, cx=15.5, cy=11.5)
    stage_lr = tuple((s, (0.005, 0.001, 0.1, 0.005, 0.005))
                     for s in ('coarse', 'middle', 'fine', 'color'))
    mcfg = MapperConfig(pixels=8 * n, iters=3, stage_lr=stage_lr,
                        fix_fine=False, fix_color=False, train_middle=True,
                        ba=True)
    n_frames, n_iters = 2, 3
    cam = torch.tensor([1.0, 0, 0, 0, 0.1, 0, 0], device=dev)
    colors = torch.full((n, intr.H, intr.W, 3), 0.5, device=dev)
    depths = torch.full((n, intr.H, intr.W), 0.9, device=dev)
    kw = dict(trainable=('color', 'fine', 'middle'), masks=None,
              lr_tab=lr_table(mcfg, n_iters, 1.0, True),
              stage_idx=stage_schedule(mcfg, n_iters), model=model,
              rcfg=rcfg, mcfg=mcfg, intr=intr)
    gen = torch.Generator(device=dev).manual_seed(world.rank)
    lines = []

    def fresh():
        import copy
        return (copy.deepcopy(decs),
                {k: g.clone().requires_grad_(True) for k, g in grids.items()})

    # ray-sharded mapping: each rank draws its own share of the rays
    d, g = fresh()
    _, losses = sharded.ray_sharded_map_step(
        d, g, cam.repeat(n_frames, 1), group=world,
        colors=colors[:n_frames], depths=depths[:n_frames],
        cam_mask=torch.tensor([0.0, 1.0], device=dev),
        pix_per_frame=mcfg.pixels // n_frames, generator=gen, **kw)
    lines.append(f'ray-sharded ok, losses={_losses(losses)}')

    # ray-sharded tracking: the same global batch on every rank
    tcfg = TrackerConfig(pixels=8 * n, iters=3, cam_lr=0.01,
                         ignore_edge_w=2, ignore_edge_h=2, var_floor=1e-4)
    tgen = torch.Generator(device=dev).manual_seed(0)
    best, _, losses = sharded.sharded_track_frame(
        decs, grids, colors[0], depths[0], cam, group=world, model=model,
        rcfg=rcfg, tcfg=tcfg, intr=intr, generator=tgen)
    if not torch.isfinite(best).all():
        raise AssertionError(f'non-finite pose {best}')
    lines.append(f'ray-sharded tracking ok, losses={_losses(losses)}')

    # keyframe-sharded mapping: a window of one frame a rank
    d, g = fresh()
    mine = distributed.window_slice(n, world)
    kgen = torch.Generator(device=dev).manual_seed(0)
    _, losses = distributed.kf_sharded_map_step(
        d, g, cam.repeat(n, 1), group=world, colors=colors[mine],
        depths=depths[mine],
        cam_mask=torch.ones(n, device=dev).index_fill_(0, torch.tensor(
            [0], device=dev), 0.0),
        pix_per_frame=8, generator=kgen, **kw)
    lines.append(f'kf-sharded (window of {n} frames over {n} devices) ok, '
                 f'losses={_losses(losses)}')

    if n >= 2:
        # grid-block TP on a block x rays grid of the ranks
        n_block = 2 if n < 8 else 4
        block_group, rays_group = make_block_grid(world, n_block,
                                                  tag='dryrun')
        plan = blocks.plan_blocks(model.grid_shapes, n_block)
        padded = blocks.pad_for_blocks(grids, plan)
        slabs = {k: blocks.block_slab(padded[k], plan[k], block_group.rank)
                 .clone().requires_grad_(True) for k in padded}
        bgen = torch.Generator(device=dev).manual_seed(rays_group.rank)
        d, _ = fresh()
        _, losses = blocks.blocked_map_step(
            d, slabs, cam.repeat(n_frames, 1), block_group=block_group,
            rays_group=rays_group, plan=plan, colors=colors[:n_frames],
            depths=depths[:n_frames],
            cam_mask=torch.tensor([0.0, 1.0], device=dev),
            pix_per_frame=mcfg.pixels // n_frames, generator=bgen, **kw)
        lines.append(f'blocked-TP (block={n_block} x rays='
                     f'{n // n_block}) ok, losses={_losses(losses)}')
    return lines


def _rank_main() -> int:
    """A rank's body (NSTPU_* set by `dryrun_multichip`)."""
    from nice_slam_tpu_torch.parallel.distributed import (
        initialize_from_env, shutdown)
    world = initialize_from_env()
    try:
        lines = _rank_steps(world)
        if world.device.type == 'cuda':
            torch.cuda.synchronize(world.device)
    finally:
        shutdown()
    if world.rank == 0:
        for line in lines:
            print(f'dryrun_multichip({world.size}): {line}', flush=True)
    return 0


def dryrun_multichip(n_devices: int, *, device=None, share: bool = False
                     ) -> str:
    """Run `_rank_steps` on `n_devices` ranks, one process each, and print
    rank 0's report; returns the backend the ranks ran on ('nccl' or
    'gloo').  CUDA needs a card a rank unless `share` (gloo ranks on the
    current card); `device='cpu'` runs gloo ranks on the CPU.  Raises
    when a rank fails."""
    cpu = device is not None and torch.device(device).type == 'cpu'
    env = dict(os.environ)
    for key in ('NSTPU_CPU_SIM', 'NSTPU_LOCAL_DEVICES'):
        env.pop(key, None)
    if cpu:
        env.update(NSTPU_CPU_SIM='1', OMP_NUM_THREADS='1')
        backend = 'gloo'
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: no CUDA device; pass "
                               "device='cpu' to run the ranks on the CPU")
        cards = torch.cuda.device_count()
        if share:
            # every rank on the current card: gloo between them
            env['CUDA_VISIBLE_DEVICES'] = str(torch.cuda.current_device())
            backend = 'gloo'
        elif cards < n_devices:
            raise RuntimeError(
                f'dryrun_multichip({n_devices}) needs {n_devices} cards, '
                f'{cards} visible; pass share=True to run the ranks on one '
                f"card or device='cpu'")
        else:
            backend = 'nccl'
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    env.update(NSTPU_COORDINATOR=f'localhost:{port}',
               NSTPU_NUM_PROCESSES=str(n_devices))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env['PYTHONPATH'] = os.pathsep.join(
        p for p in (root, env.get('PYTHONPATH')) if p)
    with tempfile.TemporaryDirectory(prefix='dryrun_') as tmp:
        procs, logs = [], []
        try:
            for rank in range(n_devices):
                log = open(os.path.join(tmp, f'rank{rank}.log'), 'w+')
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, '-m', 'nice_slam_tpu_torch.graft_entry',
                     '--rank'], env={**env, 'NSTPU_PROCESS_ID': str(rank)},
                    stdout=log, stderr=subprocess.STDOUT))
            for p in procs:
                p.wait(timeout=RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            outs = []
            for log in logs:
                log.seek(0)
                outs.append(log.read())
                log.close()
    failed = [f'rank {r} exited {p.returncode}:\n{outs[r][-3000:]}'
              for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f'dryrun_multichip({n_devices}): '
                           + '\n'.join(failed))
    print('\n'.join(line for line in outs[0].splitlines()
                    if line.startswith('dryrun_multichip')), flush=True)
    return backend


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description='One step of every parallel '
                                 'backend on N ranks.')
    ap.add_argument('n', type=int, nargs='?', default=None,
                    help='ranks (default: the visible cards, at least 2)')
    ap.add_argument('--share', action='store_true',
                    help='gloo ranks sharing the current card')
    ap.add_argument('--device', default=None, help="'cpu' for CPU ranks")
    ap.add_argument('--rank', action='store_true', help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank:
        return _rank_main()
    n = args.n
    if n is None:
        n = max(2, torch.cuda.device_count() if args.device != 'cpu' else 2)
    dryrun_multichip(n, device=args.device, share=args.share)
    return 0


if __name__ == '__main__':
    sys.exit(main())
