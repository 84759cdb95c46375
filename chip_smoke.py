#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (nice_slam_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each printed as a JSON line:
  1. card      name and power limit (nvidia-smi)
  2. build     the port's native sources, one compiler process each, all
               started together: nvcc of the CUDA kernels (csrc/*.cu, with
               ptxas's registers and spills) and g++ of csrc/geometry.cpp
  3. kernels   each kernel against its plain PyTorch version at the
               ragged test shapes and the room0 main-path shapes (expand
               bit-exact; fold within 1e-5 of fold_plain and of autograd of
               expand_plain), times by CUDA events beside the plain
               version's and the library call's (index_select for the
               expansion, index_add_ for the fold, on a precomputed
               corner-row index; the port never calls them); then the
               fused decoder MLP against fused_mlp_plain, TF32 off, within
               1e-4 x max(1, max|plain|), at ragged N and at the mesher's
               262,144-point chunk for the middle, fine and color decoders
               (no single PyTorch call computes it: library_ms is null);
               then the port's model on the card against the port on the CPU
  4. accuracy  configs/Synthetic/synthetic.yaml (40 frames) through
               SlamSystem on the card, writing checkpoints and meshes (one
               on the background thread at frame 20, the final one at 128^3)
               into a temporary output directory; ATE RMSE and the largest
               per-frame error held to 1.5x the worst of three JAX seeds,
               the final mesh's accuracy and completion (cm, calc_3d_metric
               against the analytic scene) to 1.5x and its completion ratio
               to 0.67x the worst JAX seed (scripts/port_jax_accuracy_bound.py
               [--recon], recorded in PERF.md); the last checkpoint restored
               into a fresh SlamSystem gives bit-equal grids and decoders
  5. room0     configs/Replica/room0.yaml as loaded (pretrained decoders,
               680x1200 frames, grid shapes, budgets, eval_rec meshing at
               256^3) on 12 frames of the analytic synthetic scene;
               tracking / mapping / meshing times, peak memory, ATE;
               final_mesh.ply and final_mesh_eval_rec.ply must be non-empty,
               every kernel must launch during this phase, and the fused
               MLP exactly as often as the mesher's chunk schedule says
  6. render    render_image of room0's last frame on the trained state,
               fused decoders against the plain ones (depth within 1e-3 m),
               with times and peak memory
Then the kernel table line {"kernels": [...]} (launches from phase 5), the
card line, and last {"ok": true, "device": {...}}.  Any failure exits
non-zero without the last line.  Without CUDA it exits 2 at once.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

# 1.5x the worst of seeds 0-2 of the JAX package on synthetic.yaml
# (JAX_PLATFORMS=cpu python scripts/port_jax_accuracy_bound.py): worst ATE
# RMSE 0.034326 m, worst per-frame error 0.148852 m
ACC_BOUND_ATE_RMSE_M = 1.5 * 0.034326396718364155
ACC_BOUND_MAX_ERR_M = 1.5 * 0.14885209500789642

# 1.5x (accuracy, completion) and 0.67x (completion ratio) the worst of
# seeds 0-2 of the JAX package's final 128^3 mesh of synthetic.yaml against
# the analytic scene (JAX_PLATFORMS=cpu python
# scripts/port_jax_accuracy_bound.py --recon): worst accuracy 7.785480 cm,
# worst completion 47.829175 cm, worst completion ratio 18.524 %
REC_BOUND_ACCURACY_CM = 1.5 * 7.785480378382357
REC_BOUND_COMPLETION_CM = 1.5 * 47.8291751189649
REC_BOUND_COMPLETION_RATIO_PCT = 0.67 * 18.523999999999997

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12        # H100 SXM FP32 without tensor cores (same)

# room0's volumes (models/grids.grid_shapes of configs/Replica/room0.yaml)
MAIN_SHAPES = {'coarse': ((11, 8, 7), 32), 'middle': ((37, 28, 22), 32),
               'fine': ((74, 56, 44), 32), 'finecolor': ((74, 56, 44), 64)}
RAGGED_SHAPES = [(1, 1, 1), (1, 4, 3), (4, 1, 3), (4, 3, 1), (7, 5, 6),
                 (5, 38, 38)]
FOLD_TOL = 1e-5

# the decoder MLPs the fused kernel runs: c_dim, color head, multiply-adds
# per point (embedding 279, dense layers 2976 + 1024 + 1024 + 4000 + 1024,
# fc_c 5 x 32 x c_dim, head 32 x out)
MLPS = {'middle': (32, False, 15479), 'fine': (64, False, 20599),
        'color': (32, True, 15575)}
POINTS_BATCH = 262144          # meshing.points_batch: one lattice chunk
RAGGED_N = [1, 31, 1023, 1025, 4097]
MLP_TOL = 1e-4                 # x max(1, max|plain|)
ROOM0_BOUND = ((-2.9, 8.9), (-3.2, 5.5), (-3.5, 3.3))
RENDER_DEPTH_TOL_M = 1e-3

REPO = os.path.dirname(os.path.abspath(__file__))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 21, inner: int = 5) -> float:
    """Median over `reps` CUDA-event windows of `inner` back-to-back calls,
    per call, after a warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def phase_card() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({'phase': 'card', 'nvidia_smi': out})
    return out


def phase_build() -> None:
    from nice_slam_tpu_torch.mesh import native
    from nice_slam_tpu_torch.ops import expand, fused_mlp
    modules = (expand, fused_mlp, native)

    def build(mod):
        t0 = time.perf_counter()
        report = mod.build_library()
        return {'source': os.path.relpath(mod.SOURCE, REPO),
                'seconds': time.perf_counter() - t0,
                'ptxas': [l.strip() for l in report.splitlines()
                          if 'registers' in l or 'spill' in l]}

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(modules)) as pool:
        builds = list(pool.map(build, modules))
    emit({'phase': 'build', 'seconds': time.perf_counter() - t0,
          'builds': builds})


def corner_rows(shape, device):
    """[M * 8] flat row index of the edge-clamped corner k = dx*4 + dy*2 +
    dz of every voxel: the expansion is `g.index_select(0, rows)` and the
    fold `index_add_` over the same rows."""
    import torch
    nx, ny, nz = shape
    x, y, z = torch.meshgrid(*[torch.arange(n, device=device) for n in shape],
                             indexing='ij')
    cols = [((x + dx).clamp(max=nx - 1) * ny + (y + dy).clamp(max=ny - 1))
            * nz + (z + dz).clamp(max=nz - 1)
            for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
    return torch.stack(cols, dim=-1).reshape(-1)


def phase_kernels() -> dict:
    """Correctness at every shape, times at the main-path shapes."""
    import torch
    from nice_slam_tpu_torch.ops import expand as ex
    gen = torch.Generator(device='cuda').manual_seed(0)
    err = {'expand_corners': 0.0, 'fold_corners': 0.0}
    lib_err = {'index_select': 0.0, 'index_add_': 0.0}
    times = {}
    for shape, c in ([(s, 8) for s in RAGGED_SHAPES]
                     + list(MAIN_SHAPES.values())):
        m = shape[0] * shape[1] * shape[2]
        g = torch.randn((m, c), generator=gen, device='cuda')
        de = torch.randn((m, 8 * c), generator=gen, device='cuda')
        e_k, e_p = ex.expand_corners(g, shape), ex.expand_plain(g, shape)
        f_k, f_p = ex.fold_corners(de, shape), ex.fold_plain(de, shape)
        gl = g.clone().requires_grad_()
        f_auto, = torch.autograd.grad(ex.expand_plain(gl, shape), gl, de)
        torch.cuda.synchronize()
        if not torch.equal(e_k, e_p):
            raise AssertionError(f'expand_corners != expand_plain at '
                                 f'{shape} C={c}')
        f_err = max(float((f_k - f_p).abs().max()),
                    float((f_k - f_auto).abs().max()))
        if not f_err <= FOLD_TOL * max(1.0, float(f_p.abs().max())):
            raise AssertionError(f'fold_corners off by {f_err} at {shape} '
                                 f'C={c}')
        err['fold_corners'] = max(err['fold_corners'], f_err)
        rows = corner_rows(shape, 'cuda')

        def expand_lib():
            return g.index_select(0, rows).reshape(m, 8 * c)

        def fold_lib():
            return torch.zeros((m, c), device='cuda').index_add_(
                0, rows, de.reshape(-1, c))

        if not torch.equal(expand_lib(), e_p):
            raise AssertionError(f'index_select != expand_plain at {shape}')
        lib_err['index_add_'] = max(lib_err['index_add_'],
                                    float((fold_lib() - f_p).abs().max()))
        if not lib_err['index_add_'] <= FOLD_TOL * max(
                1.0, float(f_p.abs().max())):
            raise AssertionError(f'index_add_ fold off by '
                                 f'{lib_err["index_add_"]} at {shape}')
        if (shape, c) in MAIN_SHAPES.values():
            name = next(k for k, v in MAIN_SHAPES.items() if v == (shape, c))
            nbytes = 4 * m * c * 9      # read once + write once, 1C + 8C
            times[name] = {
                'shape': list(shape), 'c': c, 'bytes': nbytes,
                'expand_ms': cuda_ms(lambda: ex.expand_corners(g, shape)),
                'expand_plain_ms': cuda_ms(lambda: ex.expand_plain(g, shape)),
                'fold_ms': cuda_ms(lambda: ex.fold_corners(de, shape)),
                'fold_plain_ms': cuda_ms(lambda: ex.fold_plain(de, shape)),
                'expand_library_ms': cuda_ms(expand_lib),
                'fold_library_ms': cuda_ms(fold_lib),
                'bytes_bound_ms': nbytes / HBM_BYTES_PER_S * 1e3,
            }
        del g, de, e_k, e_p, f_k, f_p, gl, f_auto, rows
    emit({'phase': 'kernels', 'max_abs_err': err,
          'library_max_abs_err': lib_err,
          'tolerance': {'expand_corners': 0.0, 'index_select': 0.0,
                        'fold_corners': f'{FOLD_TOL} x max(1, max|fold|)',
                        'index_add_': f'{FOLD_TOL} x max(1, max|fold|)'},
          'main_shapes': times})
    return {'err': err, 'times': times}


def phase_fused_mlp() -> dict:
    """The fused decoder MLP against its plain version (true FP32: TF32
    off, as SlamSystem sets it) at ragged N and at one lattice chunk of
    each decoder, on points spread over room0's bound (Fourier arguments up
    to ~10^3 rad); times at the chunk."""
    import torch
    from nice_slam_tpu_torch.models.decoders import (
        DecoderConfig, init_nice_decoders)
    from nice_slam_tpu_torch.ops import fused_mlp as fm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')
    decs = init_nice_decoders(DecoderConfig(),
                              generator=torch.Generator().manual_seed(3),
                              device='cpu').to('cuda')
    gen = torch.Generator(device='cuda').manual_seed(4)
    lo = torch.tensor([b[0] for b in ROOM0_BOUND], device='cuda')
    hi = torch.tensor([b[1] for b in ROOM0_BOUND], device='cuda')
    err, times = 0.0, {}
    for name, (c_dim, color, macs) in MLPS.items():
        params = [w.detach() for w in fm.mlp_params(decs[name])]
        for n in RAGGED_N + [POINTS_BATCH]:
            p = lo + (hi - lo) * torch.rand((n, 3), generator=gen,
                                            device='cuda')
            c = 0.3 * torch.randn((n, c_dim), generator=gen, device='cuda')
            got = fm.fused_mlp_forward(p, c, params, color=color)
            want = fm.fused_mlp_plain(p, c, params, color=color)
            e = float((got - want).abs().max())
            tol = MLP_TOL * max(1.0, float(want.abs().max()))
            if not (got.shape == want.shape and e <= tol):
                raise AssertionError(f'fused_mlp off by {e} (tolerance '
                                     f'{tol}) for {name} at N={n}')
            err = max(err, e)
            if n == POINTS_BATCH:
                out_w = 4 if color else 1
                packed = fm.pack_weights(params).numel()
                nbytes = 4 * (n * (3 + c_dim + out_w) + packed)
                ops_ms = 2 * macs * n / FP32_FLOP_PER_S * 1e3
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                times[name] = {
                    'n': n, 'c_dim': c_dim, 'out': out_w,
                    'macs_per_point': macs, 'bytes': nbytes,
                    'ms': cuda_ms(lambda: fm.fused_mlp_forward(
                        p, c, params, color=color)),
                    'plain_ms': cuda_ms(lambda: fm.fused_mlp_plain(
                        p, c, params, color=color)),
                    'ops_bound_ms': ops_ms, 'bytes_bound_ms': bytes_ms,
                    'bound_ms': max(ops_ms, bytes_ms),
                    'bound_by': ('operations' if ops_ms >= bytes_ms
                                 else 'bytes')}
    emit({'phase': 'kernels_fused_mlp', 'max_abs_err': err,
          'tolerance': f'{MLP_TOL} x max(1, max|plain|)',
          'ragged_n': RAGGED_N, 'main_shapes': times,
          'library_ms': None,
          'library_note': 'no single PyTorch call computes the decoder MLP'})
    return {'err': err, 'times': times}


def phase_model_parity() -> None:
    """The port's decoders and renderer on the card agree with the port on
    the CPU (same weights, same inputs)."""
    import torch
    from nice_slam_tpu_torch.models.decoders import (
        DecoderConfig, init_nice_decoders)
    from nice_slam_tpu_torch.models.grids import (
        GridConfig, init_grids, prepare_grids, static_grid_shapes)
    from nice_slam_tpu_torch.render.renderer import (
        RenderConfig, SceneModel, render_rays)
    gen = torch.Generator().manual_seed(1)
    gcfg = GridConfig(bound=((-1.0, 1.0), (-0.8, 0.8), (-1.0, 1.0)))
    grids = {k: v * 30 for k, v in
             init_grids(gcfg, generator=gen, device='cpu').items()}
    decs = init_nice_decoders(DecoderConfig(), generator=gen, device='cpu')
    o = torch.rand((512, 3), generator=gen) * 0.4 - 0.2
    d = torch.randn((512, 3), generator=gen)
    depth = torch.rand((512,), generator=gen) * 1.5 + 0.2
    out = {}
    for dev in ('cpu', 'cuda'):
        model = SceneModel(decoder=DecoderConfig(),
                           bound=torch.tensor(gcfg.bound_np, device=dev),
                           coarse_bound=torch.tensor(gcfg.coarse_bound_np,
                                                     device=dev),
                           grid_shapes=static_grid_shapes(gcfg))
        gr = prepare_grids({k: v.to(dev) for k, v in grids.items()},
                           model.grid_shapes, stage='color')
        with torch.no_grad():
            dep, var, col, _ = render_rays(
                decs.to(dev), gr, o.to(dev), d.to(dev), stage='color',
                model=model, rcfg=RenderConfig(), gt_depth=depth.to(dev))
        out[dev] = [x.cpu() for x in (dep, var, col)]
    diff = max(float((a - b).abs().max())
               for a, b in zip(out['cpu'], out['cuda']))
    emit({'phase': 'model_parity', 'render_max_abs_diff': diff})
    if not diff < 1e-3:
        raise AssertionError(f'render on the card differs from the CPU by '
                             f'{diff}')


def run_slam(cfg: dict, output: str):
    """One SlamSystem run on the card with every kernel's count set to 0
    just before and read just after; returns (result, the system)."""
    import numpy as np
    import torch
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    from nice_slam_tpu_torch.eval.ate import evaluate_ate
    from nice_slam_tpu_torch.ops import expand as ex
    from nice_slam_tpu_torch.ops import fused_mlp as fm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ex.reset_launch_counts()
    fm.reset_launch_counts()
    t0 = time.perf_counter()
    slam = SlamSystem(cfg, device='cuda', seed=0, output=output)
    slam.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**ex.LAUNCHES, **fm.LAUNCHES}
    est, gt = slam.estimate_c2w, slam.gt_c2w
    if not np.isfinite(est).all():
        raise AssertionError('non-finite pose estimate')
    err = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=-1)
    ate = evaluate_ate(est, gt)
    tracked = [s * 1e3 for idx, s in slam.timers.track if idx > 0]
    res = {
        'frames': int(slam.n_img), 'wall_s': wall,
        'ate_rmse_m': ate['absolute_translational_error.rmse'],
        'max_frame_err_m': float(err.max()),
        'track_ms_per_frame': statistics.mean(tracked),
        'map_calls_ms': [{'frame': idx, 'kind': kind, 'iters': n,
                          'ms': s * 1e3}
                         for idx, kind, n, s in slam.timers.maps],
        'mesh_s': slam.timers.mesh_s,
        'meshes': [{'file': name, 's': sec, 'pieces_s': pieces}
                   for name, sec, pieces in slam.timers.meshes],
        'peak_mem_bytes': int(torch.cuda.max_memory_allocated()),
        'launches': launches,
    }
    if min(launches.values()) == 0:
        raise AssertionError(f'kernels not launched: {launches}')
    return res, slam


def mesh_vertices(path: str) -> int:
    from nice_slam_tpu_torch.mesh.mesher import load_ply
    if not os.path.exists(path):
        raise AssertionError(f'{path} was not written')
    verts, tris = load_ply(path)
    if len(verts) == 0 or len(tris) == 0:
        raise AssertionError(f'{path} is empty')
    return len(verts)


def check_restore(cfg: dict, slam, output: str) -> None:
    """The last checkpoint, restored into a fresh SlamSystem, gives the
    run's grids, decoders and poses bit for bit."""
    import numpy as np
    import torch
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    from nice_slam_tpu_torch.utils.ckpt import (
        latest_checkpoint, load_checkpoint)
    path = latest_checkpoint(os.path.join(output, 'ckpts'))
    if path is None:
        raise AssertionError('no checkpoint was written')
    with tempfile.TemporaryDirectory() as other:
        fresh = SlamSystem(cfg, device='cuda', seed=1, output=other)
        nxt = fresh.restore(load_checkpoint(path))
    if nxt != slam.n_img:
        raise AssertionError(f'restore resumes at {nxt}, not {slam.n_img}')
    for name, g in slam.grids.items():
        if not torch.equal(fresh.grids[name], g):
            raise AssertionError(f'restored grid {name} differs')
    want = slam.decoders.state_dict()
    for key, v in fresh.decoders.state_dict().items():
        if not torch.equal(v, want[key]):
            raise AssertionError(f'restored decoder {key} differs')
    if not np.array_equal(fresh.estimate_c2w, slam.estimate_c2w):
        raise AssertionError('restored poses differ')
    emit({'phase': 'restore', 'checkpoint': os.path.basename(path),
          'bytes': os.path.getsize(path), 'bit_equal': True})


def phase_accuracy() -> None:
    from nice_slam_tpu_torch.eval.recon import calc_3d_metric
    from nice_slam_tpu_torch.io.datasets import synthetic_gt_mesh
    from nice_slam_tpu_torch.mesh.mesher import load_ply
    from nice_slam_tpu_torch.utils.config import load_config
    cfg = load_config('configs/Synthetic/synthetic.yaml',
                      'configs/nice_slam.yaml')
    cfg['verbose'] = False
    # one periodic mesh, on the background thread, besides the final one
    # (meshing reads the map and draws nothing: the trajectory is that of
    # the config as shipped)
    cfg['mapping']['mesh_freq'] = 20
    with tempfile.TemporaryDirectory() as out:
        res, slam = run_slam(cfg, out)
        mesh_dir = os.path.join(out, 'mesh')
        res['mesh_vertices'] = {f: mesh_vertices(os.path.join(mesh_dir, f))
                                for f in ('00020_mesh.ply',
                                          'final_mesh.ply')}
        t0 = time.perf_counter()
        rec_v, rec_t = load_ply(os.path.join(mesh_dir, 'final_mesh.ply'))
        gt_v, gt_t = synthetic_gt_mesh(cfg['synthetic']['box'])
        res['recon'] = calc_3d_metric(rec_v, rec_t, gt_v, gt_t, align=False)
        res['recon_s'] = time.perf_counter() - t0
        res.update(phase='accuracy',
                   config='configs/Synthetic/synthetic.yaml',
                   mesh_resolution=slam.mesher.cfg.resolution,
                   bound_ate_rmse_m=ACC_BOUND_ATE_RMSE_M,
                   bound_max_frame_err_m=ACC_BOUND_MAX_ERR_M,
                   bound_accuracy_cm=REC_BOUND_ACCURACY_CM,
                   bound_completion_cm=REC_BOUND_COMPLETION_CM,
                   bound_completion_ratio_pct=REC_BOUND_COMPLETION_RATIO_PCT)
        emit(res)
        if not (res['ate_rmse_m'] <= ACC_BOUND_ATE_RMSE_M
                and res['max_frame_err_m'] <= ACC_BOUND_MAX_ERR_M):
            raise AssertionError('synthetic accuracy outside the JAX bound')
        rec = res['recon']
        if not (rec['accuracy_cm'] <= REC_BOUND_ACCURACY_CM
                and rec['completion_cm'] <= REC_BOUND_COMPLETION_CM
                and rec['completion_ratio_%']
                >= REC_BOUND_COMPLETION_RATIO_PCT):
            raise AssertionError('synthetic reconstruction outside the JAX '
                                 'bound')
        check_restore(cfg, slam, out)


def expected_mlp_launches(lattice_points: int, vertex_counts) -> int:
    """Fused-MLP launches of the meshes: per lattice chunk the middle and
    fine decoders, per vertex-color chunk middle, fine and color."""
    return sum(2 * math.ceil(lattice_points / POINTS_BATCH)
               + 3 * math.ceil(v / POINTS_BATCH) for v in vertex_counts)


def phase_room0(out: str):
    from nice_slam_tpu_torch.utils.config import load_config
    cfg = load_config('configs/Replica/room0.yaml', 'configs/nice_slam.yaml')
    # Replica frames are not in the repository: the analytic scene at
    # room0's intrinsics and frame size, its box inside room0's bound
    cfg['dataset'] = 'synthetic'
    cfg['synthetic'] = {'n_frames': 12, 'radius': 0.8, 'step': 0.02,
                        'noise': 0.003,
                        'box': [[-2.8, 8.8], [-3.1, 5.4], [-3.4, 3.2]]}
    cfg['verbose'] = False
    res, slam = run_slam(cfg, out)
    mesh_dir = os.path.join(out, 'mesh')
    res['mesh_vertices'] = {
        f: mesh_vertices(os.path.join(mesh_dir, f))
        for f in ('final_mesh.ply', 'final_mesh_eval_rec.ply')}
    res['mesh_resolution'] = slam.mesher.cfg.resolution
    want = expected_mlp_launches(slam.mesher.cfg.resolution ** 3,
                                 res['mesh_vertices'].values())
    res.update(phase='room0', config='configs/Replica/room0.yaml',
               dataset='synthetic', iters_first=cfg['mapping']['iters_first'],
               expected_fused_mlp_launches=want)
    emit(res)
    if res['mesh_resolution'] != 256:
        raise AssertionError('room0 did not mesh at 256^3')
    if res['launches']['fused_mlp'] != want:
        raise AssertionError(f'fused_mlp launched '
                             f'{res["launches"]["fused_mlp"]} times, the '
                             f'mesh schedule says {want}')
    return res, slam


def phase_render(slam) -> None:
    """One full room0 frame rendered from the trained map through the fused
    decoders and through the plain ones."""
    import torch
    from nice_slam_tpu_torch.ops import fused_mlp as fm
    from nice_slam_tpu_torch.render.renderer import render_image
    idx = slam.n_img - 1
    _, _, depth_np, _ = slam.frame_reader[idx]
    c2w = torch.as_tensor(slam.estimate_c2w[idx], device='cuda')
    gt_depth = torch.as_tensor(depth_np, dtype=torch.float32, device='cuda')
    runs = {}
    for fused in (True, False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fm.reset_launch_counts()
        t0 = time.perf_counter()
        depth, _, color = render_image(
            slam.decoders, slam.grids, c2w, slam.intr, stage='color',
            model=slam.model._replace(fused_eval=fused), rcfg=slam.rcfg,
            gt_depth=gt_depth)
        torch.cuda.synchronize()
        runs[fused] = (depth, color, {
            'ms': (time.perf_counter() - t0) * 1e3,
            'peak_mem_bytes': int(torch.cuda.max_memory_allocated()),
            'fused_mlp_launches': fm.LAUNCHES['fused_mlp']})
    (d_f, c_f, fused_res), (d_p, c_p, plain_res) = runs[True], runs[False]
    if not (torch.isfinite(d_f).all() and torch.isfinite(c_f).all()):
        raise AssertionError('render_image gave non-finite values')
    depth_diff = float((d_f - d_p).abs().max())
    res = {'phase': 'render', 'frame': idx,
           'size': [slam.intr.H, slam.intr.W],
           'ray_chunk': slam.rcfg.ray_chunk, 'fused': fused_res,
           'plain': plain_res, 'depth_max_abs_diff_m': depth_diff,
           'color_max_abs_diff': float((c_f - c_p).abs().max()),
           'depth_tolerance_m': RENDER_DEPTH_TOL_M}
    emit(res)
    if not depth_diff <= RENDER_DEPTH_TOL_M:
        raise AssertionError(f'fused render depth off by {depth_diff} m')
    if fused_res['fused_mlp_launches'] == 0 or plain_res[
            'fused_mlp_launches'] != 0:
        raise AssertionError('render_image did not route as asked')


def kernel_table(kern: dict, mlp: dict, room0: dict) -> list:
    times = kern['times']['finecolor']
    fine = mlp['times']['fine']
    return [
        {'name': 'expand_corners', 'route': 'cuda',
         'source': 'nice_slam_tpu_torch/csrc/expand.cu',
         'replaces': 'nice_slam_tpu/ops/pallas/expand.py:98',
         'launches': room0['launches']['expand_corners'],
         'max_abs_err': kern['err']['expand_corners'],
         'ms': times['expand_ms'], 'plain_ms': times['expand_plain_ms'],
         'bound_ms': times['bytes_bound_ms'], 'bound_by': 'bytes',
         'library_ms': times['expand_library_ms'],
         'shape': 'finecolor 74x56x44 C64'},
        {'name': 'fold_corners', 'route': 'cuda',
         'source': 'nice_slam_tpu_torch/csrc/expand.cu',
         'replaces': 'nice_slam_tpu/ops/pallas/expand.py:120',
         'launches': room0['launches']['fold_corners'],
         'max_abs_err': kern['err']['fold_corners'],
         'ms': times['fold_ms'], 'plain_ms': times['fold_plain_ms'],
         'bound_ms': times['bytes_bound_ms'], 'bound_by': 'bytes',
         'library_ms': times['fold_library_ms'],
         'shape': 'finecolor 74x56x44 C64'},
        {'name': 'fused_mlp', 'route': 'cuda',
         'source': 'nice_slam_tpu_torch/csrc/fused_mlp.cu',
         'replaces': 'nice_slam_tpu/ops/pallas/fused_mlp.py:49',
         'launches': room0['launches']['fused_mlp'],
         'max_abs_err': mlp['err'],
         'ms': fine['ms'], 'plain_ms': fine['plain_ms'],
         'bound_ms': fine['bound_ms'], 'bound_by': fine['bound_by'],
         'library_ms': None,
         'shape': f'fine decoder, {POINTS_BATCH} points, c 64'},
    ]


def main() -> int:
    try:
        import torch
    except ImportError:
        print('chip_smoke: torch is not installed', file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, 'nice_slam_tpu_torch')):
        print('chip_smoke: run from a checkout of the repository (no '
              'nice_slam_tpu_torch/ beside this script)', file=sys.stderr)
        return 2
    os.chdir(REPO)
    sys.path.insert(0, REPO)
    try:
        card = phase_card()
        phase_build()
        kern = phase_kernels()
        mlp = phase_fused_mlp()
        phase_model_parity()
        torch.cuda.synchronize()
        phase_accuracy()
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as out:
            room0, slam = phase_room0(out)
            phase_render(slam)
        del slam
        torch.cuda.synchronize()
        if any(k in sys.modules for k in ('jax', 'nice_slam_tpu')):
            raise AssertionError('the JAX package was imported')
    except Exception:
        traceback.print_exc()
        return 1
    emit({'kernels': kernel_table(kern, mlp, room0)})
    print(card, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
