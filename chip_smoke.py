#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (nice_slam_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each printed as a JSON line:
  1. card      name and power limit (nvidia-smi)
  2. build     nvcc of the port's CUDA kernels (csrc/*.cu), build seconds
  3. kernels   each kernel against its plain PyTorch version at the
               ragged test shapes and the room0 main-path shapes (expand
               bit-exact; fold within 1e-5 of fold_plain and of autograd of
               expand_plain), times by CUDA events beside the plain
               version's and the library call's (index_select for the
               expansion, index_add_ for the fold, on a precomputed
               corner-row index; the port never calls them), plus the
               port's model on the card against the port on the CPU
  4. accuracy  configs/Synthetic/synthetic.yaml (40 frames) through
               SlamSystem on the card; ATE RMSE and the largest per-frame
               error held to 1.5x the worst of three JAX seeds
               (scripts/port_jax_accuracy_bound.py, recorded in PERF.md)
  5. room0     configs/Replica/room0.yaml as loaded (pretrained decoders,
               680x1200 frames, grid shapes, budgets) on 12 frames of the
               analytic synthetic scene; tracking / mapping times, peak
               memory, ATE; every kernel must launch during this phase
Then the kernel table line {"kernels": [...]} (launches from phase 5), the
card line, and last {"ok": true, "device": {...}}.  Any failure exits
non-zero without the last line.  Without CUDA it exits 2 at once.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

# 1.5x the worst of seeds 0-2 of the JAX package on synthetic.yaml
# (JAX_PLATFORMS=cpu python scripts/port_jax_accuracy_bound.py): worst ATE
# RMSE 0.034326 m, worst per-frame error 0.148852 m
ACC_BOUND_ATE_RMSE_M = 1.5 * 0.034326396718364155
ACC_BOUND_MAX_ERR_M = 1.5 * 0.14885209500789642

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)

# room0's volumes (models/grids.grid_shapes of configs/Replica/room0.yaml)
MAIN_SHAPES = {'coarse': ((11, 8, 7), 32), 'middle': ((37, 28, 22), 32),
               'fine': ((74, 56, 44), 32), 'finecolor': ((74, 56, 44), 64)}
RAGGED_SHAPES = [(1, 1, 1), (1, 4, 3), (4, 1, 3), (4, 3, 1), (7, 5, 6),
                 (5, 38, 38)]
FOLD_TOL = 1e-5

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
    from nice_slam_tpu_torch.ops import expand
    t0 = time.perf_counter()
    report = expand.build_library()
    emit({'phase': 'build', 'source': os.path.relpath(expand.SOURCE, REPO),
          'seconds': time.perf_counter() - t0,
          'ptxas': [l.strip() for l in report.splitlines()
                    if 'registers' in l or 'spill' in l]})


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


def run_slam(cfg: dict) -> dict:
    import numpy as np
    import torch
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    from nice_slam_tpu_torch.eval.ate import evaluate_ate
    from nice_slam_tpu_torch.ops import expand as ex
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ex.reset_launch_counts()
    t0 = time.perf_counter()
    slam = SlamSystem(cfg, device='cuda', seed=0)
    slam.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ex.LAUNCHES)
    est, gt = slam.estimate_c2w, slam.gt_c2w
    if not np.isfinite(est).all():
        raise AssertionError('non-finite pose estimate')
    err = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=-1)
    ate = evaluate_ate(est, gt)
    tracked = [s * 1e3 for idx, s in slam.timers.track if idx > 0]
    return {
        'frames': int(slam.n_img), 'wall_s': wall,
        'ate_rmse_m': ate['absolute_translational_error.rmse'],
        'max_frame_err_m': float(err.max()),
        'track_ms_per_frame': statistics.mean(tracked),
        'map_calls_ms': [{'frame': idx, 'kind': kind, 'iters': n,
                          'ms': s * 1e3}
                         for idx, kind, n, s in slam.timers.maps],
        'peak_mem_bytes': int(torch.cuda.max_memory_allocated()),
        'launches': launches,
    }


def phase_accuracy() -> None:
    from nice_slam_tpu_torch.utils.config import load_config
    cfg = load_config('configs/Synthetic/synthetic.yaml',
                      'configs/nice_slam.yaml')
    cfg['verbose'] = False
    res = run_slam(cfg)
    res.update(phase='accuracy', config='configs/Synthetic/synthetic.yaml',
               bound_ate_rmse_m=ACC_BOUND_ATE_RMSE_M,
               bound_max_frame_err_m=ACC_BOUND_MAX_ERR_M)
    emit(res)
    if not (res['ate_rmse_m'] <= ACC_BOUND_ATE_RMSE_M
            and res['max_frame_err_m'] <= ACC_BOUND_MAX_ERR_M):
        raise AssertionError('synthetic accuracy outside the JAX bound')
    if min(res['launches'].values()) == 0:
        raise AssertionError(f'kernels not launched: {res["launches"]}')


def phase_room0() -> dict:
    from nice_slam_tpu_torch.utils.config import load_config
    cfg = load_config('configs/Replica/room0.yaml', 'configs/nice_slam.yaml')
    # Replica frames are not in the repository: the analytic scene at
    # room0's intrinsics and frame size, its box inside room0's bound
    cfg['dataset'] = 'synthetic'
    cfg['synthetic'] = {'n_frames': 12, 'radius': 0.8, 'step': 0.02,
                        'noise': 0.003,
                        'box': [[-2.8, 8.8], [-3.1, 5.4], [-3.4, 3.2]]}
    cfg['verbose'] = False
    res = run_slam(cfg)
    res.update(phase='room0', config='configs/Replica/room0.yaml',
               dataset='synthetic', iters_first=cfg['mapping']['iters_first'])
    emit(res)
    if min(res['launches'].values()) == 0:
        raise AssertionError(f'kernels not launched: {res["launches"]}')
    return res


def kernel_table(kern: dict, room0: dict) -> list:
    times = kern['times']['finecolor']
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
        phase_model_parity()
        torch.cuda.synchronize()
        phase_accuracy()
        torch.cuda.synchronize()
        room0 = phase_room0()
        torch.cuda.synchronize()
        if any(k in sys.modules for k in ('jax', 'nice_slam_tpu')):
            raise AssertionError('the JAX package was imported')
    except Exception:
        traceback.print_exc()
        return 1
    emit({'kernels': kernel_table(kern, room0)})
    print(card, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
