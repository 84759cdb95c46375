#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (nice_slam_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py [--ab-parent DIR]

Run from the root of a checkout.  Phases, each printed as a JSON line:
  1. card      name and power limit (nvidia-smi)
  2. build     the port's native sources, one compiler process each, all
               started together: nvcc of the CUDA kernels (csrc/expand.cu,
               fused_mlp.cu, gather.cu, roofline.cu, with ptxas's registers
               and spills; fused_mlp.cu must not spill) and g++ of
               csrc/geometry.cpp
  3. kernels   each kernel against its plain PyTorch version at the
               ragged test shapes and the room0 main-path shapes (expand
               bit-exact; fold within 1e-5 of fold_plain and of autograd of
               expand_plain), times by CUDA events beside the plain
               version's and the library call's (index_select for the
               expansion, index_add_ for the fold, on a precomputed
               corner-row index; the port never calls them); then the
               fused decoder MLP against fused_mlp_plain, TF32 off, within
               1e-4 x max(1, max|plain|), on points over room0's bound, at
               ragged N, the kernel's tile edges and the mesher's
               262,144-point chunk for the middle, fine, color and c 64 /
               4-wide decoders, and within 1e-5 x max(1, max|plain|) at the
               three decoders' chunks (FP32 precision: the fast hardware
               sine fails it, PERF.md): times beside the tensor-core bound (3xTF32),
               the FP32-core bound and the bytes bound, host time per call,
               the kernel's warps and shared memory, ptxas's report (no
               single PyTorch call computes it: library_ms is null);
               with --ab-parent DIR, the parent tree's wrapper and kernel
               (DIR/fused_mlp.py, DIR/fused_mlp.cu, built into build/)
               against this tree's at the three chunks, old, new, new, old,
               the new one required faster at each (phase fused_mlp_ab);
               then the port's model on the card against the port on the CPU
     gather    the row gather (bit-exact against table[idx]) and its
               scatter-add backward (within 1e-5 x max(1, max|index_add_|),
               bit-equal to index_put_ with accumulate and between two
               calls) at the shapes of the three gather studies (a width
               sweep 64-2048 over ~60 MB tables with 96K indices; 240K
               indices in sorted runs of 48 over [59*1024, 256]; 48,000
               over [58240, 128]) and at room0's (middle [22792, 256],
               finecolor [182336, 512]; 48,000 points = one mapping
               iteration, 9,600 = one tracking iteration), plus three
               adversarial indices at the middle mapping shape (every
               position on one row, none, the index reversed): times beside
               the plain version's, index_select's / index_add_'s,
               index_put_ with accumulate (what autograd of table[idx]
               pays) and the bytes bound, the longest segment, and the
               device operations one call launches (torch.profiler; the
               scatter's may hold no sort and no fill); then
               at the finecolor mapping shape one forward+backward of the
               expanded-row path (expand, gather, scatter, fold) against the
               direct 8-corner gather of the flat grid; and the host time
               per call of the gather (direct and through GatherRows), the
               scatter and their library calls at room0's middle table
     roofline  the four streaming probes (copy, widen8, shifts,
               expand_same_x; bit-exact against their plain versions) and
               expand_corners at the study shapes (28x21x14 and 64x48x40,
               C 32) and room0's finecolor shape: ms, GB/s and the share of
               3.35 TB/s; the copy beside clone at each shape, also as
               device time alone (CUDA graphs of 20 calls), and host time
               per call at 28x21x14;
               the faster of copy and clone at room0's finecolor buffer is
               the measured streaming bound
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
     gather_real_index  the gather phase's checks and times at room0's
               middle and fine+color tables on the index of the room0
               run's last mapping iteration on each (few rows, long
               segments: the scatter's main-path case)
  7. overlap   sync_method: loose (mapping rounds on their own thread and
               stream, every every_frame // 2 frames): synthetic.yaml, 40
               frames, ATE RMSE and largest per-frame error held to 1.5x
               the worst of JAX seeds 0-2 under loose; then room0 as in
               phase 5 without its meshes, its ATE RMSE and largest
               per-frame error held to 5x the strict room0 run's: wall time
               beside the strict run's, tracking ms per frame, mapping ms
               per call, the snapshots adopted when done and those the
               loose gate waited for; every kernel of the path must launch
               in both
  8. imap_accuracy  iMAP* (SlamSystem(cfg, nice=False)) on
               configs/Synthetic/synthetic_imap.yaml over configs/imap.yaml
               (40 frames, the cut budgets in the YAML), writing its
               checkpoints and final 128^3 mesh: ATE RMSE and the largest
               per-frame error held to 1.5x the worst of JAX seeds 0-2, the
               mesh's accuracy and completion to 1.5x and its completion
               ratio to 0.67x the worst JAX seed
               (scripts/port_jax_accuracy_bound.py --imap --recon); the last
               checkpoint restored bit-equal.  The iMAP* path has no kernel
               of rows 1-11 (its decoder is plain matmuls, as in the JAX
               package): their counts must stay 0 through the run
  9. imap_room0  configs/Replica/room0_imap.yaml over configs/imap.yaml at
               its full width (680x1200, 5000 px x 50 tracking iterations,
               5000 px x 300 mapping iterations as 3 outer x 100, 32 + 12
               samples, hidden 256, the regulation on) on 7 frames of the
               analytic scene inside room0's scaled bound, iters_first cut
               to 300, no final color refine, one 256^3 mesh (no eval_rec
               mesh), then one 680x1200 render_image: ms per tracked frame
               (median and range), ms per normal mapping call, mesh
               seconds, render ms, peak memory, and the ATE, gated only to
               be finite
Then the kernel table line {"kernels": [...]} (one entry per TPU kernel of
the repository; launches from phase 5, the probes' from the roofline
phase; the scatter's times from the real-index case), the card line, and last {"ok": true, "device": {...}}.  Any
failure exits non-zero without the last line.  Without CUDA it exits 2 at
once.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import os
import re
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

# 1.5x the worst of seeds 0-2 of the JAX package on synthetic.yaml under
# sync_method: loose, one device (JAX_PLATFORMS=cpu python
# scripts/port_jax_accuracy_bound.py --sync loose): worst ATE RMSE
# 0.019387 m, worst per-frame error 0.126280 m (both seed 2)
LOOSE_BOUND_ATE_RMSE_M = 1.5 * 0.019387026506052316
LOOSE_BOUND_MAX_ERR_M = 1.5 * 0.12628036737442017

# 1.5x (ATE RMSE, largest per-frame error, mesh accuracy and completion)
# and 0.67x (completion ratio) the worst of seeds 0-2 of the JAX package's
# iMAP* on configs/Synthetic/synthetic_imap.yaml, final 128^3 mesh against
# the analytic scene (JAX_PLATFORMS=cpu python
# scripts/port_jax_accuracy_bound.py --imap --config
# configs/Synthetic/synthetic_imap.yaml --recon --seeds 0 1 2): worst ATE
# RMSE 0.011763 m and per-frame error 0.052457 m (seed 0), worst accuracy
# 9.869530 cm, completion 51.493614 cm and ratio 15.3175 % (seed 1)
IMAP_BOUND_ATE_RMSE_M = 1.5 * 0.011762763482403616
IMAP_BOUND_MAX_ERR_M = 1.5 * 0.05245661363005638
IMAP_BOUND_ACCURACY_CM = 1.5 * 9.86952977686645
IMAP_BOUND_COMPLETION_CM = 1.5 * 51.49361388315506
IMAP_BOUND_COMPLETION_RATIO_PCT = 0.67 * 15.3175

# room0 under loose, held to this multiple of the same run's strict room0
# ATE RMSE and largest per-frame error: the JAX package has no room0 loose
# run to bound it, and the tracker's map may be every_frame + every_frame
# // 2 = 7 frames old under loose against every_frame - 1 = 4 under strict.
# It catches a diverged or broken overlap, not a small loss of accuracy.
LOOSE_ROOM0_FACTOR = 5.0

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12        # H100 SXM FP32 without tensor cores (same)
TF32_FLOP_PER_S = 495e12       # H100 SXM dense TF32 tensor cores (same)

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
EMBED_MACS = 279               # p @ B, on the FP32 cores
POINTS_BATCH = 262144          # meshing.points_batch: one lattice chunk
# ragged sizes, and the edges of the kernel's 32-point warp tiles and of a
# 7- / 8-warp block's 224 / 256 points
RAGGED_N = [1, 15, 16, 17, 31, 63, 64, 65, 1023, 1025, 4097,
            POINTS_BATCH + 13]
MLP_TOL = 1e-4                 # x max(1, max|plain|)
# x max(1, max|plain|) at the three decoders' 262,144-point chunks: FP32
# precision.  MLP_TOL alone fails 1x and 2xTF32 products (4.1e-3 to 6.4e-3
# against 8.2e-4 to 1.1e-3) but not the fast hardware sine __sinf (1.8e-4
# to 2.1e-4); this fails the sine too, and the kernel (3xTF32, precise
# sinf) is off by 2.4e-5 to 5.0e-5 (PERF.md, the fused MLP)
MLP_PRECISION_TOL = 1e-5
SCATTER_TOL = 1e-5             # x max(1, max|index_add_|)
# the gather studies' shapes: scripts/studies/proto_gather_sweep.py (width
# sweep, ~60 MB tables, 96K uniform indices), proto_pallas_gather.py (240K
# indices in sorted runs of 48 over [59*1024, 256]), proto_gather_paths.py
# (48,000 uniform indices over [58240, 128])
GATHER_SWEEP_WIDTHS = (64, 128, 256, 512, 1024, 1536, 2048)
GATHER_SWEEP_N = 96 * 1024
MAP_POINTS = 1000 * 48         # one mapping iteration: 1000 px x 48 samples
TRACK_POINTS = 200 * 48        # one tracking iteration: 200 px x 48
# 'mapping_real': the index of the room0 run's last mapping iteration on
# that table (phase_real_index); the others draw ray walks
ROOM0_GATHER_CASES = tuple(f'room0_{vol}_{call}'
                           for vol in ('middle', 'finecolor')
                           for call in ('mapping', 'mapping_real',
                                        'tracking'))
ROOFLINE_SHAPES = {'study_default': ((28, 21, 14), 32),
                   'study_variants': ((64, 48, 40), 32),
                   'room0_finecolor': ((74, 56, 44), 64)}
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


def graph_ms(fn, calls: int = 20, reps: int = 11) -> float:
    """Device time per call: `calls` back-to-back calls captured in one
    CUDA graph, the median over `reps` replays timed by CUDA events.  The
    host's launch path is out of it (cuda_ms includes it where calls are
    host-bound)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def phase_card() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({'phase': 'card', 'nvidia_smi': out})
    return out


def phase_build() -> dict:
    from nice_slam_tpu_torch.mesh import native
    from nice_slam_tpu_torch.ops import expand, fused_mlp, gather, roofline
    modules = (expand, fused_mlp, gather, roofline, native)

    def build(mod):
        t0 = time.perf_counter()
        report = mod.build_library()
        return {'source': os.path.relpath(mod.SOURCE, REPO),
                'seconds': time.perf_counter() - t0,
                'ptxas': [l.strip() for l in report.splitlines()
                          if 'registers' in l or 'spill' in l
                          or 'entry function' in l]}

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(modules)) as pool:
        builds = list(pool.map(build, modules))
    emit({'phase': 'build', 'seconds': time.perf_counter() - t0,
          'builds': builds})
    mlp = next(b for b in builds if b['source'].endswith('fused_mlp.cu'))
    spills = [int(x) for line in mlp['ptxas']
              for x in re.findall(r'(\d+) bytes spill', line)]
    if not spills or any(spills):
        raise AssertionError(f'fused_mlp.cu spills: {mlp["ptxas"]}')
    return {b['source']: b['ptxas'] for b in builds}


def corner_rows(shape, device, same_x: bool = False):
    """[M * 8] flat row index of the edge-clamped corner k = dx*4 + dy*2 +
    dz of every voxel: the expansion is `g.index_select(0, rows)` and the
    fold `index_add_` over the same rows.  same_x: the dx = 1 corners on
    the voxel's own x-plane (the expand_same_x probe)."""
    import torch
    nx, ny, nz = shape
    x, y, z = torch.meshgrid(*[torch.arange(n, device=device) for n in shape],
                             indexing='ij')
    cols = [((x + dx * (not same_x)).clamp(max=nx - 1) * ny
             + (y + dy).clamp(max=ny - 1)) * nz + (z + dz).clamp(max=nz - 1)
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


def mlp_inputs(n: int, c_dim: int, gen):
    """n points spread over room0's bound (Fourier arguments up to ~10^3
    rad) and their features."""
    import torch
    lo = torch.tensor([b[0] for b in ROOM0_BOUND], device='cuda')
    hi = torch.tensor([b[1] for b in ROOM0_BOUND], device='cuda')
    p = lo + (hi - lo) * torch.rand((n, 3), generator=gen, device='cuda')
    c = 0.3 * torch.randn((n, c_dim), generator=gen, device='cuda')
    return p, c


def mlp_bounds(n: int, c_dim: int, color: bool, macs: int,
               packed_floats: int) -> dict:
    """The least time of one call at n points: tensor cores at FP32
    accuracy (3 TF32 products per multiply-add of the dense, fc_c and head
    products, the embedding argument on the FP32 cores), the FP32 cores
    alone, and the bytes (p, c, out, packed weights once each)."""
    out_w = 4 if color else 1
    nbytes = 4 * (n * (3 + c_dim + out_w) + packed_floats)
    tc_ms = (3 * 2 * (macs - EMBED_MACS) * n / TF32_FLOP_PER_S
             + 2 * EMBED_MACS * n / FP32_FLOP_PER_S) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {'bytes': nbytes, 'tensor_core_bound_ms': tc_ms,
            'fp32_core_bound_ms': 2 * macs * n / FP32_FLOP_PER_S * 1e3,
            'bytes_bound_ms': bytes_ms, 'bound_ms': max(tc_ms, bytes_ms),
            'bound_by': 'operations' if tc_ms >= bytes_ms else 'bytes'}


def fine4_mlp():
    """The fourth instantiation (c 64 with the 4-wide head)."""
    import torch
    from nice_slam_tpu_torch.models.decoders import MLP, DecoderConfig
    return MLP(DecoderConfig(), c_dim=64, color=True,
               generator=torch.Generator().manual_seed(1),
               device='cpu').to('cuda')


def phase_fused_mlp(ptxas: list) -> dict:
    """The fused decoder MLP against its plain version (true FP32: TF32
    off, as SlamSystem sets it) at ragged N, at the kernel's tile edges
    and at one lattice chunk of each decoder (and of the c 64 / 4-wide
    instantiation), on points spread over room0's bound; times, bounds
    and host time per call at the chunk."""
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
    mlps = {**{k: decs[k] for k in MLPS}, 'fine4': fine4_mlp()}
    gen = torch.Generator(device='cuda').manual_seed(4)
    err, times, configs = 0.0, {}, {}
    for name, mlp in mlps.items():
        c_dim, color = mlp.fc_c[0].in_features, mlp.color
        params = [w.detach() for w in fm.mlp_params(mlp)]
        configs[name] = fm.kernel_config(c_dim, 4 if color else 1)
        for n in RAGGED_N + [POINTS_BATCH]:
            p, c = mlp_inputs(n, c_dim, gen)
            got = fm.fused_mlp_forward(p, c, params, color=color)
            want = fm.fused_mlp_plain(p, c, params, color=color)
            e = float((got - want).abs().max())
            tol = MLP_TOL * max(1.0, float(want.abs().max()))
            if not (got.shape == want.shape and e <= tol):
                raise AssertionError(f'fused_mlp off by {e} (tolerance '
                                     f'{tol}) for {name} at N={n}')
            err = max(err, e)
            if n == POINTS_BATCH and name in MLPS:
                precision = MLP_PRECISION_TOL * max(
                    1.0, float(want.abs().max()))
                if not e <= precision:
                    raise AssertionError(
                        f'fused_mlp off by {e} for {name} at N={n}: not '
                        f'FP32-precise (bound {precision})')
                times[name] = {
                    'n': n, 'c_dim': c_dim, 'out': 4 if color else 1,
                    'macs_per_point': MLPS[name][2],
                    'ms': cuda_ms(lambda: fm.fused_mlp_forward(
                        p, c, params, color=color)),
                    'plain_ms': cuda_ms(lambda: fm.fused_mlp_plain(
                        p, c, params, color=color)),
                    'host_us': host_us(lambda: fm.fused_mlp_forward(
                        p, c, params, color=color), calls=50, runs=5),
                    'max_abs_err': e, 'tolerance': tol,
                    'precision_bound': precision,
                    **mlp_bounds(n, c_dim, color, MLPS[name][2],
                                 configs[name]['pack_floats'])}
                row = times[name]
                row['share_of_bound'] = row['bound_ms'] / row['ms']
                row['share_of_fp32_core_bound'] = (row['fp32_core_bound_ms']
                                                   / row['ms'])
    emit({'phase': 'kernels_fused_mlp', 'max_abs_err': err,
          'tolerance': f'{MLP_TOL} x max(1, max|plain|)',
          'precision_bound': f'{MLP_PRECISION_TOL} x max(1, max|plain|) '
                             'at the chunks',
          'ragged_n': RAGGED_N, 'main_shapes': times,
          'kernel_config': configs, 'ptxas': ptxas,
          'library_ms': None,
          'library_note': 'no single PyTorch call computes the decoder MLP'})
    return {'err': err, 'times': times}


def load_parent_mlp(directory: str):
    """The parent tree's fused-MLP wrapper (`fused_mlp.py`) as a module of
    its own, bound to the parent's `fused_mlp.cu` beside it and built into
    build/ under another name: its packing, checks and launch counter are
    its own."""
    import importlib.util
    from nice_slam_tpu_torch.ops.build import BUILD_DIR
    spec = importlib.util.spec_from_file_location(
        'parent_fused_mlp', os.path.join(directory, 'fused_mlp.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.SOURCE = os.path.join(directory, 'fused_mlp.cu')
    mod.LIBRARY = os.path.join(BUILD_DIR, 'libnst_fused_mlp_parent.so')
    mod.build_library()
    return mod


def phase_mlp_ab(directory: str) -> dict:
    """The parent's fused MLP (wrapper and kernel, from `directory`)
    against this tree's at the three decoders' 262,144-point chunks, in
    the order old, new, new, old, each checked against the plain version
    first."""
    import torch
    from nice_slam_tpu_torch.models.decoders import (
        DecoderConfig, init_nice_decoders)
    from nice_slam_tpu_torch.ops import fused_mlp as fm
    old = load_parent_mlp(directory)
    decs = init_nice_decoders(DecoderConfig(),
                              generator=torch.Generator().manual_seed(3),
                              device='cpu').to('cuda')
    gen = torch.Generator(device='cuda').manual_seed(8)
    rows = {}
    for name, (c_dim, color, _) in MLPS.items():
        params = [w.detach() for w in fm.mlp_params(decs[name])]
        p, c = mlp_inputs(POINTS_BATCH, c_dim, gen)
        want = fm.fused_mlp_plain(p, c, params, color=color)
        tol = MLP_TOL * max(1.0, float(want.abs().max()))
        runs = {'old': old.fused_mlp_forward, 'new': fm.fused_mlp_forward}
        for tree, fn in runs.items():
            e = float((fn(p, c, params, color=color) - want).abs().max())
            if not e <= tol:
                raise AssertionError(f'{tree} fused_mlp off by {e} for '
                                     f'{name}')
        order = ['old', 'new', 'new', 'old']
        ms = [cuda_ms(lambda: runs[tree](p, c, params, color=color))
              for tree in order]
        rows[name] = {'order': order, 'ms': ms,
                      'old_ms': statistics.mean(ms[0::3]),
                      'new_ms': statistics.mean(ms[1:3])}
        rows[name]['speedup'] = rows[name]['old_ms'] / rows[name]['new_ms']
    emit({'phase': 'fused_mlp_ab', 'parent': directory, 'chunks': rows})
    slower = [k for k, r in rows.items() if r['new_ms'] >= r['old_ms']]
    if slower:
        raise AssertionError(f'the new fused_mlp is not faster at {slower}')
    return rows


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


def ray_walk_index(n: int, rows: int, gen):
    """n row indices in sorted runs of 48, each run a random base plus a
    sorted walk over 64 rows: the index pattern of rays' samples walking
    voxels (the study of scripts/studies/proto_pallas_gather.py)."""
    import torch
    runs = n // 48
    base = torch.randint(0, rows - 64, (runs, 1), generator=gen,
                         device='cuda')
    walk = torch.randint(0, 64, (runs, 48), generator=gen,
                         device='cuda').sort(dim=1).values
    return (base + walk).reshape(-1)


def device_ops(fn) -> list:
    """[name, device us] of each device operation (kernel, memset, copy)
    that one call of fn launches, traced by torch.profiler on the card
    after a warm-up call.  A trace that caught no device operation is
    taken again, twice at most (a call may launch none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = [[e.name, e.time_range.elapsed_us()]
               for e in prof.events() if e.device_type.name == 'CUDA']
        if ops:
            break
    return ops


def short_name(kernel: str) -> str:
    """A device operation's name without its namespaces, template and
    function arguments."""
    return (kernel.replace('(anonymous namespace)::', '')
            .removeprefix('void ').split('(')[0].split('<')[0]
            .split('::')[-1])


def gather_case(name, table, idx, gen) -> dict:
    """The gather and scatter kernels against their plain versions at one
    shape, with times, bounds and the device operations of one call."""
    import torch
    from nice_slam_tpu_torch.ops import gather as ga
    m, w = table.shape
    n = idx.shape[0]
    grad = torch.randn((n, w), generator=gen, device='cuda')
    got, plain = ga.gather_rows(table, idx), ga.gather_rows_plain(table, idx)
    if not torch.equal(got, plain):
        raise AssertionError(f'gather_rows != table[idx] at {name}')
    gather_err = float((got - plain).abs().max()) if n else 0.0
    del got, plain
    want = ga.scatter_add_rows_plain(grad, idx, m)
    got = ga.scatter_add_rows(grad, idx, m)
    err = float((got - want).abs().max())
    if not err <= SCATTER_TOL * max(1.0, float(want.abs().max())):
        raise AssertionError(f'scatter_add_rows off by {err} at {name}')
    # autograd's backward of table[idx]: PyTorch's sort-based index_put_
    # with accumulate, whose summation order the kernel keeps bit for bit
    put = torch.zeros((m, w), device='cuda').index_put_((idx,), grad,
                                                        accumulate=True)
    if not torch.equal(got, put):
        raise AssertionError(f'scatter_add_rows != index_put_ accumulate at '
                             f'{name}')
    if not torch.equal(got, ga.scatter_add_rows(grad, idx, m)):
        raise AssertionError(f'scatter_add_rows differs between two calls '
                             f'at {name}')
    del got, want, put
    ops = {
        'gather_rows': device_ops(lambda: ga.gather_rows(table, idx)),
        'index_select': device_ops(lambda: table.index_select(0, idx)),
        'scatter_add_rows': device_ops(lambda: ga.scatter_add_rows(
            grad, idx, m)),
        'index_add_': device_ops(lambda: ga.scatter_add_rows_plain(
            grad, idx, m)),
        'index_put_accumulate': device_ops(lambda: torch.zeros(
            (m, w), device='cuda').index_put_((idx,), grad,
                                              accumulate=True))}
    if any('sort' in o.lower() or 'fill' in o.lower()
           for o, _ in ops['scatter_add_rows']):
        raise AssertionError(f'scatter_add_rows sorts or fills at {name}: '
                             f'{ops["scatter_add_rows"]}')
    # bytes each function must move: the forward reads the rows this
    # index touches (each once) and the index, and writes [n, w]; the
    # backward reads the gradient and the index and writes [m, w]
    distinct = int(torch.unique(idx).numel())
    isize = idx.element_size()
    fwd_bytes = distinct * w * 4 + n * isize + n * w * 4
    bwd_bytes = n * w * 4 + n * isize + m * w * 4
    return {
        'case': name, 'rows': m, 'width': w, 'n': n,
        'distinct_rows': distinct,
        'longest_segment': (int(torch.bincount(idx, minlength=m).max())
                            if n else 0),
        'gather_ms': cuda_ms(lambda: ga.gather_rows(table, idx)),
        'gather_plain_ms': cuda_ms(lambda: ga.gather_rows_plain(table,
                                                                 idx)),
        'gather_library_ms': cuda_ms(lambda: table.index_select(0, idx)),
        'gather_bound_ms': fwd_bytes / HBM_BYTES_PER_S * 1e3,
        'scatter_ms': cuda_ms(lambda: ga.scatter_add_rows(grad, idx, m)),
        # the plain version is index_add_ into zeros, the library call
        'scatter_plain_ms': cuda_ms(lambda: ga.scatter_add_rows_plain(
            grad, idx, m)),
        'index_put_accumulate_ms': cuda_ms(lambda: torch.zeros(
            (m, w), device='cuda').index_put_((idx,), grad,
                                              accumulate=True)),
        'scatter_bound_ms': bwd_bytes / HBM_BYTES_PER_S * 1e3,
        'gather_max_abs_err': gather_err,
        'scatter_max_abs_err': err,
        'device_ops_per_call': {k: len(v) for k, v in ops.items()},
        'scatter_device_ops': [[short_name(o), us]
                               for o, us in ops['scatter_add_rows']],
    }


def expanded_vs_direct(gen) -> dict:
    """At room0's finecolor volume and one mapping iteration's points, one
    forward+backward of the port's expanded-row interpolation (expand,
    gather, scatter, fold kernels) against the direct 8-corner gather of
    the flat grid (plain PyTorch, autograd)."""
    import torch
    from nice_slam_tpu_torch.ops.trilinear import (
        expand_grid, trilinear_interp, trilinear_interp_expanded)
    shape, c = MAIN_SHAPES['finecolor']
    m = shape[0] * shape[1] * shape[2]
    g = (0.1 * torch.randn((m, c), generator=gen, device='cuda')
         ).requires_grad_()
    rays = MAP_POINTS // 48
    o = torch.rand((rays, 1, 3), generator=gen, device='cuda') - 0.5
    d = torch.nn.functional.normalize(
        torch.randn((rays, 1, 3), generator=gen, device='cuda'), dim=-1)
    t = torch.linspace(0.1, 1.2, 48, device='cuda')[None, :, None]
    p = (o + t * d).reshape(-1, 3).clamp(-1.0, 1.0)
    cot = torch.randn((p.shape[0], c), generator=gen, device='cuda')

    def expanded():
        out = trilinear_interp_expanded(expand_grid(g, shape), p)
        return out, torch.autograd.grad(out, g, cot)[0]

    def direct():
        out = trilinear_interp(g, p, shape)
        return out, torch.autograd.grad(out, g, cot)[0]

    (oe, ge), (od, gd) = expanded(), direct()
    err = max(float((oe - od).abs().max().detach()),
              float((ge - gd).abs().max()))
    if not err <= 1e-4 * max(1.0, float(gd.abs().max())):
        raise AssertionError(f'expanded-row and direct paths differ by {err}')
    with torch.no_grad():
        fwd_e = cuda_ms(lambda: trilinear_interp_expanded(
            expand_grid(g, shape), p))
        fwd_d = cuda_ms(lambda: trilinear_interp(g, p, shape))
    return {'shape': list(shape), 'c': c, 'points': int(p.shape[0]),
            'max_abs_diff': err,
            'expanded_fwd_bwd_ms': cuda_ms(expanded),
            'direct_fwd_bwd_ms': cuda_ms(direct),
            'expanded_fwd_ms': fwd_e, 'direct_fwd_ms': fwd_d}


def host_us(fn, calls: int = 200, runs: int = 7) -> float:
    """Host microseconds per call: the median of `runs` runs of `calls`
    back-to-back calls, the device drained before each run."""
    import torch
    for _ in range(10):
        fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def host_costs(gen) -> dict:
    """Host time per call of the row wrappers and their library calls at
    room0's middle table: a tracking iteration's rows for the gather, both
    as the tracker calls it (the snapshot needs no gradient: gather_rows
    directly) and through GatherRows.apply; a mapping iteration's for the
    scatter.  A call's host time bounds its time on the card from below
    when calls go back to back."""
    import torch
    from nice_slam_tpu_torch.ops import gather as ga
    shape, c = MAIN_SHAPES['middle']
    m, w = shape[0] * shape[1] * shape[2], 8 * c
    table = torch.randn((m, w), generator=gen, device='cuda')
    track = torch.randint(0, m, (TRACK_POINTS,), generator=gen, device='cuda')
    mapping = torch.randint(0, m, (MAP_POINTS,), generator=gen, device='cuda')
    grad = torch.randn((MAP_POINTS, w), generator=gen, device='cuda')
    return {
        'gather_rows': host_us(lambda: ga.gather_rows(table, track)),
        'GatherRows.apply': host_us(lambda: ga.GatherRows.apply(table,
                                                                track)),
        'index_select': host_us(lambda: table.index_select(0, track)),
        'scatter_add_rows': host_us(lambda: ga.scatter_add_rows(
            grad, mapping, m)),
        'index_add_ into zeros': host_us(lambda: ga.scatter_add_rows_plain(
            grad, mapping, m))}


def phase_gather() -> dict:
    import torch
    gen = torch.Generator(device='cuda').manual_seed(5)
    cases = []
    for w in GATHER_SWEEP_WIDTHS:
        rows = max(60 * 1024 * 1024 // (w * 4), 1024)
        table = torch.randn((rows, w), generator=gen, device='cuda')
        idx = torch.randint(0, rows, (GATHER_SWEEP_N,), generator=gen,
                            device='cuda')
        cases.append(gather_case(f'sweep_w{w}', table, idx, gen))
    table = torch.randn((59 * 1024, 256), generator=gen, device='cuda')
    cases.append(gather_case('runs48', table, ray_walk_index(
        240 * 1024, 59 * 1024, gen), gen))
    table = torch.randn((58240, 128), generator=gen, device='cuda')
    cases.append(gather_case('paths', table, torch.randint(
        0, 58240, (48000,), generator=gen, device='cuda'), gen))
    for vol in ('middle', 'finecolor'):
        shape, c = MAIN_SHAPES[vol]
        rows = shape[0] * shape[1] * shape[2]
        table = torch.randn((rows, 8 * c), generator=gen, device='cuda')
        for call, n in (('mapping', MAP_POINTS), ('tracking', TRACK_POINTS)):
            idx = ray_walk_index(n, rows, gen)
            cases.append(gather_case(f'room0_{vol}_{call}', table, idx, gen))
        if vol == 'middle':
            # adversarial: every position on one row, no positions, and
            # the mapping index reversed (each segment placed descending)
            idx = ray_walk_index(MAP_POINTS, rows, gen)
            for case, bad in (('one_row', torch.full_like(idx, rows // 2)),
                              ('n0', idx[:0]), ('reversed', idx.flip(0))):
                cases.append(gather_case(f'room0_middle_mapping_{case}',
                                         table, bad, gen))
        del table
    res = {'phase': 'gather', 'cases': cases,
           'tolerance': {'gather_rows': 0.0,
                         'scatter_add_rows':
                             f'{SCATTER_TOL} x max(1, max|index_add_|)'},
           'expanded_vs_direct': expanded_vs_direct(gen),
           'host_us_per_call': host_costs(gen)}
    emit(res)
    return {c['case']: c for c in cases}


def phase_real_index(real: dict) -> dict:
    """The gather and scatter at room0's middle and fine+color tables on
    the index of the room0 run's last mapping iteration on each (kept by
    phase_room0): the distribution the main path gives the scatter, whose
    longest segments the ray walks of phase_gather do not have."""
    import torch
    gen = torch.Generator(device='cuda').manual_seed(6)
    cases = []
    for vol in ('middle', 'finecolor'):
        shape, c = MAIN_SHAPES[vol]
        rows = shape[0] * shape[1] * shape[2]
        if rows not in real:
            raise AssertionError(f'room0 made no scatter call on its {vol} '
                                 f'table')
        table = torch.randn((rows, 8 * c), generator=gen, device='cuda')
        cases.append(gather_case(f'room0_{vol}_mapping_real', table,
                                 real[rows], gen))
        del table
    emit({'phase': 'gather_real_index', 'cases': cases})
    return {c['case']: c for c in cases}


def phase_roofline() -> dict:
    """The probes and expand_corners against their plain versions, then the
    study: each timed at each shape, with the probes' launches counted
    (the comparisons before are not)."""
    import torch
    from nice_slam_tpu_torch.ops import expand as ex
    from nice_slam_tpu_torch.ops import roofline as rf
    gen = torch.Generator(device='cuda').manual_seed(6)
    inputs, errs = {}, {}
    for name, (shape, c) in ROOFLINE_SHAPES.items():
        m = shape[0] * shape[1] * shape[2]
        small = torch.randn((m, c), generator=gen, device='cuda')
        big = torch.randn((m, 8 * c), generator=gen, device='cuda')
        for mode in (*rf.MODES, 'expand_corners'):
            if mode == 'expand_corners':
                got = ex.expand_corners(small, shape)
                plain = ex.expand_plain(small, shape)
            else:
                x = big if mode == 'copy' else small
                got = rf.probe(mode, x, shape)
                plain = rf.probe_plain(mode, x, shape)
            if not torch.equal(got, plain):
                raise AssertionError(f'{mode} != plain at {name}')
            errs[name, mode] = float((got - plain).abs().max())
        inputs[name] = (shape, c, small, big)
    rf.reset_launch_counts()
    rows = []
    for name, (shape, c, small, big) in inputs.items():
        m = shape[0] * shape[1] * shape[2]
        rows_same_x = corner_rows(shape, 'cuda', same_x=True)
        library = {
            'copy': lambda: big.clone(),
            'widen8': lambda: small.repeat(1, 8),
            'shifts': None,
            'expand_same_x': lambda: small.index_select(
                0, rows_same_x).reshape(m, 8 * c)}
        for mode in rf.MODES:
            x = big if mode == 'copy' else small
            nbytes = rf.probe_bytes(mode, x)
            ms = cuda_ms(lambda: rf.probe(mode, x, shape))
            rows.append({
                'shape_name': name, 'shape': list(shape), 'c': c,
                'probe': mode, 'bytes': nbytes, 'ms': ms,
                'max_abs_err': errs[name, mode],
                # the plain shifts / expand_same_x loop over x-planes in
                # Python (~10-20 ms a call): fewer windows
                'plain_ms': cuda_ms(lambda: rf.probe_plain(mode, x, shape),
                                    reps=5, inner=2),
                'library_ms': (cuda_ms(library[mode]) if library[mode]
                               else None),
                'gb_per_s': nbytes / ms / 1e6,
                'share_of_hbm': nbytes / ms / 1e-3 / HBM_BYTES_PER_S,
                'bound_ms': nbytes / HBM_BYTES_PER_S * 1e3})
        nbytes = 9 * m * c * 4
        ms = cuda_ms(lambda: ex.expand_corners(small, shape))
        rows.append({
            'shape_name': name, 'shape': list(shape), 'c': c,
            'probe': 'expand_corners', 'bytes': nbytes, 'ms': ms,
            'max_abs_err': errs[name, 'expand_corners'],
            'plain_ms': cuda_ms(lambda: ex.expand_plain(small, shape)),
            'library_ms': cuda_ms(lambda: small.index_select(
                0, corner_rows(shape, 'cuda')).reshape(m, 8 * c)),
            'gb_per_s': nbytes / ms / 1e6,
            'share_of_hbm': nbytes / ms / 1e-3 / HBM_BYTES_PER_S,
            'bound_ms': nbytes / HBM_BYTES_PER_S * 1e3})
    launches = dict(rf.LAUNCHES)
    # the copy against clone, also as device time alone (CUDA graphs), with
    # host time per call at the smallest shape (those launches come after
    # the count is read)
    copies = {}
    for name, (shape, c, small, big) in inputs.items():
        r = next(r for r in rows if r['probe'] == 'copy'
                 and r['shape_name'] == name)
        copies[name] = {
            'bytes': r['bytes'], 'ms': r['ms'], 'clone_ms': r['library_ms'],
            'bytes_per_s': r['bytes'] / r['ms'] * 1e3,
            'clone_bytes_per_s': r['bytes'] / r['library_ms'] * 1e3,
            'no_slower_than_clone': r['ms'] <= r['library_ms'],
            'graph_ms': graph_ms(lambda: rf.probe('copy', big)),
            'clone_graph_ms': graph_ms(lambda: big.clone())}
        copies[name]['no_slower_than_clone_on_device'] = (
            copies[name]['graph_ms'] <= copies[name]['clone_graph_ms'])
    small_big = inputs['study_default'][3]
    copies['study_default'].update(
        host_us=host_us(lambda: rf.probe('copy', small_big)),
        clone_host_us=host_us(lambda: small_big.clone()))
    copy = copies['room0_finecolor']
    # the measured streaming bound: the faster of the copy probe and clone
    # at room0's finecolor buffer (a bound may not be more lenient than a
    # copy the card was seen to make)
    res = {'phase': 'roofline', 'rows': rows, 'launches': launches,
           'copy_vs_clone': copies,
           'copy_bytes_per_s': copy['bytes_per_s'],
           'clone_bytes_per_s': copy['clone_bytes_per_s'],
           'measured_stream_bytes_per_s': max(copy['bytes_per_s'],
                                              copy['clone_bytes_per_s']),
           'datasheet_bytes_per_s': HBM_BYTES_PER_S}
    emit(res)
    if min(launches.values()) == 0:
        raise AssertionError(f'probes not launched: {launches}')
    return res

def run_slam(cfg: dict, output: str, mesh: bool = True, nice: bool = True):
    """One SlamSystem run on the card with every kernel's count set to 0
    just before and read just after; every kernel of the NICE path must
    have launched (the fused MLP only runs in meshes), and none in iMAP*
    mode (nice=False), whose path has no kernel of rows 1-11.  Returns
    (result, the system)."""
    import numpy as np
    import torch
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    from nice_slam_tpu_torch.eval.ate import evaluate_ate
    from nice_slam_tpu_torch.ops import expand as ex
    from nice_slam_tpu_torch.ops import fused_mlp as fm
    from nice_slam_tpu_torch.ops import gather as ga
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in (ex, fm, ga):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    slam = SlamSystem(cfg, nice=nice, device='cuda', seed=0, output=output)
    if not mesh:
        slam.mesher = None
    slam.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**ex.LAUNCHES, **ga.LAUNCHES,
                **(fm.LAUNCHES if mesh or not nice else {})}
    est, gt = slam.estimate_c2w, slam.gt_c2w
    if not np.isfinite(est).all():
        raise AssertionError('non-finite pose estimate')
    err = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=-1)
    ate = evaluate_ate(est, gt)
    tracked = [s * 1e3 for idx, s in slam.timers.track if idx > 0]
    res = {
        'method': 'nice' if nice else 'imap',
        'frames': int(slam.n_img), 'wall_s': wall,
        'ate_rmse_m': ate['absolute_translational_error.rmse'],
        'max_frame_err_m': float(err.max()),
        'track_ms_per_frame': statistics.mean(tracked),
        # under loose, frame 1 waits for the first-frame round
        'track_ms_median': statistics.median(tracked),
        'map_calls_ms': [{'frame': idx, 'kind': kind, 'iters': n,
                          'ms': s * 1e3}
                         for idx, kind, n, s in slam.timers.maps],
        'mesh_s': slam.timers.mesh_s,
        'meshes': [{'file': name, 's': sec, 'pieces_s': pieces}
                   for name, sec, pieces in slam.timers.meshes],
        'peak_mem_bytes': int(torch.cuda.max_memory_allocated()),
        'sync_method': slam.sync_method, 'refreshes': dict(slam.refreshes),
        'launches': launches,
    }
    if nice and min(launches.values()) == 0:
        raise AssertionError(f'kernels not launched: {launches}')
    if not nice and max(launches.values()) != 0:
        raise AssertionError(f'the iMAP* path launched NICE kernels: '
                             f'{launches}')
    return res, slam


def mesh_vertices(path: str) -> int:
    from nice_slam_tpu_torch.mesh.mesher import load_ply
    if not os.path.exists(path):
        raise AssertionError(f'{path} was not written')
    verts, tris = load_ply(path)
    if len(verts) == 0 or len(tris) == 0:
        raise AssertionError(f'{path} is empty')
    return len(verts)


def check_restore(cfg: dict, slam, output: str, nice: bool = True) -> None:
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
        fresh = SlamSystem(cfg, nice=nice, device='cuda', seed=1,
                           output=other)
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
    emit({'phase': 'restore', 'method': 'nice' if nice else 'imap',
          'checkpoint': os.path.basename(path),
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


def room0_cfg() -> dict:
    from nice_slam_tpu_torch.utils.config import load_config
    cfg = load_config('configs/Replica/room0.yaml', 'configs/nice_slam.yaml')
    # Replica frames are not in the repository: the analytic scene at
    # room0's intrinsics and frame size, its box inside room0's bound
    cfg['dataset'] = 'synthetic'
    cfg['synthetic'] = {'n_frames': 12, 'radius': 0.8, 'step': 0.02,
                        'noise': 0.003,
                        'box': [[-2.8, 8.8], [-3.1, 5.4], [-3.4, 3.2]]}
    cfg['verbose'] = False
    return cfg


def phase_room0(out: str):
    """The room0 run; returns its result, the system and, per table rows,
    the index of the last scatter call on that table (the wrapper is
    wrapped to keep it and still counts its own launches)."""
    from nice_slam_tpu_torch.ops import gather as ga
    cfg = room0_cfg()
    real = {}
    scatter = ga.scatter_add_rows

    def keeping(grad, idx, m):
        real[m] = idx
        return scatter(grad, idx, m)

    ga.scatter_add_rows = keeping
    try:
        res, slam = run_slam(cfg, out)
    finally:
        ga.scatter_add_rows = scatter
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
    return res, slam, real


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


def phase_overlap(strict_room0: dict) -> dict:
    """synthetic.yaml and room0 under sync_method: loose."""
    from nice_slam_tpu_torch.utils.config import load_config
    cfg = load_config('configs/Synthetic/synthetic.yaml',
                      'configs/nice_slam.yaml')
    cfg['verbose'] = False
    cfg['sync_method'] = 'loose'
    with tempfile.TemporaryDirectory() as out:
        syn, _ = run_slam(cfg, out, mesh=False)
    syn.update(phase='overlap_synthetic',
               config='configs/Synthetic/synthetic.yaml',
               bound_ate_rmse_m=LOOSE_BOUND_ATE_RMSE_M,
               bound_max_frame_err_m=LOOSE_BOUND_MAX_ERR_M)
    emit(syn)
    if not (syn['ate_rmse_m'] <= LOOSE_BOUND_ATE_RMSE_M
            and syn['max_frame_err_m'] <= LOOSE_BOUND_MAX_ERR_M):
        raise AssertionError('synthetic accuracy under loose outside the '
                             'JAX loose bound')
    cfg = room0_cfg()
    cfg['sync_method'] = 'loose'
    with tempfile.TemporaryDirectory() as out:
        room0, _ = run_slam(cfg, out, mesh=False)
    maps = [r for r in room0['map_calls_ms'] if r['kind'] != 'coarse']
    room0.update(
        phase='overlap_room0', config='configs/Replica/room0.yaml',
        dataset='synthetic', meshes='none (skipped in this run)',
        strict_wall_s=strict_room0['wall_s'],
        strict_wall_s_without_meshes=(strict_room0['wall_s']
                                      - strict_room0['mesh_s']),
        strict_track_ms_per_frame=strict_room0['track_ms_per_frame'],
        strict_track_ms_median=strict_room0['track_ms_median'],
        map_ms_per_call=statistics.mean(r['ms'] for r in maps[1:]),
        strict_map_calls=len([r for r in strict_room0['map_calls_ms']
                              if r['kind'] != 'coarse']),
        loose_map_calls=len(maps),
        strict_ate_rmse_m=strict_room0['ate_rmse_m'],
        strict_max_frame_err_m=strict_room0['max_frame_err_m'],
        bound_ate_rmse_m=LOOSE_ROOM0_FACTOR * strict_room0['ate_rmse_m'],
        bound_max_frame_err_m=(LOOSE_ROOM0_FACTOR
                               * strict_room0['max_frame_err_m']))
    emit(room0)
    if not (room0['ate_rmse_m'] <= room0['bound_ate_rmse_m']
            and room0['max_frame_err_m'] <= room0['bound_max_frame_err_m']):
        raise AssertionError(f'room0 accuracy under loose outside '
                             f'{LOOSE_ROOM0_FACTOR}x the strict run\'s')
    return room0


def phase_imap_accuracy() -> None:
    """iMAP* on synthetic_imap.yaml, held to the JAX package's seeds."""
    from nice_slam_tpu_torch.eval.recon import calc_3d_metric
    from nice_slam_tpu_torch.io.datasets import synthetic_gt_mesh
    from nice_slam_tpu_torch.mesh.mesher import load_ply
    from nice_slam_tpu_torch.utils.config import load_config
    cfg = load_config('configs/Synthetic/synthetic_imap.yaml',
                      'configs/imap.yaml')
    cfg['verbose'] = False
    with tempfile.TemporaryDirectory() as out:
        res, slam = run_slam(cfg, out, nice=False)
        mesh_path = os.path.join(out, 'mesh', 'final_mesh.ply')
        res['mesh_vertices'] = mesh_vertices(mesh_path)
        rec_v, rec_t = load_ply(mesh_path)
        gt_v, gt_t = synthetic_gt_mesh(cfg['synthetic']['box'])
        res['recon'] = calc_3d_metric(rec_v, rec_t, gt_v, gt_t, align=False)
        res.update(phase='imap_accuracy',
                   config='configs/Synthetic/synthetic_imap.yaml',
                   mesh_resolution=slam.mesher.cfg.resolution,
                   level_set=slam.mesher.cfg.level_set,
                   bound_ate_rmse_m=IMAP_BOUND_ATE_RMSE_M,
                   bound_max_frame_err_m=IMAP_BOUND_MAX_ERR_M,
                   bound_accuracy_cm=IMAP_BOUND_ACCURACY_CM,
                   bound_completion_cm=IMAP_BOUND_COMPLETION_CM,
                   bound_completion_ratio_pct=IMAP_BOUND_COMPLETION_RATIO_PCT)
        emit(res)
        if not (res['ate_rmse_m'] <= IMAP_BOUND_ATE_RMSE_M
                and res['max_frame_err_m'] <= IMAP_BOUND_MAX_ERR_M):
            raise AssertionError('iMAP* synthetic accuracy outside the JAX '
                                 'bound')
        rec = res['recon']
        if not (rec['accuracy_cm'] <= IMAP_BOUND_ACCURACY_CM
                and rec['completion_cm'] <= IMAP_BOUND_COMPLETION_CM
                and rec['completion_ratio_%']
                >= IMAP_BOUND_COMPLETION_RATIO_PCT):
            raise AssertionError('iMAP* synthetic reconstruction outside the '
                                 'JAX bound')
        check_restore(cfg, slam, out, nice=False)


def imap_room0_cfg() -> dict:
    """room0_imap.yaml over imap.yaml on the analytic scene at room0's
    intrinsics and frame size, its box inside room0's bound after imap's
    scale 0.1; depth cut to 7 frames (the first map and normal mapping
    calls at frames 5 and 6), iters_first to 300, the last frame's color
    refine (5 x 300 iterations on a window of 10) and the eval_rec mesh
    left out."""
    from nice_slam_tpu_torch.utils.config import load_config
    cfg = load_config('configs/Replica/room0_imap.yaml', 'configs/imap.yaml')
    box = [[-2.8, 8.8], [-3.1, 5.4], [-3.4, 3.2]]
    for (lo, hi), (blo, bhi) in zip(box, cfg['mapping']['bound']):
        if not blo < lo < hi < bhi:
            raise AssertionError('the scene box is not inside room0\'s '
                                 'bound')
    cfg['dataset'] = 'synthetic'
    cfg['synthetic'] = {'n_frames': 7, 'radius': 0.8, 'step': 0.02,
                        'noise': 0.003, 'box': box}
    cfg['mapping']['iters_first'] = 300
    cfg['mapping']['color_refine'] = False
    cfg['meshing']['eval_rec'] = False
    cfg['verbose'] = False
    return cfg


def phase_imap_room0() -> None:
    """iMAP* at room0_imap's full width: times, one mesh, one render."""
    import numpy as np
    import torch
    from nice_slam_tpu_torch.render.renderer import render_image
    cfg = imap_room0_cfg()
    with tempfile.TemporaryDirectory() as out:
        res, slam = run_slam(cfg, out, nice=False)
        res['mesh_vertices'] = mesh_vertices(
            os.path.join(out, 'mesh', 'final_mesh.ply'))
        idx = slam.n_img - 1
        _, _, depth_np, _ = slam.frame_reader[idx]
        c2w = torch.as_tensor(slam.estimate_c2w[idx], device='cuda')
        gt_depth = torch.as_tensor(depth_np, dtype=torch.float32,
                                   device='cuda')
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        depth, _, color = render_image(
            slam.decoders, slam.grids, c2w, slam.intr, stage='color',
            model=slam.model, rcfg=slam.rcfg, gt_depth=gt_depth)
        torch.cuda.synchronize()
        render_ms = (time.perf_counter() - t0) * 1e3
        render_peak = int(torch.cuda.max_memory_allocated())
        finite_render = bool(torch.isfinite(depth).all()
                             and torch.isfinite(color).all())
    tracked = [s * 1e3 for idx, s in slam.timers.track if idx > 0]
    normal = [r['ms'] for r in res['map_calls_ms'] if r['kind'] == 'normal']
    rc, tc = slam.rcfg, slam.tcfg
    res.update(
        phase='imap_room0', config='configs/Replica/room0_imap.yaml',
        dataset='synthetic', size=[slam.intr.H, slam.intr.W],
        tracking=f'{tc.pixels} px x {tc.iters} iters',
        mapping=f'{slam.mcfg.pixels} px x {slam.mcfg.iters} iters '
                f'(3 outer), iters_first {slam.mcfg.iters_first}',
        samples=f'{rc.n_samples} + {rc.n_importance} importance',
        hidden=slam.dcfg.imap_hidden,
        track_ms_range=[min(tracked), max(tracked)],
        map_normal_ms=normal,
        mesh_resolution=slam.mesher.cfg.resolution,
        render_ms=render_ms, render_peak_mem_bytes=render_peak)
    emit(res)
    if not (np.isfinite(res['ate_rmse_m']) and finite_render):
        raise AssertionError('iMAP* room0 gave non-finite results')
    if not normal or res['mesh_resolution'] != 256:
        raise AssertionError('iMAP* room0 made no normal mapping call or '
                             'did not mesh at 256^3')


def _entry(row, name, source, replaces, launches, err, ms, plain_ms,
           bound_ms, library_ms, shape, bound_by='bytes', **extra):
    return {'row': row, 'name': name, 'route': 'cuda',
            'source': f'nice_slam_tpu_torch/csrc/{source}',
            'replaces': replaces, 'launches': launches, 'max_abs_err': err,
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
            'bound_by': bound_by, 'library_ms': library_ms, 'shape': shape,
            **extra}


def kernel_table(kern: dict, mlp: dict, room0: dict, gather: dict,
                 roof: dict) -> list:
    """One entry per TPU function that reaches pl.pallas_call (rows 1-11
    of PERF.md's table; row 10's three bodies one entry each), plus the
    gather's backward.  Launches are the room0 run's, the probes' those
    of the roofline study.  measured_bound_ms: the bytes over the measured
    streaming rate (the faster of the copy probe and clone)."""
    times = kern['times']['finecolor']
    fine = mlp['times']['fine']
    stream = roof['measured_stream_bytes_per_s']
    lau = room0['launches']
    pal = 'nice_slam_tpu/ops/pallas/'
    stud = 'scripts/studies/'
    fc = 'finecolor 74x56x44 C64'
    fc_bytes = times['bytes']

    def expand_row(row, replaces):
        return _entry(row, 'expand_corners', 'expand.cu', replaces,
                      lau['expand_corners'], kern['err']['expand_corners'],
                      times['expand_ms'], times['expand_plain_ms'],
                      times['bytes_bound_ms'], times['expand_library_ms'],
                      fc, measured_bound_ms=fc_bytes / stream * 1e3)

    def fold_row(row, replaces):
        return _entry(row, 'fold_corners', 'expand.cu', replaces,
                      lau['fold_corners'], kern['err']['fold_corners'],
                      times['fold_ms'], times['fold_plain_ms'],
                      times['bytes_bound_ms'], times['fold_library_ms'], fc,
                      measured_bound_ms=fc_bytes / stream * 1e3)

    def room0_cases(keys):
        return {case: {k: gather[case][k] for k in keys}
                for case in ROOM0_GATHER_CASES if case in gather}

    def gather_row(row, replaces, case):
        c = gather[case]
        return _entry(row, 'gather_rows', 'gather.cu', replaces,
                      lau['gather_rows'], c['gather_max_abs_err'],
                      c['gather_ms'],
                      c['gather_plain_ms'], c['gather_bound_ms'],
                      c['gather_library_ms'],
                      f'{case}: [{c["rows"]}, {c["width"]}], {c["n"]} rows',
                      measured_bound_ms=c['gather_bound_ms']
                      * HBM_BYTES_PER_S / stream,
                      room0=room0_cases(('gather_ms', 'gather_plain_ms',
                                         'gather_library_ms',
                                         'gather_bound_ms')))

    def scatter_row(case):
        c = gather[case]
        # the faster of the two one-call libraries
        lib = min(('index_add_', c['scatter_plain_ms']),
                  ('index_put_ accumulate', c['index_put_accumulate_ms']),
                  key=lambda x: x[1])
        return _entry('6-8 backward', 'scatter_add_rows', 'gather.cu',
                      'nice_slam_tpu/ops/trilinear.py:193 (XLA transpose of '
                      'the row gather; no Pallas kernel)',
                      lau['scatter_add_rows'], c['scatter_max_abs_err'],
                      c['scatter_ms'], c['scatter_plain_ms'],
                      c['scatter_bound_ms'], lib[1],
                      f'{case}: [{c["rows"]}, {c["width"]}], {c["n"]} rows '
                      f'on {c["distinct_rows"]}, longest segment '
                      f'{c["longest_segment"]}',
                      measured_bound_ms=c['scatter_bound_ms']
                      * HBM_BYTES_PER_S / stream,
                      library_call=lib[0],
                      index_put_accumulate_ms=c['index_put_accumulate_ms'],
                      room0=room0_cases(('scatter_ms', 'scatter_plain_ms',
                                         'index_put_accumulate_ms',
                                         'scatter_bound_ms')))

    def probe_row(row, mode, replaces, shape_name='study_variants'):
        r = next(r for r in roof['rows'] if r['probe'] == mode
                 and r['shape_name'] == shape_name)
        name = 'expand_corners' if mode == 'expand_corners' \
            else f'roofline_{mode}'
        launches = (lau['expand_corners'] if mode == 'expand_corners'
                    else roof['launches'][name])
        return _entry(row, name, 'expand.cu' if mode == 'expand_corners'
                      else 'roofline.cu', replaces, launches,
                      r['max_abs_err'], r['ms'],
                      r['plain_ms'], r['bound_ms'], r['library_ms'],
                      f'{shape_name} {r["shape"]} C{r["c"]}',
                      measured_bound_ms=r['bytes'] / stream * 1e3)

    return [
        expand_row(1, pal + 'expand.py:390'),
        expand_row(2, pal + 'expand.py:319'),
        fold_row(3, pal + 'expand.py:421'),
        fold_row(4, pal + 'expand.py:356'),
        _entry(5, 'fused_mlp', 'fused_mlp.cu', pal + 'fused_mlp.py:90',
               lau['fused_mlp'], mlp['err'], fine['ms'], fine['plain_ms'],
               fine['bound_ms'], None,
               f'fine decoder, {POINTS_BATCH} points, c 64',
               bound_by=fine['bound_by'],
               fp32_core_bound_ms=fine['fp32_core_bound_ms'],
               bytes_bound_ms=fine['bytes_bound_ms'],
               others={k: {x: mlp['times'][k][x] for x in (
                   'ms', 'plain_ms', 'bound_ms', 'fp32_core_bound_ms')}
                   for k in ('middle', 'color')}),
        gather_row(6, stud + 'proto_gather_sweep.py:57', 'sweep_w1024'),
        gather_row(7, stud + 'proto_pallas_gather.py:42', 'runs48'),
        gather_row(8, stud + 'proto_gather_paths.py:95', 'paths'),
        # the main path's index, on the table where it costs the most
        scatter_row('room0_middle_mapping_real'),
        probe_row(9, 'copy', stud + 'proto_expand_roofline.py:87',
                  'study_default'),
        probe_row('10 concat8', 'widen8',
                  stud + 'proto_expand_roofline.py:134'),
        probe_row('10 shifts_only', 'shifts',
                  stud + 'proto_expand_roofline.py:134'),
        probe_row('10 full', 'expand_same_x',
                  stud + 'proto_expand_roofline.py:134'),
        probe_row(11, 'expand_corners',
                  stud + 'proto_expand_roofline.py:211'),
    ]


def parse_args(argv):
    import argparse
    ap = argparse.ArgumentParser(description='Chip smoke test of the '
                                 'PyTorch/CUDA port on one GPU.')
    ap.add_argument('--ab-parent', metavar='DIR',
                    help="time the fused MLP against another tree's "
                    "(DIR holds that tree's ops/fused_mlp.py and "
                    'csrc/fused_mlp.cu) after the kernels phase')
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
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
    seconds = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    try:
        card = phase_card()
        ptxas = phase_build()
        lap('build')
        kern = phase_kernels()
        mlp = phase_fused_mlp(ptxas['nice_slam_tpu_torch/csrc/fused_mlp.cu'])
        phase_model_parity()
        lap('kernels')
        if args.ab_parent:
            phase_mlp_ab(args.ab_parent)
            lap('fused_mlp_ab')
        gather = phase_gather()
        lap('gather')
        roof = phase_roofline()
        lap('roofline')
        phase_accuracy()
        lap('accuracy')
        with tempfile.TemporaryDirectory() as out:
            room0, slam, real = phase_room0(out)
            lap('room0')
            phase_render(slam)
        del slam
        lap('render')
        gather.update(phase_real_index(real))
        del real
        lap('real_index')
        phase_overlap(room0)
        lap('overlap')
        phase_imap_accuracy()
        lap('imap_accuracy')
        phase_imap_room0()
        lap('imap_room0')
        if any(k in sys.modules for k in ('jax', 'nice_slam_tpu')):
            raise AssertionError('the JAX package was imported')
    except Exception:
        traceback.print_exc()
        return 1
    emit({'phase': 'seconds', **seconds})
    emit({'kernels': kernel_table(kern, mlp, room0, gather, roof)})
    print(card, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
