#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (nice_slam_tpu_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py [--ab-parent DIR]

It needs one card; with more it also runs the parallel phases one rank a
card and the two-device pipeline.

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
               then the port's model on the card against the port on the CPU;
               then the decoder stack's bfloat16 products
               (models/precision.py, `aten::mm.dtype`) at room0_imap's
               hidden layer [65536, 256] @ [256, 256] and its embedding
               [65536, 3] @ [3, 93] (and at 4,097 rows), one and three
               passes with a bias, forward and both gradients, each element
               within 2 (K + 2) 2^-24 (|A|.|B| + |bias|) of the plain
               version and the error's rms within 16 sqrt(K) 2^-24 of it
               (phase precision), with the one-pass product's time beside
               float32 torch.mm's
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
               per call at 28x21x14; row 10's widen8, shifts and
               expand_same_x (and repeat / index_select) also as device
               time alone at 64x48x40;
               the faster of copy and clone at room0's finecolor buffer is
               the measured streaming bound
     formats   every dataset format (Replica, ScanNet with an invalid-pose
               frame, TUM RGB-D, CoFusion, Azure) written by the port's
               fixture tool, 6 frames of the analytic scene at 60x80, read
               back through get_dataset and held to the fixture tests'
               bars (color, depth, poses; TUM's association count); a TUM
               variant with freiburg1_desk.yaml's distortion, crop_size and
               crop_edge, and a ScanNet variant whose color is twice the
               depth's size; the loader's ms per frame
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
     disk_accuracy  synthetic.yaml's 40 frames written in Replica format
               by the port's writer and run from those files
               (SlamSystem(input_folder=...)), ATE and the 128^3 mesh held
               to 1.5x / 0.67x the worst JAX seed on the same files
               (scripts/port_jax_accuracy_bound.py --disk replica --recon);
               then eval_ate, cull_mesh and eval_recon -3d as subprocesses
               on its output: the in-process ATE and calc_3d_metric printed
               digit for digit, a non-empty culled ground-truth mesh
  5. room0     configs/Replica/room0.yaml as loaded (pretrained decoders,
               680x1200 frames, grid shapes, budgets, eval_rec meshing at
               256^3) on 12 frames of the analytic synthetic scene;
               tracking / mapping / meshing times, peak memory, ATE;
               final_mesh.ply and final_mesh_eval_rec.ply must be non-empty,
               every kernel must launch during this phase, and the fused
               MLP exactly as often as the mesher's chunk schedule says
  6. render    render_image of room0's last frame on the trained state,
               fused decoders against the plain ones (depth within 1e-3 m),
               with times and peak memory; then one render panel of that
               frame (utils/visualizer.py): render, drawing and encode
               seconds
     gather_real_index  the gather phase's checks and times at room0's
               middle and fine+color tables on the index of the room0
               run's last mapping iteration on each (few rows, long
               segments: the scatter's main-path case)
     disk_room0  room0 as in phase 5 from a Replica-format directory
               that the port's writer made from the analytic room0 scene:
               times beside phase 5's, the host's JPEG / PNG / whole-frame
               decode ms at 680x1200, the Prefetcher's wait, launches, and
               the ATE, finite and at most 5x phase 5's
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
               as shipped, its decoder products one bfloat16 pass each
               (model.decoder_matmul_precision, checked and printed; 40
               frames, the cut budgets in the YAML), writing its
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
               samples, hidden 256, the regulation on) on 6 frames of the
               analytic scene inside room0's scaled bound, iters_first cut
               to 300, no final color refine, one 256^3 mesh (no eval_rec
               mesh), then one 680x1200 render_image, at imap.yaml's
               bfloat16 decoder products: ms per tracked frame (median and
               range), ms per normal mapping call, mesh seconds, render ms,
               peak memory, and the ATE, gated only to be finite; the last
               frame's tracking and its normal mapping call (frame 5) run
               under torch.profiler: wall ms, device ms (the union of their
               kernels' intervals) and busy share
 10. parallel_parity  the parallel backends on ranks (parallel/): two
               ranks sharing the card (gloo) on a machine of one card, one
               rank a card (NCCL) on more, each this script started with
               --rank-task and brought up from the NSTPU_* variables; the
               kernels are built before, the ranks load them.  On
               synthetic.yaml's frames with random decoders and volumes:
               ray-sharded tracking and keyframe-sharded mapping against the
               single-rank steps on the same draws (the JAX package's
               sharded-against-single tolerances: tracking losses rtol 2e-4
               and poses 5e-5, mapping losses rtol 2e-4 and poses 1e-5),
               the blocked step (2 blocks) against the ray-sharded step of
               the same ray shares (losses rtol 1e-4, volumes rtol 1e-4 /
               atol 5e-6, tests/test_blocked.py's), and the sharded query of
               a 262,144-point 256^3-lattice chunk bit-equal to the
               unsharded one; every check's outputs bit-identical over the
               ranks and its kernels launched on every rank
 11. parallel_tum  configs/TUM_RGBD/freiburg1_desk_multichip.yaml (track:
               rays, map: rays) at full width (480x640, fr1/desk's
               distortion and crop, 5000 px x 200 tracking and 5000 px x 60
               mapping iterations every frame, window 10) from a TUM-format
               directory of the analytic scene, cut to 5 frames,
               iters_first 100, no color refine: a world of one here, then
               the ranks; per rank ms per tracked frame and mapping call,
               ms in collectives per iteration, launches, peak memory; the
               ranks' poses bit-identical, their ATE at most 5x the world
               of one's, the five kernels of rows 1-8 launched on every
               rank, the final mesh written by rank 0 through the sharded
               lattice query
 12. parallel_loose  the overlapped schedules on the ranks, in one rank
               process each: synthetic.yaml under sync_method: loose with
               parallel: {track: rays, map: rays}, its ATE and largest
               error within 1.5x the worst of the JAX seeds in the same
               setting, the ranks' poses and adoption records identical;
               the TUM config of parallel_tum under loose beside its strict
               ranks (poses identical, ATE within 5x the world of one's,
               the five kernels on every rank; per rank ms per tracked
               frame and mapping call, refreshes, the control group's
               all-reduces, collectives by group, peak memory); free, kept
               on distinct cards (a 10-frame run, poses identical) and
               falling back to loose with its warning on a shared card
 13. pipeline  with two or more cards: the overlap phase's loose room0 (the
               mapper on the second card) beside the same run in a process
               that sees one card; ATE within 5x of strict room0.  On one
               card it prints {"phase": "pipeline", "ran": false}
 14. services  synthetic.yaml again under strict with render panels
               (tracking.vis_freq 10, mapping.vis_freq 10, vis_inside_freq
               30) and the live dashboard (live_freq 5, a free HTTP port):
               its poses bit-identical to the accuracy phase's (panels and
               dashboard draw nothing and change no state), the panel files
               those the JAX package's rule names, each decoded by the
               port's JPEG decoder at the layout's size, status.json
               fetched over HTTP from a thread while the run goes and
               final at frame 39 of 40; then the replay tool
               (tools/visualizer.py, --stride 10) on the run's output: 4
               frames.  The seconds of one panel (render, drawing, encode)
               at 120x160 here and at 680x1200 in the render phase
 15. pretrain  tools/pretrain_decoders.py at its defaults (12 frames,
               120x160, iters_first 800, iters 60, seed 4) on the card, the
               blobs exported and reloaded bit-equal; then pretrained mode
               on the unseen box of tests/test_pretrained_mode.py (9
               frames, fix_fine, no train_middle, var_floor 1e-10) from
               seeds 0, 1 and 2: the worst largest, mean and last-frame
               translation errors held to 1.5x the worst of JAX seeds 0-2
               in the same setting (scripts/
               port_pretrained_transfer_seeds.py --train jax-defaults),
               that test's bars (0.06 / 0.03 / 0.055 m) printed beside
 16. entry     graft_entry.entry()'s forward step on the card against the
               same step on the CPU (the plain kernels) within 1e-5 x
               max(1, max|CPU|); then dryrun_multichip: one rank a card on
               NCCL with two or more cards, else two gloo ranks sharing the
               card
 17. bench     the port's measurement entry points, each as a user runs
               it (python -m, a process of its own): nice_slam_tpu_torch.
               bench, tools.bench_budget for replica, scannet, tum and
               apartment, tools.bench_imap 30 (30 mapping iterations a
               call) and tools.bench_sync_modes 5 strict loose free;
               their result lines printed, every number finite, the
               figures above 0, `device` this H100, expand, fold, gather
               and scatter launched (none on the iMAP* path), the free row
               run as free without the fallback warning
 18. measure   started before phase 14 and collected before phase 17,
               so it runs beside phases 14-16 (their gates are bits and
               files, not times; it keeps the script inside its time
               limit): the JAX system's last measurement scripts as the
               port's tools, four processes at once: bench_demo 60 (the Demo
               budget at 480x640 under loose to frame 59: the first map,
               rounds every 5 frames, a 256^3 mesh at frame 50, the final
               mesh and the checkpoint), bench_imap_e2e 6 and
               bench_precision 10 --orbit-frames 4 (the iMAP* mapping call
               and the NICE orbit at float32, three and one bfloat16
               passes) as a user runs them, and bench_fused_eval (256^3),
               profile_steps,
               profile_components, ablate_track_step, ablate_map_step (one
               repetition each) and diagnose_strict 6 (3 frames under
               cProfile) as calls of their main() in one process; every
               number finite, `device` this H100, the row kernels of each
               path launched (none on the iMAP* path), the fused and plain
               lattice occupancies within the kernel's precision bound, the
               ablations' full case the production call's bits
Then the kernel table line {"kernels": [...]} (one entry per TPU kernel of
the repository; launches from phase 5, the probes' from the roofline
phase; the scatter's times from the real-index case), the card line, and last {"ok": true, "device": {...}}.  Any
failure exits non-zero without the last line.  Without CUDA it exits 2 at
once.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import math
import os
import re
import signal
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

# 1.5x the worst of seeds 0-2 of the JAX package on synthetic.yaml under
# sync_method: loose with parallel: {track: rays, map: rays} on two forced
# host devices (JAX_PLATFORMS=cpu python scripts/port_jax_accuracy_bound.py
# --sync loose --parallel 2 --seeds S): worst ATE RMSE 0.019603 m and
# per-frame error 0.074079 m (both seed 1)
PAR_LOOSE_BOUND_ATE_RMSE_M = 1.5 * 0.019603011804768266
PAR_LOOSE_BOUND_MAX_ERR_M = 1.5 * 0.07407891005277634

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

# 1.5x (ATE RMSE, largest per-frame error, mesh accuracy and completion)
# and 0.67x (completion ratio) the worst of seeds 0-2 of the JAX package on
# synthetic.yaml's 40 frames read back from Replica-format files that the
# port's writer made (JAX_PLATFORMS=cpu python
# scripts/port_jax_accuracy_bound.py --disk replica --recon --seeds S, one
# process a seed; cv2 decodes the files there): worst ATE RMSE 0.036042 m
# and per-frame error 0.096482 m (seed 0), worst accuracy 8.148973 cm
# (seed 1), completion 48.357763 cm and ratio 19.438 % (seed 0)
DISK_BOUND_ATE_RMSE_M = 1.5 * 0.036042170526335265
DISK_BOUND_MAX_ERR_M = 1.5 * 0.096481554210186
DISK_BOUND_ACCURACY_CM = 1.5 * 8.148973189357847
DISK_BOUND_COMPLETION_CM = 1.5 * 48.35776259491734
DISK_BOUND_COMPLETION_RATIO_PCT = 0.67 * 19.438

# the formats phase: every dataset format at the fixture tests' size, held
# to tests/test_dataset_fixtures.py's bars (_check_images): mean |color -
# source| < 0.08 / 4 through JPEG, < 0.01 / 4 through PNG; depth within 2
# quantization steps + 1e-4; poses within 1e-6
# synthetic.yaml under the session-wide `matmul_precision`
# (scripts/port_precision_phases.py's session_accuracy, 40 frames and the
# 128^3 mesh): 1.5x / 0.67x the worst of JAX seeds 0-2 run under the TPU's
# rule on the CPU (JAX_PLATFORMS=cpu python
# scripts/port_jax_accuracy_bound.py --recon --session-precision NAME
# --seeds S, tests/tpu_matmul_rule.py; every seed finite): name -> (ATE
# RMSE m, largest frame error m, accuracy cm, completion cm, completion
# ratio %), the worst seed's values
SESSION_WORST = {
    'bfloat16': (0.027259059149963755, 0.08827779442071915,
                 7.561001539396813, 49.997463300807794, 20.039),
    'tensorfloat32': (0.02497083325387917, 0.09884578734636307,
                      8.109952012436219, 48.687013847093205,
                      18.313499999999998),
}
# chip_smoke.py's session_precision phase: synthetic.yaml cut to this many
# frames, its first map to this many iterations and no final color refine
# (the script's time), under each session precision, with its final 128^3
# mesh
SESSION_FRAMES = 3
SESSION_ITERS_FIRST = 100

FORMAT_KINDS = ('replica', 'scannet', 'tumrgbd', 'cofusion', 'azure')
FORMAT_N, FORMAT_H, FORMAT_W = 6, 60, 80
FORMAT_SCANNET_NAN_FRAME = 3

# room0 under loose, held to this multiple of the same run's strict room0
# ATE RMSE and largest per-frame error: the JAX package has no room0 loose
# run to bound it, and the tracker's map may be every_frame + every_frame
# // 2 = 7 frames old under loose against every_frame - 1 = 4 under strict.
# It catches a diverged or broken overlap, not a small loss of accuracy.
LOOSE_ROOM0_FACTOR = 5.0

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12        # H100 SXM FP32 without tensor cores (same)
TF32_FLOP_PER_S = 495e12       # H100 SXM dense TF32 tensor cores (same)
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor cores (same)

# the decoder stack's bfloat16 products (models/precision.py) at room0_imap's
# shapes: a hidden layer [N, 256] @ [256, 256] and the Fourier embedding
# [N, 3] @ [3, 93], at 65,536 points; M x K x N
PRECISION_SHAPES = {'hidden': (65536, 256, 256), 'embedding': (65536, 3, 93)}

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
# the bf16 modes against their plain version at the same precision (a
# float32 sum on the other side of a bf16 rounding boundary moves the next
# product's input by one bf16 ulp; tests/test_torch_fused_mlp.py's
# bf16_held, measured on its CPU emulation): at every N the largest
# difference at most BF16_MAX x max(1, max|plain|); at N >= 4,097 also the
# median at most 1e-5 and at most 2% beyond 1e-4 of max|plain|
BF16_MODES = {'bfloat16': 1, 'tensorfloat32': 3}
BF16_MAX = 2e-2
# at the three decoders' 262,144-point chunks also the kernel's precision
# bound, ops/fused_mlp.PRECISION_TOL x max(1, max|plain|)
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

# the services phase's panels and dashboard over synthetic.yaml
SERVICES_VIS = {'tracking': {'vis_freq': 10},
                'mapping': {'vis_freq': 10, 'vis_inside_freq': 30},
                'visualization': {'live': True, 'live_freq': 5,
                                  'live_port': 0}}
# pretrained mode on an unseen room (tests/test_pretrained_mode.py's box
# and settings) from decoders the pretraining tool trained at its
# defaults: the largest, mean and last-frame translation error, each held
# to 1.5x the worst of seeds 0-2 of the JAX package in the same setting
# (JAX_PLATFORMS=cpu python scripts/port_pretrained_transfer_seeds.py
# --blobs DIR --train jax-defaults --package jax --seeds 0 1 2: worst
# 0.063245 / 0.024358 / 0.059737 m, seed 0), the rule of the other
# trajectory gates.  That test's own bars (0.06 / 0.03 / 0.055 m) are
# printed beside: one run is a draw from a wide spread in both packages,
# and the JAX package misses them on seed 0 of this setting and on 2 of
# seeds 0-6 of its test (PERF.md section 6, PR 9)
PRETRAIN_TEST_BOX = [[-1.2, 0.9], [-0.7, 0.9], [-0.9, 1.1]]
PRETRAIN_BOUND_M = (1.5 * 0.0632445365190506, 1.5 * 0.024357542395591736,
                    1.5 * 0.05973748490214348)
PRETRAIN_TEST_BARS_M = (0.06, 0.03, 0.055)
PRETRAIN_SEEDS = (0, 1, 2)
ENTRY_TOL = 1e-5               # x max(1, max|CPU|)

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
    from nice_slam_tpu_torch.io import codecs
    from nice_slam_tpu_torch.mesh import native
    from nice_slam_tpu_torch.ops import expand, fused_mlp, gather, roofline
    modules = (expand, fused_mlp, gather, roofline, native, codecs)

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
                precision = fm.PRECISION_TOL * max(
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
          'precision_bound': f'{fm.PRECISION_TOL} x max(1, max|plain|) '
                             'at the chunks',
          'ragged_n': RAGGED_N, 'main_shapes': times,
          'kernel_config': configs, 'ptxas': ptxas,
          'library_ms': None,
          'library_note': 'no single PyTorch call computes the decoder MLP'})
    return {'err': err, 'times': times}


def mlp_bounds_bf16(n: int, c_dim: int, color: bool, macs: int,
                    packed_floats: int, n_passes: int) -> dict:
    """The least time of one call of a bf16 mode at n points: the dense,
    fc_c and head products at `n_passes` bf16 passes on the tensor cores
    and the embedding argument's `n_passes` // 3 + 1 fmaf chains on the
    FP32 cores, against the bytes (p, c, out, packed weights once each)."""
    out_w = 4 if color else 1
    nbytes = 4 * (n * (3 + c_dim + out_w) + packed_floats)
    chains = 1 if n_passes == 1 else 3
    ops_ms = (n_passes * 2 * (macs - EMBED_MACS) * n / BF16_FLOP_PER_S
              + chains * 2 * EMBED_MACS * n / FP32_FLOP_PER_S) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {'bytes': nbytes, 'bf16_tensor_core_bound_ms': ops_ms,
            'bytes_bound_ms': bytes_ms, 'bound_ms': max(ops_ms, bytes_ms),
            'bound_by': 'operations' if ops_ms >= bytes_ms else 'bytes'}


def bf16_share(got, want) -> dict:
    """The bf16 modes' differences from their plain version, relative to
    the largest plain output (BF16_MAX's note)."""
    d = (got.double() - want.double()).abs()
    top = float(want.abs().max())
    return {'max_abs_err': float(d.max()),
            'max_rel': float(d.max()) / max(1.0, top),
            'median_rel': float(d.median()) / top,
            'beyond_1e-4': float((d > 1e-4 * top).double().mean())}


def phase_fused_mlp_bf16() -> dict:
    """The fused MLP's bf16 modes (one and three passes) against the
    plain version at the same precision (`fused_mlp_plain(precision=)`,
    whose products are cuBLAS bf16 calls) at ragged N, the tile edges and
    one lattice chunk of each decoder, on points over room0's bound; times
    and the bf16 bound at the chunk."""
    import torch
    from nice_slam_tpu_torch.models.decoders import (
        DecoderConfig, init_nice_decoders)
    from nice_slam_tpu_torch.ops import fused_mlp as fm
    decs = init_nice_decoders(DecoderConfig(),
                              generator=torch.Generator().manual_seed(3),
                              device='cpu').to('cuda')
    mlps = {**{k: decs[k] for k in MLPS}, 'fine4': fine4_mlp()}
    res = {}
    for prec, n_passes in BF16_MODES.items():
        gen = torch.Generator(device='cuda').manual_seed(5)
        err, times, configs, worst = 0.0, {}, {}, {}
        for name, mlp in mlps.items():
            c_dim, color = mlp.fc_c[0].in_features, mlp.color
            params = [w.detach() for w in fm.mlp_params(mlp)]
            configs[name] = fm.kernel_config(c_dim, 4 if color else 1,
                                             n_passes)
            for n in RAGGED_N + [POINTS_BATCH]:
                p, c = mlp_inputs(n, c_dim, gen)
                got = fm.fused_mlp_forward(p, c, params, color=color,
                                           precision=prec)
                want = fm.fused_mlp_plain(p, c, params, color=color,
                                          precision=prec)
                share = bf16_share(got, want)
                ok = got.shape == want.shape and share['max_rel'] <= BF16_MAX
                if n >= 4097:
                    ok = ok and (share['median_rel'] <= 1e-5
                                 and share['beyond_1e-4'] <= 0.02)
                if not ok:
                    raise AssertionError(f'fused_mlp {prec} off its plain '
                                         f'version for {name} at N={n}: '
                                         f'{share}')
                err = max(err, share['max_abs_err'])
                if n >= 4097:
                    worst[name] = {k: max(worst.get(name, {}).get(k, 0.0), v)
                                   for k, v in share.items()}
                if n == POINTS_BATCH and name in MLPS:
                    times[name] = {
                        'n': n, 'c_dim': c_dim, 'out': 4 if color else 1,
                        'macs_per_point': MLPS[name][2],
                        'ms': cuda_ms(lambda: fm.fused_mlp_forward(
                            p, c, params, color=color, precision=prec)),
                        'plain_ms': cuda_ms(lambda: fm.fused_mlp_plain(
                            p, c, params, color=color, precision=prec)),
                        **share,
                        **mlp_bounds_bf16(n, c_dim, color, MLPS[name][2],
                                          configs[name]['pack_floats'],
                                          n_passes)}
                    row = times[name]
                    row['share_of_bound'] = row['bound_ms'] / row['ms']
        res[prec] = {'mode': fm.MODES[n_passes], 'passes': n_passes,
                     'max_abs_err': err, 'main_shapes': times,
                     'worst_share_at_4097_up': worst,
                     'kernel_config': configs}
    emit({'phase': 'kernels_fused_mlp_bf16',
          'tolerance': f'max <= {BF16_MAX} x max(1, max|plain|); at N >= '
                       '4097 median <= 1e-5 and <= 2% beyond 1e-4 of '
                       'max|plain|',
          'ragged_n': RAGGED_N, **res})
    return res


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
        outs = {}
        for tree, fn in runs.items():
            outs[tree] = fn(p, c, params, color=color)
            e = float((outs[tree] - want).abs().max())
            if not e <= tol:
                raise AssertionError(f'{tree} fused_mlp off by {e} for '
                                     f'{name}')
        # the float32 names' mode is the parent's 3xTF32 kernel, bit for bit
        if not torch.equal(outs['old'], outs['new']):
            raise AssertionError(f'the 3xTF32 mode differs from the '
                                 f"parent's kernel for {name}")
        order = ['old', 'new', 'new', 'old']
        ms = [cuda_ms(lambda: runs[tree](p, c, params, color=color))
              for tree in order]
        rows[name] = {'order': order, 'ms': ms, 'bit_equal': True,
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


def _plain_products(a: tuple, b: tuple):
    """The plain version of models/precision.products: the same passes of
    split bf16 operands, each as a float32 product of their values."""
    from nice_slam_tpu_torch.models.precision import pass_plain
    pairs = [(0, 0)] if len(a) == 1 else [(0, 1), (1, 0), (0, 0)]
    return sum(pass_plain(a[i], b[j]) for i, j in pairs)


def phase_precision() -> dict:
    """The decoder stack's bfloat16 products on the card (`aten::mm.dtype`,
    cuBLAS bf16 with a float32 output) against their plain version: one and
    three passes through `precision.linear` (bias added in float32), forward
    and both gradients through the autograd Function, at PRECISION_SHAPES
    and at 4,097 rows (a weight gradient over a count that cuBLAS summed
    wrong unless padded to a multiple of 8, precision.py's note).  Each
    side sums
    K exact products and the bias in float32 in its own order, so each is
    within (K + 2) 2^-24 (|A|.|B| + |bias|) of the exact sum and they agree
    within twice that, per element (|A|.|B| the product of the operands'
    magnitudes, summed over the passes); and since that worst case grows
    with K, the error's rms over all elements is also held to 16 sqrt(K)
    2^-24 of the plain version's (float32 sums in two orders differ by
    ~sqrt(K) 2^-24; one product of 4,097 left out, by ~1.5%).  Times at
    PRECISION_SHAPES: the one-pass product alone and with its rounding,
    three passes, float32 torch.mm (TF32 off) and the plain version, beside
    the bf16 tensor-core, FP32-core and bytes bounds; the device operations
    of one one-pass product."""
    import torch
    from nice_slam_tpu_torch.models import precision as P
    if not torch._C._dispatch_has_kernel_for_dispatch_key('aten::mm.dtype',
                                                          'CUDA'):
        raise AssertionError('this torch has no CUDA aten::mm.dtype')
    gen = torch.Generator(device='cuda').manual_seed(0)
    res = {}
    for shape_name, (m, k, n) in (*PRECISION_SHAPES.items(),
                                  ('odd_rows', (4097, 256, 256))):
        x = torch.randn((m, k), generator=gen, device='cuda')
        w = torch.randn((k, n), generator=gen, device='cuda') / k ** 0.5
        g = torch.randn((m, n), generator=gen, device='cuda')
        bias = torch.randn((n,), generator=gen, device='cuda')
        row = {'shape': [m, k, n]}
        for prec in ('bfloat16', 'BF16_BF16_F32_X3'):
            n_passes = P.passes(prec)
            xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
            out = P.linear(xl, wl.t(), bias, prec)
            out.backward(g)
            xs, ws, gs = (P.split(t, n_passes) for t in (x, w, g))
            t = lambda ts: tuple(u.t() for u in ts)
            cases = {'forward': (out.detach(), xs, ws, k, bias),
                     'd_x': (xl.grad, gs, t(ws), n, 0.0),
                     'd_w': (wl.grad, t(xs), gs, m, 0.0)}
            errs = {}
            for case, (got, a, b, depth, add) in cases.items():
                want = _plain_products(a, b) + add
                diff = (got - want).abs()
                mag = _plain_products(tuple(u.abs() for u in a),
                                      tuple(u.abs() for u in b)) + abs(add)
                excess = float((diff - 2 * (depth + 2) * 2.0 ** -24
                                * mag).max())
                rms = float(diff.pow(2).mean().sqrt()
                            / want.pow(2).mean().sqrt())
                errs[case] = {'max_abs_err': float(diff.max()),
                              'max_rel_to_bound': float(
                                  (diff / (2 * (depth + 2) * 2.0 ** -24
                                           * mag).clamp_min(1e-30)).max()),
                              'rms_rel_err': rms}
                if excess > 0 or rms > 16 * depth ** 0.5 * 2.0 ** -24:
                    raise AssertionError(
                        f'{prec} {case} at {shape_name} off its plain '
                        f'version: {excess} past the bound, rms {rms}')
            row[prec] = errs
            del xl, wl, out
        if shape_name not in PRECISION_SHAPES:
            res[shape_name] = row
            continue
        xb, wb = x.bfloat16(), w.bfloat16()
        flop = 2.0 * m * k * n
        row.update(
            one_pass_ms=cuda_ms(lambda: P.one_pass(xb, wb)),
            one_pass_with_rounding_ms=cuda_ms(
                lambda: P.mm(x, w, 'bfloat16')),
            three_pass_ms=cuda_ms(lambda: P.mm(x, w, 'BF16_BF16_F32_X3')),
            float32_mm_ms=cuda_ms(lambda: x @ w),
            plain_ms=cuda_ms(lambda: P.pass_plain(xb, wb)),
            bf16_bound_ms=max(flop / BF16_FLOP_PER_S,
                              (2 * (m * k + k * n) + 4 * m * n)
                              / HBM_BYTES_PER_S) * 1e3,
            fp32_bound_ms=max(flop / FP32_FLOP_PER_S,
                              4 * (m * k + k * n + m * n)
                              / HBM_BYTES_PER_S) * 1e3,
            one_pass_device_ops=[short_name(op) for op, _ in device_ops(
                lambda: P.one_pass(xb, wb))])
        res[shape_name] = row
        del x, w, g, bias, xb, wb
    emit({'phase': 'precision',
          'tolerance': '2 (K + 2) 2^-24 x (|A|.|B| + |bias|) per element; '
                       'rms 16 sqrt(K) 2^-24 of the plain version',
          **res})
    return res


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
    # row 10's probes at the study's shape as device time alone (CUDA
    # graphs of 20 calls: the host's launch path out), beside their
    # one-call libraries timed the same way
    shape, c, small, _ = inputs['study_variants']
    m = shape[0] * shape[1] * shape[2]
    rows_same_x = corner_rows(shape, 'cuda', same_x=True)
    device_alone = {
        'widen8': (lambda: rf.probe('widen8', small, shape),
                   lambda: small.repeat(1, 8)),
        'shifts': (lambda: rf.probe('shifts', small, shape), None),
        'expand_same_x': (lambda: rf.probe('expand_same_x', small, shape),
                          lambda: small.index_select(0, rows_same_x).reshape(
                              m, 8 * c))}
    for mode, (probe_fn, lib_fn) in device_alone.items():
        r = next(r for r in rows if r['probe'] == mode
                 and r['shape_name'] == 'study_variants')
        r['graph_ms'] = graph_ms(probe_fn)
        r['library_graph_ms'] = graph_ms(lib_fn) if lib_fn else None
        r['graph_share_of_bound'] = r['bound_ms'] / r['graph_ms']
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

def run_slam(cfg: dict, output: str, mesh: bool = True, nice: bool = True,
             input_folder: str | None = None, on_start=None, seed: int = 0):
    """One SlamSystem run on the card with every kernel's count set to 0
    just before and read just after; every kernel of the NICE path must
    have launched (the fused MLP only runs in meshes), and none in iMAP*
    mode (nice=False), whose path has no kernel of rows 1-11.
    on_start(system) is called between construction and the run; `seed`
    is the system's.  Returns (result, the system)."""
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
    slam = SlamSystem(cfg, nice=nice, device='cuda', seed=seed,
                      output=output, input_folder=input_folder)
    if not mesh:
        slam.mesher = None
    if on_start is not None:
        on_start(slam)
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
        'frame_err_m': [round(float(e), 6) for e in err],
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
        'frame_read_s': slam.timers.read_s,
        'prefetch_wait_s': slam.timers.prefetch_wait_s,
        'sync_method': slam.sync_method, 'refreshes': dict(slam.refreshes),
        'launches': launches,
    }
    # the path's kernels: the row kernels, and in meshes the fused MLP's
    # mode for the decoders' precision
    want = [*ex.LAUNCHES, *ga.LAUNCHES]
    if mesh:
        want.append(fm.MODES[fm.mode_of(slam.dcfg.mm_precision)])
    if nice and not all(launches[k] > 0 for k in want):
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


def phase_accuracy():
    """The synthetic run; returns its poses (the services phase's
    reference)."""
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
    return slam.estimate_c2w.copy()


def session_cfg(precision: str, short: bool = False) -> dict:
    """synthetic.yaml under the session-wide `matmul_precision`
    `precision` (no decoder key: the decoders take it too); `short`: cut
    to SESSION_FRAMES frames, a first map of SESSION_ITERS_FIRST
    iterations and no color refine."""
    from nice_slam_tpu_torch.utils.config import load_config
    cfg = load_config('configs/Synthetic/synthetic.yaml',
                      'configs/nice_slam.yaml')
    cfg['verbose'] = False
    cfg['matmul_precision'] = precision
    if short:
        cfg['synthetic']['n_frames'] = SESSION_FRAMES
        cfg['mapping'].update(iters_first=SESSION_ITERS_FIRST,
                              color_refine=False)
    return cfg


def _session_run(precision: str, short: bool, out: str):
    """One run of session_cfg; checks that the session and decoder
    precision are the config's and that the meshes went through the
    kernel's mode for it."""
    from nice_slam_tpu_torch.ops import fused_mlp as fm
    cfg = session_cfg(precision, short)
    res, slam = run_slam(cfg, out)
    used = (slam.model.matmul_precision, slam.dcfg.mm_precision)
    if used != (precision, precision):
        raise AssertionError(f'the run took (session, decoders) {used}')
    mode = fm.MODES[fm.mode_of(precision)]
    others = [k for k in fm.LAUNCHES if k != mode]
    if not (res['launches'][mode] > 0
            and all(res['launches'][k] == 0 for k in others)):
        raise AssertionError(f'{precision}: the meshes did not take the '
                             f'{mode} mode alone: {res["launches"]}')
    res['mesh_vertices'] = mesh_vertices(os.path.join(out, 'mesh',
                                                      'final_mesh.ply'))
    res.update(matmul_precision=precision, mode=mode)
    return res, slam, cfg


def phase_session_precision() -> dict:
    """synthetic.yaml cut short (session_cfg) under `matmul_precision`
    bfloat16, then tensorfloat32 (three bf16 passes, not TF32), each with
    its final 128^3 mesh through the fused kernel's bf16 mode: the poses
    finite, and the mode's launches > 0 (the other modes' 0).  Returns
    each run's result, its launches among them."""
    out_rows = {}
    for prec in BF16_MODES:
        with tempfile.TemporaryDirectory() as out:
            res, _, _ = _session_run(prec, True, out)
        res['phase'] = 'session_precision'
        emit(res)
        out_rows[prec] = res
    return out_rows


def phase_session_accuracy(precision: str) -> None:
    """synthetic.yaml as shipped (40 frames, 128^3 final mesh) under
    `matmul_precision` `precision`, held to 1.5x / 0.67x the worst JAX seed
    under the TPU's rule (SESSION_WORST); scripts/port_precision_phases.py
    runs it."""
    from nice_slam_tpu_torch.eval.recon import calc_3d_metric
    from nice_slam_tpu_torch.io.datasets import synthetic_gt_mesh
    from nice_slam_tpu_torch.mesh.mesher import load_ply
    worst = SESSION_WORST[precision]
    bound = (1.5 * worst[0], 1.5 * worst[1], 1.5 * worst[2],
             1.5 * worst[3], 0.67 * worst[4])
    with tempfile.TemporaryDirectory() as out:
        res, slam, cfg = _session_run(precision, False, out)
        rec_v, rec_t = load_ply(os.path.join(out, 'mesh', 'final_mesh.ply'))
        gt_v, gt_t = synthetic_gt_mesh(cfg['synthetic']['box'])
        res['recon'] = calc_3d_metric(rec_v, rec_t, gt_v, gt_t, align=False)
    rec = res['recon']
    res.update(phase='session_accuracy',
               config='configs/Synthetic/synthetic.yaml',
               bound_ate_rmse_m=bound[0], bound_max_frame_err_m=bound[1],
               bound_accuracy_cm=bound[2], bound_completion_cm=bound[3],
               bound_completion_ratio_pct=bound[4])
    emit(res)
    if not (res['ate_rmse_m'] <= bound[0]
            and res['max_frame_err_m'] <= bound[1]
            and rec['accuracy_cm'] <= bound[2]
            and rec['completion_cm'] <= bound[3]
            and rec['completion_ratio_%'] >= bound[4]):
        raise AssertionError(f'synthetic under matmul_precision '
                             f'{precision} outside the JAX bound')


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
    emit({'phase': 'render_panel', 'frame': idx,
          **panel_seconds(slam, idx)})


def panel_seconds(slam, idx: int) -> dict:
    """One render panel of frame idx from the system's map (the tracking
    panels' Visualizer): its size and the seconds of its render (device
    work and the copy to the host), drawing and encode."""
    from nice_slam_tpu_torch.io.codecs import read_color
    from nice_slam_tpu_torch.utils.visualizer import Visualizer, panel_size
    _, color_np, depth_np, _ = slam.frame_reader[idx]
    with tempfile.TemporaryDirectory() as vis_dir:
        vis = Visualizer(vis_dir, 1, model=slam.model, rcfg=slam.rcfg,
                         intr=slam.intr)
        path = vis.vis(idx, 0, depth_np, color_np, slam.estimate_c2w[idx],
                       slam.decoders, slam.grids)
        shape = list(read_color(path).shape[:2])
    if shape != list(panel_size(slam.intr.H, slam.intr.W)):
        raise AssertionError(f'panel of {shape}')
    return {'size': shape, 'panel_s': vis.timings}


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
        room0, slam = run_slam(cfg, out, mesh=False)
        room0['map_device'] = str(slam.map_device)
        del slam
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


def _check_precision(slam, precision: str | None) -> str:
    """The decoder precision the run used: `precision` when one was
    given, else imap.yaml's bfloat16 as shipped."""
    used = slam.dcfg.mm_precision
    if used != (precision or 'bfloat16'):
        raise AssertionError(f'the iMAP* run used decoder precision '
                             f'{used!r}')
    return used


def phase_imap_accuracy(precision: str | None = None) -> None:
    """iMAP* on synthetic_imap.yaml, held to the JAX package's seeds; at
    imap.yaml's bfloat16 decoder products, or at `precision`."""
    from nice_slam_tpu_torch.eval.recon import calc_3d_metric
    from nice_slam_tpu_torch.io.datasets import synthetic_gt_mesh
    from nice_slam_tpu_torch.mesh.mesher import load_ply
    from nice_slam_tpu_torch.utils.config import load_config
    cfg = load_config('configs/Synthetic/synthetic_imap.yaml',
                      'configs/imap.yaml')
    cfg['verbose'] = False
    if precision is not None:
        cfg['model']['decoder_matmul_precision'] = precision
    with tempfile.TemporaryDirectory() as out:
        res, slam = run_slam(cfg, out, nice=False)
        res['decoder_matmul_precision'] = _check_precision(slam, precision)
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
    scale 0.1; depth cut to 6 frames (the first map and a normal mapping
    call at frame 5), iters_first to 300, the last frame's color refine
    (5 x 300 iterations on a window of 10) and the eval_rec mesh left
    out."""
    from nice_slam_tpu_torch.utils.config import load_config
    cfg = load_config('configs/Replica/room0_imap.yaml', 'configs/imap.yaml')
    box = [[-2.8, 8.8], [-3.1, 5.4], [-3.4, 3.2]]
    for (lo, hi), (blo, bhi) in zip(box, cfg['mapping']['bound']):
        if not blo < lo < hi < bhi:
            raise AssertionError('the scene box is not inside room0\'s '
                                 'bound')
    cfg['dataset'] = 'synthetic'
    cfg['synthetic'] = {'n_frames': 6, 'radius': 0.8, 'step': 0.02,
                        'noise': 0.003, 'box': box}
    cfg['mapping']['iters_first'] = 300
    cfg['mapping']['color_refine'] = False
    cfg['meshing']['eval_rec'] = False
    cfg['verbose'] = False
    return cfg


def phase_imap_room0(precision: str | None = None) -> None:
    """iMAP* at room0_imap's full width: times, one mesh, one render; at
    imap.yaml's bfloat16 decoder products, or at `precision`.  The last
    frame's tracking and its normal mapping call run under torch.profiler,
    for their device ms (the union of their kernels' intervals); their
    times in the run's lists hold the profiler's cost."""
    import numpy as np
    import torch
    from nice_slam_tpu_torch.render.renderer import render_image
    from nice_slam_tpu_torch.utils.measure import profiled
    cfg = imap_room0_cfg()
    if precision is not None:
        cfg['model']['decoder_matmul_precision'] = precision
    dev = torch.device('cuda')
    last = cfg['synthetic']['n_frames'] - 1
    under_profiler = {}

    def profile_last_frame(slam):
        for name in ('track', 'map_frame'):
            def call(idx, *args, _run=getattr(slam, name), _name=name, **kw):
                if idx != last:
                    return _run(idx, *args, **kw)
                out = []
                under_profiler[_name] = profiled(
                    lambda: out.append(_run(idx, *args, **kw)), dev)[0]
                return out[0]
            setattr(slam, name, call)

    with tempfile.TemporaryDirectory() as out:
        res, slam = run_slam(cfg, out, nice=False,
                             on_start=profile_last_frame)
        res['decoder_matmul_precision'] = _check_precision(slam, precision)
        tracked = [s * 1e3 for idx, s in slam.timers.track if idx > 0]
        normal = [r['ms'] for r in res['map_calls_ms']
                  if r['kind'] == 'normal']
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
    if (set(under_profiler) != {'track', 'map_frame'}
            or slam.timers.maps[-1][:2] != (last, 'normal')):
        raise AssertionError(f'the profiled calls were not frame {last}\'s '
                             f'tracking and normal mapping call')
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
        profiled_frame=last,
        track_frame_profiled=under_profiler['track'],
        map_normal_profiled=under_profiler['map_frame'],
        mesh_resolution=slam.mesher.cfg.resolution,
        render_ms=render_ms, render_peak_mem_bytes=render_peak)
    emit(res)
    if not (np.isfinite(res['ate_rmse_m']) and finite_render):
        raise AssertionError('iMAP* room0 gave non-finite results')
    if not normal or res['mesh_resolution'] != 256:
        raise AssertionError('iMAP* room0 made no normal mapping call or '
                             'did not mesh at 256^3')


def _hold_frames(name, ds, expected, scale, lossy, pose_tol=1e-6) -> dict:
    """Every frame of `ds` against expected(i) -> (color, depth, pose or
    None) at the fixture bars (poses within `pose_tol`); returns the errors
    and the ms per frame the loader took (decode included)."""
    import numpy as np
    t0 = time.perf_counter()
    items = [ds[i] for i in range(len(ds))]
    read_ms = (time.perf_counter() - t0) / len(ds) * 1e3
    worst = {'color_mean_abs': 0.0, 'depth_max_abs': 0.0, 'pose_max_abs': 0.0}
    for i, (idx, color, depth, pose) in enumerate(items):
        color_x, depth_x, pose_x = expected(i)
        if idx != i or color.shape != color_x.shape \
                or depth.shape != depth_x.shape:
            raise AssertionError(f'{name} frame {i}: index {idx}, shapes '
                                 f'{color.shape} {depth.shape}')
        worst['color_mean_abs'] = max(worst['color_mean_abs'], float(
            np.mean(np.abs(color - color_x))))
        worst['depth_max_abs'] = max(worst['depth_max_abs'], float(
            np.max(np.abs(depth - depth_x))))
        if pose_x is not None:
            worst['pose_max_abs'] = max(worst['pose_max_abs'], float(
                np.max(np.abs(pose - pose_x))))
    bars = {'color_mean_abs': (0.08 if lossy else 0.01) / 4,
            'depth_max_abs': 2.0 / scale + 1e-4, 'pose_max_abs': pose_tol}
    for key, bar in bars.items():
        if not worst[key] < bar:
            raise AssertionError(f'{name}: {key} {worst[key]} >= {bar}')
    return {'frames': len(items), 'read_ms_per_frame': read_ms, **worst}


def phase_formats() -> None:
    """Each dataset format written by the port's fixture tool and read back
    by its loader; a TUM variant with freiburg1_desk's distortion, a
    crop_size and a crop_edge, and a ScanNet variant whose color is twice
    the depth's size."""
    import numpy as np
    import yaml
    from nice_slam_tpu_torch.io.datasets import (
        _intrinsics_matrix, _resize_bilinear_align_corners, _resize_nearest,
        get_dataset, undistort)
    from nice_slam_tpu_torch.tools import make_fixture_dataset as fx
    n, h, w = FORMAT_N, FORMAT_H, FORMAT_W
    f, cx, cy = 0.5 * w, 0.5 * w - 0.5, 0.5 * h - 0.5
    frames = fx.make_frames(n, h, w, f, f, cx, cy)
    flip = np.diag([1.0, -1.0, -1.0, 1.0])

    def cfg_of(kind, folder, **cam):
        return {'dataset': kind, 'scale': 1.0,
                'cam': {'H': h, 'W': w, 'fx': f, 'fy': f, 'cx': cx,
                        'cy': cy, 'png_depth_scale': fx.DEPTH_SCALE[kind],
                        'crop_edge': 0, **cam},
                'data': {'input_folder': folder}}

    def tum_pose(i):
        """The source trajectory rebased on its first (CV-convention)
        pose, as the TUM loader gives it."""
        cv = [p @ flip for _, _, p in frames]
        return np.linalg.inv(cv[0]) @ cv[i] @ flip

    res = {'phase': 'formats', 'size': [h, w], 'frames': n, 'formats': {}}
    with tempfile.TemporaryDirectory() as root:
        for kind in FORMAT_KINDS:
            folder = os.path.join(root, kind)
            fx.write_dataset(kind, folder, frames, h, w, f, f, cx, cy,
                             scannet_nan_frame=(FORMAT_SCANNET_NAN_FRAME
                                                if kind == 'scannet'
                                                else None))
            ds = get_dataset(cfg_of(kind, folder))
            if len(ds) != n:
                raise AssertionError(f'{kind}: {len(ds)} frames, not {n}')

            def expected(i, kind=kind):
                color, depth, pose = frames[i]
                if kind == 'cofusion':
                    pose = np.eye(4)
                elif kind == 'tumrgbd':
                    pose = tum_pose(i)
                elif kind == 'scannet' and i == FORMAT_SCANNET_NAN_FRAME:
                    pose = None
                return color, depth, pose

            # TUM's groundtruth.txt holds 6 decimals (1e-4, as
            # tests/test_dataset_fixtures.py holds its rebased trajectory)
            row = _hold_frames(kind, ds, expected, fx.DEPTH_SCALE[kind],
                               lossy=kind != 'cofusion',
                               pose_tol=1e-4 if kind == 'tumrgbd' else 1e-6)
            if kind == 'scannet':
                nan_pose = ds[FORMAT_SCANNET_NAN_FRAME][3]
                if np.isfinite(nan_pose).any():
                    raise AssertionError('ScanNet invalid frame not kept')
                row['invalid_frame'] = FORMAT_SCANNET_NAN_FRAME
            if kind == 'tumrgbd':
                row['associated'] = len(ds)
            res['formats'][kind] = row

        # TUM with freiburg1_desk's distortion, its crop_size and crop_edge
        # scaled from 640x480 to the fixture's 80x60
        with open('configs/TUM_RGBD/freiburg1_desk.yaml') as fh:
            desk = yaml.safe_load(fh)['cam']
        ratio = w / desk['W']
        crop = [int(round(desk['crop_size'][0] * ratio)),
                int(round(desk['crop_size'][1] * ratio))]
        edge = max(1, int(round(desk['crop_edge'] * ratio)))
        ds = get_dataset(cfg_of('tumrgbd', os.path.join(root, 'tumrgbd'),
                                distortion=desk['distortion'],
                                crop_size=crop, crop_edge=edge))
        k = _intrinsics_matrix(f, f, cx, cy)

        def distorted(i):
            color, depth, _ = frames[i]
            u8 = (color * 255).astype(np.uint8)
            c = undistort(u8, k, np.array(desk['distortion'])).astype(
                np.float32) / 255.0
            c = _resize_bilinear_align_corners(c, *crop)[edge:-edge,
                                                         edge:-edge]
            d = _resize_nearest(depth.astype(np.float32), *crop)[
                edge:-edge, edge:-edge]
            return c, d, tum_pose(i)

        row = _hold_frames('tumrgbd_distorted', ds, distorted,
                           fx.DEPTH_SCALE['tumrgbd'], lossy=True,
                           pose_tol=1e-4)
        row.update(distortion=desk['distortion'], crop_size=crop,
                   crop_edge=edge)
        res['formats']['tumrgbd_distorted'] = row

        # ScanNet's color at twice the depth's size, resized on reading
        folder = os.path.join(root, 'scannet_2x')
        fx.write_dataset('scannet', folder, frames, h, w, f, f, cx, cy,
                         color_upscale=2)
        row = _hold_frames('scannet_color_2x',
                           get_dataset(cfg_of('scannet', folder)),
                           lambda i: frames[i], fx.DEPTH_SCALE['scannet'],
                           lossy=True)
        row['color_size'] = [2 * h, 2 * w]
        res['formats']['scannet_color_2x'] = row
    emit(res)


def start_tool(module: str, *args) -> subprocess.Popen:
    """`python -m nice_slam_tpu_torch.tools.<module> args` as a user runs
    it (on the CPU), started in the background."""
    return subprocess.Popen(
        [sys.executable, '-m', f'nice_slam_tpu_torch.tools.{module}',
         *args], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def tool_output(proc: subprocess.Popen) -> dict:
    """A started tool's printed `key: value` lines; raises if it failed."""
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    if proc.returncode != 0:
        raise AssertionError(f'{proc.args[2]} exited {proc.returncode}:\n'
                             f'{err[-3000:]}')
    return dict(line.split(': ', 1) for line in out.splitlines()
                if ': ' in line)


def phase_disk_accuracy() -> None:
    """synthetic.yaml's 40 frames written in Replica format by the port's
    writer and run from those files, held to the JAX bound on the same
    files; then eval_ate, cull_mesh and eval_recon on the run's output."""
    import numpy as np
    import yaml
    from nice_slam_tpu_torch.eval.ate import evaluate_ate
    from nice_slam_tpu_torch.eval.recon import calc_3d_metric
    from nice_slam_tpu_torch.io.datasets import synthetic_gt_mesh
    from nice_slam_tpu_torch.mesh.mesher import load_ply, save_ply
    from nice_slam_tpu_torch.tools.make_fixture_dataset import write_scene
    from nice_slam_tpu_torch.utils.config import load_config
    cfg = load_config('configs/Synthetic/synthetic.yaml',
                      'configs/nice_slam.yaml')
    cfg['verbose'] = False
    with tempfile.TemporaryDirectory() as root:
        data, out = os.path.join(root, 'data'), os.path.join(root, 'out')
        t0 = time.perf_counter()
        disk = write_scene(cfg, 'replica', data)
        write_s = time.perf_counter() - t0
        disk['data']['output'] = out
        res, slam = run_slam(disk, out, input_folder=data)
        mesh_path = os.path.join(out, 'mesh', 'final_mesh.ply')
        res['mesh_vertices'] = mesh_vertices(mesh_path)
        rec_v, rec_t = load_ply(mesh_path)
        gt_v, gt_t = synthetic_gt_mesh(cfg['synthetic']['box'])
        res['recon'] = calc_3d_metric(rec_v, rec_t, gt_v, gt_t, align=False)
        res.update(phase='disk_accuracy',
                   config='configs/Synthetic/synthetic.yaml',
                   dataset='replica (files of the port\'s writer)',
                   write_s=write_s,
                   bound_ate_rmse_m=DISK_BOUND_ATE_RMSE_M,
                   bound_max_frame_err_m=DISK_BOUND_MAX_ERR_M,
                   bound_accuracy_cm=DISK_BOUND_ACCURACY_CM,
                   bound_completion_cm=DISK_BOUND_COMPLETION_CM,
                   bound_completion_ratio_pct=DISK_BOUND_COMPLETION_RATIO_PCT)

        # the tools, as a user runs them on the run's output
        scene = os.path.join(root, 'scene.yaml')
        with open(scene, 'w') as fh:
            yaml.safe_dump(disk, fh)
        gt_path = os.path.join(root, 'gt.ply')
        save_ply(gt_path, gt_v, gt_t)
        t0 = time.perf_counter()
        culled = os.path.join(root, 'gt_culled.ply')
        procs = [start_tool('eval_ate', scene, '--output', out),
                 start_tool('cull_mesh', scene, '--input_mesh', gt_path,
                            '--output_mesh', culled),
                 start_tool('eval_recon', '--rec_mesh', mesh_path,
                            '--gt_mesh', gt_path, '-3d')]
        try:
            ate = evaluate_ate(slam.estimate_c2w, slam.gt_c2w)
            recon_aligned = calc_3d_metric(rec_v, rec_t, gt_v, gt_t)
            ate_tool, _, recon_tool = (tool_output(p) for p in procs)
        finally:
            for p in procs:
                p.kill()
        culled_faces = len(load_ply(culled)[1])
        res['tools'] = {
            'eval_ate': ate_tool, 'in_process_ate_rmse_m': ate[
                'absolute_translational_error.rmse'],
            'cull_mesh_faces': [culled_faces, len(gt_t)],
            'eval_recon_3d': recon_tool,
            'in_process_recon_aligned': recon_aligned,
            'seconds': time.perf_counter() - t0}
        emit(res)
        if not (res['ate_rmse_m'] <= DISK_BOUND_ATE_RMSE_M
                and res['max_frame_err_m'] <= DISK_BOUND_MAX_ERR_M):
            raise AssertionError('disk accuracy outside the JAX bound')
        rec = res['recon']
        if not (rec['accuracy_cm'] <= DISK_BOUND_ACCURACY_CM
                and rec['completion_cm'] <= DISK_BOUND_COMPLETION_CM
                and rec['completion_ratio_%']
                >= DISK_BOUND_COMPLETION_RATIO_PCT):
            raise AssertionError('disk reconstruction outside the JAX bound')
        for key in ('rmse', 'mean', 'max'):
            k = f'absolute_translational_error.{key}'
            if ate_tool.get(k) != f'{ate[k]:.6f}':
                raise AssertionError(f'eval_ate printed {ate_tool.get(k)} '
                                     f'for {k}, in process {ate[k]:.6f}')
        if not 0 < culled_faces <= len(gt_t):
            raise AssertionError(f'cull_mesh kept {culled_faces} faces')
        for k, v in recon_aligned.items():
            if recon_tool.get(k) != f'{v:.4f}':
                raise AssertionError(f'eval_recon printed {recon_tool.get(k)}'
                                     f' for {k}, in process {v:.4f}')
        if not np.isfinite(res['ate_rmse_m']):
            raise AssertionError('non-finite disk ATE')


def phase_disk_room0(strict_room0: dict) -> None:
    """room0 at full width from a Replica-format directory that the port's
    writer made from the analytic room0 scene: times beside the analytic
    room0 phase's, host decode ms, the prefetcher's wait, launches, ATE."""
    import numpy as np
    from nice_slam_tpu_torch.io import codecs
    from nice_slam_tpu_torch.io.datasets import get_dataset
    from nice_slam_tpu_torch.tools.make_fixture_dataset import write_scene
    cfg = room0_cfg()
    with tempfile.TemporaryDirectory() as root:
        data, out = os.path.join(root, 'data'), os.path.join(root, 'out')
        t0 = time.perf_counter()
        disk = write_scene(cfg, 'replica', data)
        write_s = time.perf_counter() - t0
        res, slam = run_slam(disk, out, input_folder=data)
        res['mesh_vertices'] = {
            f: mesh_vertices(os.path.join(out, 'mesh', f))
            for f in ('final_mesh.ply', 'final_mesh_eval_rec.ply')}
        # the host's decode of a frame, alone on the host after the run
        ds = get_dataset(disk)
        jpeg_ms, png_ms, frame_ms = [], [], []
        for i in range(len(ds)):
            t0 = time.perf_counter()
            codecs.read_color(ds.color_paths[i])
            t1 = time.perf_counter()
            codecs.read_png(ds.depth_paths[i])
            t2 = time.perf_counter()
            ds[i]
            t3 = time.perf_counter()
            jpeg_ms.append((t1 - t0) * 1e3)
            png_ms.append((t2 - t1) * 1e3)
            frame_ms.append((t3 - t2) * 1e3)
        nbytes = sum(os.path.getsize(p) for p in ds.color_paths
                     + ds.depth_paths)
    maps = [r['ms'] for r in res['map_calls_ms'] if r['kind'] == 'normal']
    strict_maps = [r['ms'] for r in strict_room0['map_calls_ms']
                   if r['kind'] == 'normal']
    res.update(
        phase='disk_room0', config='configs/Replica/room0.yaml',
        dataset='replica (files of the port\'s writer, the analytic room0 '
                'scene)', write_s=write_s, files_bytes=nbytes,
        size=[slam.intr.H, slam.intr.W],
        decode_jpeg_ms_median=statistics.median(jpeg_ms),
        decode_png_ms_median=statistics.median(png_ms),
        frame_read_ms_median=statistics.median(frame_ms),
        map_normal_ms=maps,
        analytic_room0={
            'track_ms_per_frame': strict_room0['track_ms_per_frame'],
            'track_ms_median': strict_room0['track_ms_median'],
            'map_normal_ms': strict_maps,
            'frame_read_s': strict_room0['frame_read_s'],
            'prefetch_wait_s': strict_room0['prefetch_wait_s'],
            'ate_rmse_m': strict_room0['ate_rmse_m'],
            'max_frame_err_m': strict_room0['max_frame_err_m'],
            'wall_s': strict_room0['wall_s']},
        bound_ate_rmse_m=LOOSE_ROOM0_FACTOR * strict_room0['ate_rmse_m'])
    emit(res)
    if not (np.isfinite(res['ate_rmse_m'])
            and res['ate_rmse_m'] <= res['bound_ate_rmse_m']):
        raise AssertionError(f'room0 from disk: ATE {res["ate_rmse_m"]} '
                             f'outside {LOOSE_ROOM0_FACTOR}x the analytic '
                             'run\'s')


# ---------------------------------------------------------------------------
# the parallel backends: ranks as processes (parallel/distributed.py)
# ---------------------------------------------------------------------------

# sharded against single-rank step tolerances: tests/test_parallel.py
# (tracking: losses rtol 2e-4, poses atol 5e-5), tests/test_distributed.py
# (keyframe mapping: losses rtol 2e-4, poses atol 1e-5), tests/
# test_blocked.py (the blocked step against the ray-sharded one: losses
# rtol 1e-4, volumes rtol 1e-4 / atol 5e-6)
PAR_TRACK_RTOL, PAR_TRACK_ATOL = 2e-4, 5e-5
PAR_KF_RTOL, PAR_KF_CAM_ATOL = 2e-4, 1e-5
PAR_BLOCK_RTOL, PAR_BLOCK_ATOL = 1e-4, 5e-6
# the TUM run's ATE on the ranks: at most 5x the world of one's (the rule
# the loose and disk room0 runs use, PERF.md section 2)
TUM_ATE_FACTOR = 5.0
# the kernels every rank of the parallel phases must launch
PAR_KERNELS = ('expand_corners', 'fold_corners', 'gather_rows',
               'scatter_add_rows', 'fused_mlp')
# check C1 (scripts/port_parallel_phases.py --phases loose_c1): per
# parallel.map beside track: rays, 1.5x the worst of seeds 0-2 of the JAX
# package on synthetic.yaml under sync_method: loose on two forced host
# devices (JAX_PLATFORMS=cpu python scripts/port_jax_accuracy_bound.py
# --sync loose --parallel 2 --parallel-map M --seeds S, one process a
# seed): (ATE RMSE, largest per-frame error); worst of map: kf 0.040349 m
# and 0.106751 m, of map: none 0.024735 m and 0.091880 m (all seed 0)
C1_BOUNDS = {'kf': (1.5 * 0.04034936912498007, 1.5 * 0.1067507192492485),
             'none': (1.5 * 0.024734503409652938,
                      1.5 * 0.09188017249107361)}
# parallel_loose: the frames of its free run (ranks on distinct cards),
# and the seconds its ranks may take (a rank that hangs in a collective
# fails the phase)
LOOSE_FREE_FRAMES = 10
LOOSE_TIMEOUT_S = 420
# the TUM run's cuts of depth (the widths and budgets stay the config's)
TUM_FRAMES = 5
TUM_ITERS_FIRST = 100
# the analytic scene inside freiburg1_desk's bound once the TUM loader
# rebases it on the first pose (x - 0.8, y and z negated)
TUM_SCENE = {'box': [[-2.5, 2.5], [-2.0, 2.0], [-3.0, 1.5]],
             'radius': 0.8, 'step': 0.02, 'noise': 0.003}
TUM_MC_BOUND = [[-3.2, 1.6], [-1.9, 1.9], [-1.4, 2.9]]


def rank_count() -> int:
    """One rank per card on a machine of two or more cards, else two ranks
    sharing the one card."""
    import torch
    return max(2, torch.cuda.device_count())


def spawn_ranks(task: str, n: int, args=(), timeout: float = 600.0,
                env=None) -> list:
    """Run `chip_smoke.py --rank-task TASK` as n ranks (the NSTPU_*
    bring-up), each writing its JSON result to a file of its own; returns
    the results in rank order.  Every rank is waited for or killed."""
    import socket
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    tmp = tempfile.mkdtemp(prefix=f'ranks_{task}_')
    procs, logs = [], []
    base = dict(os.environ if env is None else env)
    base.update(NSTPU_COORDINATOR=f'localhost:{port}',
                NSTPU_NUM_PROCESSES=str(n))
    base.pop('NSTPU_CPU_SIM', None)
    base.pop('NSTPU_LOCAL_DEVICES', None)
    try:
        for rank in range(n):
            log = open(os.path.join(tmp, f'rank{rank}.log'), 'w')
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(REPO, 'chip_smoke.py'),
                 '--rank-task', task, '--out',
                 os.path.join(tmp, f'rank{rank}.json'), *args],
                cwd=REPO, env={**base, 'NSTPU_PROCESS_ID': str(rank)},
                stdout=log, stderr=subprocess.STDOUT))
        deadline = time.perf_counter() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        # a rank that hangs: every thread's stack into its log first
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGUSR1)
        time.sleep(3.0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    results, failed = [], []
    for rank, p in enumerate(procs):
        path = os.path.join(tmp, f'rank{rank}.json')
        if p.returncode != 0 or not os.path.exists(path):
            with open(os.path.join(tmp, f'rank{rank}.log')) as f:
                failed.append(f'rank {rank} exited {p.returncode}:\n'
                              f'{f.read()[-8000:]}')
            continue
        with open(path) as f:
            results.append(json.load(f))
    if failed:
        raise AssertionError(f'{task}: ' + '\n'.join(failed))
    return results


def run_rank_task(task: str, out: str, args) -> int:
    """A rank's body: join the world from NSTPU_*, run the task, write its
    JSON result.  Imports nothing of JAX."""
    import faulthandler

    import torch
    from nice_slam_tpu_torch.parallel.distributed import (
        initialize_from_env, shutdown)
    os.chdir(REPO)
    sys.path.insert(0, REPO)
    # spawn_ranks asks a rank that outlives its timeout for its stacks
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    world = initialize_from_env()
    try:
        res = {'parity': rank_parity, 'tum': rank_tum,
               'loose_room0': rank_loose_room0,
               'loose': rank_loose, 'loose_c1': rank_loose_c1}[task](
                   world, args)
        torch.cuda.synchronize()
        res.update(rank=world.rank, world=world.size, backend=world.backend,
                   device=str(world.device),
                   card=torch.cuda.get_device_name(world.device))
    finally:
        shutdown()
    if any(k in sys.modules for k in ('jax', 'nice_slam_tpu')):
        raise AssertionError('a rank imported the JAX package')
    with open(out, 'w') as f:
        json.dump(res, f)
    return 0


def _digest(*tensors) -> str:
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _launch_counts() -> dict:
    from nice_slam_tpu_torch.ops import expand as ex
    from nice_slam_tpu_torch.ops import fused_mlp as fm
    from nice_slam_tpu_torch.ops import gather as ga
    return {**ex.LAUNCHES, **ga.LAUNCHES, **fm.LAUNCHES}


def _reset_launch_counts() -> None:
    from nice_slam_tpu_torch.ops import expand as ex
    from nice_slam_tpu_torch.ops import fused_mlp as fm
    from nice_slam_tpu_torch.ops import gather as ga
    for mod in (ex, fm, ga):
        mod.reset_launch_counts()


def _parity_world(dev):
    """synthetic.yaml's model on the card with random decoders and volumes
    at 0.1 (every stage has real gradients), and four of its frames."""
    import torch
    from nice_slam_tpu_torch.io.datasets import get_dataset
    from nice_slam_tpu_torch.models.decoders import init_nice_decoders
    from nice_slam_tpu_torch.models.grids import (
        init_grids, static_grid_shapes)
    from nice_slam_tpu_torch.render.renderer import SceneModel
    from nice_slam_tpu_torch.utils import config as C
    cfg = C.load_config('configs/Synthetic/synthetic.yaml',
                        'configs/nice_slam.yaml')
    gcfg, dcfg = C.grid_config_from_cfg(cfg), C.decoder_config_from_cfg(cfg)
    gen = torch.Generator().manual_seed(0)
    decs = init_nice_decoders(dcfg, generator=gen, device='cpu').to(dev)
    grids = {k: (torch.randn(g.shape, generator=gen) * 0.1).to(dev)
             for k, g in init_grids(gcfg, generator=gen,
                                    device='cpu').items()}
    model = SceneModel(decoder=dcfg,
                       bound=torch.tensor(gcfg.bound_np, device=dev),
                       coarse_bound=torch.tensor(gcfg.coarse_bound_np,
                                                 device=dev),
                       grid_shapes=static_grid_shapes(gcfg))
    ds = get_dataset(cfg)
    frames = [ds[i] for i in (0, 3, 6, 9)]
    return cfg, model, decs, grids, frames


def _fresh(decs, grids):
    import copy
    return (copy.deepcopy(decs),
            {k: g.detach().clone().requires_grad_(True)
             for k, g in grids.items()})


def rank_parity(world, args) -> dict:
    """The step-level checks of tests/test_torch_parallel.py at small sizes
    with the kernels launched: each sharded step against the single-rank
    step on this rank (the same draws), digests of the outputs for the
    parent's bit-identity check over the ranks."""
    import numpy as np
    import torch
    from nice_slam_tpu_torch.core.cameras import tensor_from_c2w
    from nice_slam_tpu_torch.engine import mapper as tm
    from nice_slam_tpu_torch.engine.tracker import track_frame
    from nice_slam_tpu_torch.mesh.mesher import Mesher
    from nice_slam_tpu_torch.models.grids import prepare_grids
    from nice_slam_tpu_torch.parallel import blocks, distributed, sharded
    from nice_slam_tpu_torch.parallel.mesh import make_block_grid
    from nice_slam_tpu_torch.render.renderer import eval_raw
    from nice_slam_tpu_torch.utils import config as C
    dev = world.device
    cfg, model, decs, grids, frames = _parity_world(dev)
    intr, rcfg = C.intrinsics_from_cfg(cfg), C.render_config_from_cfg(cfg)
    colors = torch.stack([torch.as_tensor(f[1]) for f in frames]).to(dev)
    depths = torch.stack([torch.as_tensor(f[2]) for f in frames]).to(dev)
    c2ws = np.stack([f[3] for f in frames])
    cams = tensor_from_c2w(torch.as_tensor(c2ws[:, :3, :4]).to(dev))
    cams[1:, 4:] += 0.005
    res = {}

    # ray-sharded tracking: the same global draws on every rank
    tcfg = C.tracker_config_from_cfg(cfg)._replace(pixels=1000, iters=10)
    gen = torch.Generator().manual_seed(1)
    draws = [tuple(x.to(dev) for x in (
        torch.randint(tcfg.ignore_edge_w, intr.W - tcfg.ignore_edge_w,
                      (tcfg.pixels,), generator=gen).float(),
        torch.randint(tcfg.ignore_edge_h, intr.H - tcfg.ignore_edge_h,
                      (tcfg.pixels,), generator=gen).float()))
        for _ in range(tcfg.iters)]
    kw = dict(model=model, rcfg=rcfg, tcfg=tcfg, intr=intr, draws=draws)
    guess = cams[1].clone()
    guess[4:] += 0.01
    _reset_launch_counts()
    t0 = time.perf_counter()
    best, _, losses = sharded.sharded_track_frame(
        decs, grids, colors[1], depths[1], guess, group=world, **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = _launch_counts()
    b1, _, l1 = track_frame(decs, grids, colors[1], depths[1], guess, **kw)
    res['track'] = dict(
        ms=ms, launches=launches, digest=_digest(best, losses),
        loss_rel_err=float(((losses - l1).abs() / l1.abs()).max()),
        pose_err=float((best - b1).abs().max()),
        moved=float((best - guess).abs().max()))

    # keyframe-sharded mapping: 4 frames, the global draws sliced
    mcfg = C.mapper_config_from_cfg(cfg)._replace(ba=True)
    n_iters, pix = 12, 250
    gen = torch.Generator().manual_seed(2)
    mdraws = [tm.MapDraws(*(x.to(dev) for x in tm.draw_window_pixels(
        4, pix, intr, generator=gen, device='cpu'))) for _ in range(n_iters)]
    mkw = dict(trainable=('color', 'fine'), masks=None,
               cam_mask=torch.tensor([0.0, 1.0, 1.0, 1.0], device=dev),
               lr_tab=tm.lr_table(mcfg, n_iters, 0.2, True),
               stage_idx=tm.stage_schedule(mcfg, n_iters), model=model,
               rcfg=rcfg, mcfg=mcfg, intr=intr, pix_per_frame=pix)
    d_kf, g_kf = _fresh(decs, grids)
    mine = distributed.window_slice(4, world)
    _reset_launch_counts()
    t0 = time.perf_counter()
    c_kf, l_kf = distributed.kf_sharded_map_step(
        d_kf, g_kf, cams, group=world, colors=colors[mine],
        depths=depths[mine], draws=mdraws, **mkw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = _launch_counts()
    d_1, g_1 = _fresh(decs, grids)
    c_1, l_1 = tm.map_step(d_1, g_1, cams, colors=colors, depths=depths,
                           draws=mdraws, **mkw)
    res['kf_map'] = dict(
        ms=ms, launches=launches,
        digest=_digest(c_kf, l_kf, *g_kf.values()),
        loss_rel_err=float(((l_kf - l_1).abs() / l_1.abs()).max()),
        cam_err=float((c_kf - c_1).abs().max()),
        moved=float((c_kf - cams).abs().max()))

    # grid-block TP (2 blocks) against the ray-sharded step of the same
    # ray shares
    block_group, rays_group = make_block_grid(world, 2, tag='parity')
    gen = torch.Generator().manual_seed(3 + rays_group.rank)
    local = pix // rays_group.size
    bdraws = [tm.MapDraws(*(x.to(dev) for x in tm.draw_window_pixels(
        4, local, intr, generator=gen, device='cpu'))) for _ in range(6)]
    bkw = dict(mkw, lr_tab=tm.lr_table(mcfg, 6, 0.2, True),
               stage_idx=tm.stage_schedule(mcfg, 6))
    d_r, g_r = _fresh(decs, grids)
    c_r, l_r = sharded.ray_sharded_map_step(
        d_r, g_r, cams, group=rays_group, colors=colors, depths=depths,
        draws=bdraws, **bkw)
    plan = blocks.plan_blocks(model.grid_shapes, 2)
    d_b, g_b = _fresh(decs, grids)
    padded = blocks.pad_for_blocks({k: g.detach() for k, g in g_b.items()},
                                   plan)
    slabs = {k: blocks.block_slab(padded[k], plan[k], block_group.rank)
             .clone().requires_grad_(True) for k in padded}
    _reset_launch_counts()
    t0 = time.perf_counter()
    c_b, l_b = blocks.blocked_map_step(
        d_b, slabs, cams, block_group=block_group, rays_group=rays_group,
        plan=plan, colors=colors, depths=depths, draws=bdraws, **bkw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = _launch_counts()
    def excess(got, want, atol):
        got, want = got.detach(), want.detach()
        return float(((got - want).abs()
                      - (atol + PAR_BLOCK_RTOL * want.abs())).max())

    grid_excess = max(excess(slab, blocks.block_slab(blocks.pad_for_blocks(
        {k: g_r[k].detach()}, plan)[k], plan[k], block_group.rank),
        PAR_BLOCK_ATOL) for k, slab in slabs.items())
    res['blocked_map'] = dict(
        ms=ms, launches=launches, blocks=2, ray_shares=rays_group.size,
        digest=_digest(c_b, l_b),
        loss_rel_err=float(((l_b - l_r).abs() / l_r.abs()).max()),
        cam_excess_over_tol=excess(c_b, c_r, 1e-6),
        grid_excess_over_tol=grid_excess)

    # the sharded lattice query at one 256^3-lattice chunk, through the
    # fused decoder kernel, against the unsharded query
    mesher = Mesher(C.mesher_config_from_cfg(cfg)._replace(resolution=256),
                    model, intr)
    pts, *_ = mesher.lattice()
    mid = len(pts) // 2 // POINTS_BATCH * POINTS_BATCH
    chunk = torch.as_tensor(pts[mid:mid + POINTS_BATCH], device=dev)
    with torch.no_grad():
        exp = prepare_grids(grids, model.grid_shapes)
        _reset_launch_counts()
        t0 = time.perf_counter()
        got = sharded.sharded_eval_points(decs, exp, chunk, 'fine',
                                          mesher.model, world)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = _launch_counts()
        one = eval_raw(decs, exp, chunk, 'fine', mesher.model)
    res['eval_points'] = dict(
        ms=ms, launches=launches, points=int(chunk.shape[0]),
        bit_equal=bool(torch.equal(got, one)), digest=_digest(got))
    return res


def phase_parallel_parity() -> None:
    """The parallel steps on ranks against the single-rank steps."""
    import torch
    n = rank_count()
    t0 = time.perf_counter()
    ranks = spawn_ranks('parity', n, timeout=600)
    res = {'phase': 'parallel_parity', 'world': n,
           'backend': ranks[0]['backend'],
           'cards': sorted({r['device'] for r in ranks}),
           'card_names': sorted({r['card'] for r in ranks}),
           'visible_cards': torch.cuda.device_count(),
           'seconds': time.perf_counter() - t0,
           'tolerances': {'track': [PAR_TRACK_RTOL, PAR_TRACK_ATOL],
                          'kf_map': [PAR_KF_RTOL, PAR_KF_CAM_ATOL],
                          'blocked_map': [PAR_BLOCK_RTOL, PAR_BLOCK_ATOL]}}
    for check in ('track', 'kf_map', 'blocked_map', 'eval_points'):
        res[check] = [{k: v for k, v in r[check].items() if k != 'digest'}
                      for r in ranks]
        res[check + '_ranks_bit_identical'] = len(
            {r[check]['digest'] for r in ranks}) == 1
    emit(res)
    bad = [c for c in ('track', 'kf_map', 'blocked_map', 'eval_points')
           if not res[c + '_ranks_bit_identical']]
    for r in ranks:
        t, k, b, e = (r['track'], r['kf_map'], r['blocked_map'],
                      r['eval_points'])
        if not (t['loss_rel_err'] <= PAR_TRACK_RTOL
                and t['pose_err'] <= PAR_TRACK_ATOL and t['moved'] > 1e-4):
            bad.append(f'track on rank {r["rank"]}')
        if not (k['loss_rel_err'] <= PAR_KF_RTOL
                and k['cam_err'] <= PAR_KF_CAM_ATOL and k['moved'] > 1e-5):
            bad.append(f'kf_map on rank {r["rank"]}')
        if not (b['loss_rel_err'] <= PAR_BLOCK_RTOL
                and b['cam_excess_over_tol'] <= 0.0
                and b['grid_excess_over_tol'] <= 0.0):
            bad.append(f'blocked_map on rank {r["rank"]}')
        if not e['bit_equal']:
            bad.append(f'eval_points on rank {r["rank"]}')
        for check, need in (('track', ('expand_corners', 'gather_rows')),
                            ('kf_map', ('expand_corners', 'fold_corners',
                                        'gather_rows', 'scatter_add_rows')),
                            ('blocked_map', ('gather_rows',
                                             'scatter_add_rows')),
                            ('eval_points', ('fused_mlp', 'gather_rows'))):
            if min(r[check]['launches'][k] for k in need) == 0:
                bad.append(f'{check} on rank {r["rank"]}: kernels not '
                           f'launched')
    if bad:
        raise AssertionError(f'parallel_parity failed: {bad}')


def tum_cfg(input_dir: str) -> dict:
    """configs/TUM_RGBD/freiburg1_desk_multichip.yaml as loaded (480x640
    with fr1/desk's distortion, crop and budgets: tracking 5000 px x 200,
    mapping 5000 px x 60 every frame, window 10), reading the analytic
    scene the port's writer made in TUM format, cut in depth only."""
    from nice_slam_tpu_torch.utils.config import load_config
    cfg = load_config('configs/TUM_RGBD/freiburg1_desk_multichip.yaml',
                      'configs/nice_slam.yaml')
    cfg['verbose'] = False
    cfg['synthetic'] = dict(TUM_SCENE, n_frames=TUM_FRAMES)
    cfg['data']['input_folder'] = input_dir
    cfg['cam']['png_depth_scale'] = 5000.0
    cfg['mapping']['iters_first'] = TUM_ITERS_FIRST
    cfg['mapping']['color_refine'] = False
    cfg['mapping']['marching_cubes_bound'] = TUM_MC_BOUND
    return cfg


def tum_run(input_dir: str, output: str, world=None,
            sync: str | None = None) -> tuple:
    """One run of the TUM multichip config on `world` (a world of one when
    None), under `sync` (default: the config's, strict); returns (result,
    the system).  The collectives are counted over this run alone (a
    rank's groups are made once per process and kept)."""
    import numpy as np
    import torch
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    from nice_slam_tpu_torch.eval.ate import evaluate_ate
    cfg = tum_cfg(input_dir)
    if sync is not None:
        cfg['sync_method'] = sync
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    t0 = time.perf_counter()
    slam = SlamSystem(cfg, device='cuda', seed=0, output=output, world=world)
    groups = {'track': slam._track_group, 'map': slam._map_group,
              'mesh': slam._mesh_group, 'control': slam._control}
    groups = {k: g for k, g in groups.items() if g is not None and g.size > 1}
    start = {}
    for name, g in groups.items():
        g.stats.timed = True
        start[name] = (g.stats.calls, g.stats.bytes, g.stats.seconds)
    slam.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    est, gt = slam.estimate_c2w, slam.gt_c2w
    tracked = [s * 1e3 for idx, s in slam.timers.track if idx > 0]
    maps = [(kind, n, s * 1e3) for _, kind, n, s in slam.timers.maps]
    track_iters = slam.tcfg.iters * len(tracked)
    map_iters = sum(n for _, n, _ in maps)
    coll = {}
    for name, g in groups.items():
        calls, nbytes, seconds = start[name]
        coll[name] = {'calls': g.stats.calls - calls,
                      'bytes': g.stats.bytes - nbytes,
                      'seconds': g.stats.seconds - seconds}
    mesh_path = os.path.join(output, 'mesh', 'final_mesh.ply')
    res = {
        'frames': int(slam.n_img), 'wall_s': wall,
        'ate_rmse_m': evaluate_ate(est, gt)[
            'absolute_translational_error.rmse'],
        'max_frame_err_m': float(np.linalg.norm(
            est[:, :3, 3] - gt[:, :3, 3], axis=-1).max()),
        'finite': bool(np.isfinite(est).all()),
        'poses_digest': __import__('hashlib').sha256(
            np.ascontiguousarray(est).tobytes()).hexdigest(),
        'track_ms_per_frame_median': statistics.median(tracked),
        'track_ms_per_frame': tracked,
        'map_calls_ms': maps,
        'collectives': coll,
        'backends': {name: g.backend for name, g in groups.items()},
        'collective_ms_per_track_iter': (
            coll['track']['seconds'] * 1e3 / track_iters
            if 'track' in coll else 0.0),
        'collective_ms_per_map_iter': (
            coll['map']['seconds'] * 1e3 / map_iters
            if 'map' in coll else 0.0),
        'launches': _launch_counts(),
        'peak_mem_bytes': int(torch.cuda.max_memory_allocated()),
        'mesh_s': slam.timers.mesh_s,
        'writes': slam.writes,
        'final_mesh_vertices': (mesh_vertices(mesh_path)
                                if slam.writes else None),
    }
    if slam._control is not None:
        res.update(sync_method=slam.sync_method,
                   refreshes=dict(slam.refreshes),
                   adoptions=slam.adoptions,
                   control_ms_per_frame=(coll.get('control', {}).get(
                       'seconds', 0.0) * 1e3 / slam.n_img))
    return res, slam


def rank_tum(world, args) -> dict:
    res, _ = tum_run(args.input, args.output_dir, world)
    return res


def write_tum(root: str) -> tuple:
    """The analytic scene in TUM format at freiburg1_desk's 480x640, in
    `root`; returns (its directory, the seconds the write took)."""
    from nice_slam_tpu_torch.tools.make_fixture_dataset import write_scene
    data = os.path.join(root, 'tum')
    cfg = tum_cfg(data)
    t0 = time.perf_counter()
    write_scene({'cam': dict(cfg['cam']), 'synthetic': cfg['synthetic']},
                'tumrgbd', data)
    return data, time.perf_counter() - t0


def phase_parallel_tum(root: str, data: str, write_s: float) -> tuple:
    """freiburg1_desk_multichip.yaml (track: rays, map: rays) from the
    TUM-format directory `data` of the analytic scene at 480x640: a world
    of one in this process, then the sharded world as ranks.  Returns (the
    world of one's result, the ranks')."""
    import torch
    n = rank_count()
    one, slam = tum_run(data, os.path.join(root, 'one'))
    del slam
    torch.cuda.empty_cache()
    out = os.path.join(root, 'ranks')
    ranks = spawn_ranks('tum', n, ['--input', data, '--output-dir', out],
                        timeout=900)
    res = {'phase': 'parallel_tum',
           'config': 'configs/TUM_RGBD/freiburg1_desk_multichip.yaml',
           'world': n, 'backend': ranks[0]['backend'],
           'cards': sorted({r['device'] for r in ranks}),
           'visible_cards': torch.cuda.device_count(),
           'cuts': {'frames': f'{TUM_FRAMES} (the analytic scene)',
                    'iters_first': f'1500 -> {TUM_ITERS_FIRST}',
                    'color_refine': 'true -> false',
                    'marching_cubes_bound': 'the analytic scene\'s'},
           'fixture_write_s': write_s, 'world_of_one': one,
           'ranks': ranks,
           'poses_bit_identical': len({r['poses_digest']
                                       for r in ranks}) == 1,
           'bound_ate_rmse_m': TUM_ATE_FACTOR * one['ate_rmse_m']}
    emit(res)
    bad = []
    if not res['poses_bit_identical']:
        bad.append('ranks\' poses differ')
    for r in ranks:
        if not (r['finite'] and r['ate_rmse_m'] <= res['bound_ate_rmse_m']):
            bad.append(f'rank {r["rank"]} ATE {r["ate_rmse_m"]}')
        if min(r['launches'][k] for k in PAR_KERNELS) == 0:
            bad.append(f'rank {r["rank"]} kernels {r["launches"]}')
        if 'mesh' not in r['collectives'] or not r['collectives']['mesh'][
                'calls']:
            bad.append(f'rank {r["rank"]}: no sharded lattice query')
    writer = [r for r in ranks if r['writes']]
    if len(writer) != 1 or not writer[0]['final_mesh_vertices']:
        bad.append('the final mesh was not written by one rank')
    if bad:
        raise AssertionError(f'parallel_tum failed: {bad}')
    return one, ranks


def loose_synthetic_cfg(sync: str, frames: int | None = None,
                        par_map: str = 'rays') -> dict:
    """synthetic.yaml as shipped under `sync` with the tracking rays and
    the mapping (`par_map`: its rays by default, the JAX bound's setting)
    shared over the ranks, cut to `frames` when given."""
    from nice_slam_tpu_torch.utils.config import load_config
    cfg = load_config('configs/Synthetic/synthetic.yaml',
                      'configs/nice_slam.yaml')
    cfg['verbose'] = False
    cfg['sync_method'] = sync
    cfg['parallel'] = {'track': 'rays', 'map': par_map}
    if frames is not None:
        cfg['synthetic']['n_frames'] = frames
    return cfg


def _overlap_rank_run(cfg: dict) -> dict:
    """A synthetic run (no meshes) on this rank under the overlapped
    schedule of `cfg`: its accuracy, its poses' digest, its adoptions, and
    the warnings of its construction and run."""
    import hashlib
    import warnings

    import numpy as np
    with tempfile.TemporaryDirectory() as out, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        res, slam = run_slam(cfg, out, mesh=False)
    keep = ('frames', 'wall_s', 'ate_rmse_m', 'max_frame_err_m',
            'track_ms_median', 'peak_mem_bytes', 'sync_method', 'refreshes',
            'launches')
    row = {k: res[k] for k in keep}
    row.update(
        map_ms=[round(r['ms'], 1) for r in res['map_calls_ms']
                if r['kind'] != 'coarse'],
        poses_digest=hashlib.sha256(np.ascontiguousarray(
            slam.estimate_c2w).tobytes()).hexdigest(),
        adoptions=slam.adoptions, map_device=str(slam.map_device),
        warnings=sorted({str(w.message)[:80] for w in caught}))
    return row


def _free_rank_run() -> dict:
    """synthetic.yaml cut to LOOSE_FREE_FRAMES frames under free: the
    schedule the system chose and the warnings of its construction; when
    it kept free (ranks on distinct cards), its run."""
    import warnings

    from nice_slam_tpu_torch.engine.slam import SlamSystem
    cfg = loose_synthetic_cfg('free', LOOSE_FREE_FRAMES)
    with tempfile.TemporaryDirectory() as out, \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        sync = SlamSystem(cfg, device='cuda', seed=0,
                          output=out).sync_method
    if sync == 'free':
        return _overlap_rank_run(cfg)
    return {'sync_method': sync, 'poses_digest': None, 'adoptions': [],
            'warnings': sorted({str(w.message)[:80] for w in caught})}


def rank_loose(world, args) -> dict:
    """The parallel_loose phase on this rank: (a) synthetic.yaml under
    loose, (b) the TUM multichip config under loose at full width, (c)
    the free rule."""
    syn = _overlap_rank_run(loose_synthetic_cfg('loose'))
    tum, slam = tum_run(args.input, args.output_dir, world, sync='loose')
    tum['map_device'] = str(slam.map_device)
    del slam
    return {'synthetic': syn, 'tum': tum, 'free': _free_rank_run()}


def phase_parallel_loose(root: str, data: str, tum_one: dict,
                         tum_strict: list) -> None:
    """The overlapped schedules on ranks (two sharing the card on a
    machine of one card, one a card on more): synthetic.yaml under loose
    against the JAX bound of the same setting, the TUM multichip config
    under loose at full width beside parallel_tum's strict ranks, and the
    `free` rule (ranks on distinct cards run a cut synthetic.yaml under
    free; ranks sharing one only build the system, which must fall back).
    Every rank is one process of `spawn_ranks`, so a rank that hangs fails
    the phase at the timeout."""
    import torch
    n = rank_count()
    ranks = spawn_ranks('loose', n, ['--input', data, '--output-dir',
                                     os.path.join(root, 'loose')],
                        timeout=LOOSE_TIMEOUT_S)
    syn = [r['synthetic'] for r in ranks]
    tum = [r['tum'] for r in ranks]
    free = [r['free'] for r in ranks]
    distinct = len({r['device'] for r in ranks}) >= 2
    per_rank = []
    for r, t in zip(ranks, tum):
        normal = [ms for kind, _, ms in t['map_calls_ms'] if kind == 'normal']
        per_rank.append({
            'rank': r['rank'], 'device': r['device'],
            'map_device': t['map_device'],
            'track_ms_per_frame_median': t['track_ms_per_frame_median'],
            'track_ms_per_frame': t['track_ms_per_frame'],
            'map_ms_per_normal_call': normal,
            'refreshes': t['refreshes'],
            'control_calls': t['collectives'].get('control', {}).get(
                'calls', 0),
            'control_ms_per_frame': t['control_ms_per_frame'],
            'collective_ms': {k: v['seconds'] * 1e3
                              for k, v in t['collectives'].items()},
            'collective_calls': {k: v['calls']
                                 for k, v in t['collectives'].items()},
            'backends': t['backends'],
            'peak_mem_bytes': t['peak_mem_bytes'],
            'launches': t['launches'], 'ate_rmse_m': t['ate_rmse_m'],
            'wall_s': t['wall_s']})
    res = {'phase': 'parallel_loose', 'world': n,
           'backend': ranks[0]['backend'],
           'cards': sorted({r['device'] for r in ranks}),
           'synthetic': {
               'config': 'configs/Synthetic/synthetic.yaml, sync_method: '
                         'loose, parallel: {track: rays, map: rays}',
               'ranks': syn,
               'poses_bit_identical': len({r['poses_digest']
                                           for r in syn}) == 1,
               'adoptions_identical': all(r['adoptions'] == syn[0]['adoptions']
                                          for r in syn),
               'bound_ate_rmse_m': PAR_LOOSE_BOUND_ATE_RMSE_M,
               'bound_max_frame_err_m': PAR_LOOSE_BOUND_MAX_ERR_M},
           'tum': {
               'config': 'configs/TUM_RGBD/freiburg1_desk_multichip.yaml, '
                         'sync_method: loose (cut as parallel_tum)',
               'ranks': per_rank,
               'strict_ranks_track_ms_median': [
                   r['track_ms_per_frame_median'] for r in tum_strict],
               'strict_ranks_map_ms_per_normal_call': [
                   [ms for kind, _, ms in r['map_calls_ms']
                    if kind == 'normal'] for r in tum_strict],
               'world_of_one_track_ms_median': tum_one[
                   'track_ms_per_frame_median'],
               'world_of_one_ate_rmse_m': tum_one['ate_rmse_m'],
               'strict_ranks_ate_rmse_m': tum_strict[0]['ate_rmse_m'],
               'poses_bit_identical': len({t['poses_digest']
                                           for t in tum}) == 1,
               'poses_as_strict_ranks': (tum[0]['poses_digest']
                                         == tum_strict[0]['poses_digest']),
               'adoptions_identical': all(t['adoptions'] == tum[0]['adoptions']
                                          for t in tum),
               'bound_ate_rmse_m': TUM_ATE_FACTOR * tum_one['ate_rmse_m']},
           'free': {
               'ran': 'free' if distinct else 'none: loose chosen (the '
                                              'ranks share one device)',
               'ranks': free,
               'poses_bit_identical': len({r['poses_digest']
                                           for r in free}) == 1,
               'adoptions_identical': all(
                   r['adoptions'] == free[0]['adoptions'] for r in free)},
           'visible_cards': torch.cuda.device_count()}
    emit(res)
    bad = []
    for name in ('synthetic', 'tum', 'free'):
        if not (res[name]['poses_bit_identical']
                and res[name]['adoptions_identical']):
            bad.append(f'{name}: the ranks parted')
    for r in syn:
        if r['sync_method'] != 'loose' or not (
                r['ate_rmse_m'] <= PAR_LOOSE_BOUND_ATE_RMSE_M
                and r['max_frame_err_m'] <= PAR_LOOSE_BOUND_MAX_ERR_M):
            bad.append(f'synthetic: ATE {r["ate_rmse_m"]} / '
                       f'{r["max_frame_err_m"]}')
    for r, t in zip(per_rank, tum):
        if not (t['finite'] and t['ate_rmse_m']
                <= res['tum']['bound_ate_rmse_m']):
            bad.append(f'tum: rank {r["rank"]} ATE {t["ate_rmse_m"]}')
        if t['sync_method'] != 'loose' or r['map_device'] != r['device']:
            bad.append(f'tum: rank {r["rank"]} ran {t["sync_method"]} '
                       f'mapping on {r["map_device"]}')
        if min(t['launches'][k] for k in PAR_KERNELS) == 0:
            bad.append(f'tum: rank {r["rank"]} kernels {t["launches"]}')
    fallback = ["'free'" in w for r in free for w in r['warnings']]
    if distinct:
        if any(r['sync_method'] != 'free' for r in free) or any(fallback):
            bad.append('free: ranks on distinct cards did not keep free')
    elif sum(fallback) != len(free) or any(
            r['sync_method'] != 'loose' for r in free):
        bad.append('free: ranks sharing a card did not fall back to loose')
    if bad:
        raise AssertionError(f'parallel_loose failed: {bad}')


def rank_loose_c1(world, args) -> dict:
    """Check C1 on this rank: synthetic.yaml under loose with the tracking
    rays shared and the mapping window's frames shared (map: kf), then
    with mapping on each rank alone (map: none)."""
    return {m: _overlap_rank_run(loose_synthetic_cfg('loose', par_map=m))
            for m in C1_BOUNDS}


def phase_loose_c1() -> None:
    """Check C1, the two NCCL settings of the overlapped schedules that
    parallel_loose does not run (one rank a card on more than one card,
    two ranks sharing it on one): synthetic.yaml under loose with
    parallel: {track: rays, map: kf}, where the tracker's all-reduces go
    through gloo beside the window's NCCL ones, and {track: rays} alone,
    where the tracker's NCCL group runs on the main thread while the
    mapping thread launches kernels on its own stream.  Per setting: the
    ranks' poses and adoption records identical, ATE RMSE and largest
    per-frame error within 1.5x the worst of JAX seeds 0-2 in the same
    setting, and no rank outliving LOOSE_TIMEOUT_S (a hang).  Not run by
    main(): scripts/port_parallel_phases.py --phases loose_c1."""
    import torch
    n = rank_count()
    ranks = spawn_ranks('loose_c1', n, timeout=LOOSE_TIMEOUT_S)
    res = {'phase': 'loose_c1', 'world': n, 'backend': ranks[0]['backend'],
           'cards': sorted({r['device'] for r in ranks}),
           'visible_cards': torch.cuda.device_count()}
    bad = []
    for m, (b_rmse, b_max) in C1_BOUNDS.items():
        rows = [r[m] for r in ranks]
        res[m] = {
            'config': 'configs/Synthetic/synthetic.yaml, sync_method: '
                      f'loose, parallel: {{track: rays, map: {m}}}',
            'ranks': rows,
            'poses_bit_identical': len({r['poses_digest']
                                        for r in rows}) == 1,
            'adoptions_identical': all(r['adoptions'] == rows[0]['adoptions']
                                       for r in rows),
            'bound_ate_rmse_m': b_rmse, 'bound_max_frame_err_m': b_max}
        if not (res[m]['poses_bit_identical']
                and res[m]['adoptions_identical']):
            bad.append(f'{m}: the ranks parted')
        for r in rows:
            if r['sync_method'] != 'loose' or not (
                    r['ate_rmse_m'] <= b_rmse
                    and r['max_frame_err_m'] <= b_max):
                bad.append(f'{m}: {r["sync_method"]}, ATE '
                           f'{r["ate_rmse_m"]} / {r["max_frame_err_m"]}')
    emit(res)
    if bad:
        raise AssertionError(f'loose_c1 failed: {bad}')


def rank_loose_room0(world, args) -> dict:
    """room0 under loose on the one card this process sees."""
    cfg = room0_cfg()
    cfg['sync_method'] = 'loose'
    with tempfile.TemporaryDirectory() as out:
        res, slam = run_slam(cfg, out, mesh=False)
        res['map_device'] = str(slam.map_device)
    return res


def phase_pipeline(strict_room0: dict, overlap_room0: dict) -> None:
    """The two-device pipeline (loose, a world of one, two or more cards:
    the mapper on the second card): the overlap phase's room0 ran it;
    beside it the same run on one card (a process that sees one)."""
    import torch
    cards = torch.cuda.device_count()
    if cards < 2:
        emit({'phase': 'pipeline', 'ran': False, 'cards': cards})
        return
    env = dict(os.environ,
               CUDA_VISIBLE_DEVICES=os.environ.get(
                   'CUDA_VISIBLE_DEVICES', '0').split(',')[0])
    one = spawn_ranks('loose_room0', 1, timeout=600, env=env)[0]
    maps = [r['ms'] for r in overlap_room0['map_calls_ms']
            if r['kind'] == 'normal']
    one_maps = [r['ms'] for r in one['map_calls_ms']
                if r['kind'] == 'normal']
    res = {'phase': 'pipeline', 'ran': True, 'cards': cards,
           'map_device': overlap_room0['map_device'],
           'track_ms_median': overlap_room0['track_ms_median'],
           'one_card_track_ms_median': one['track_ms_median'],
           'map_ms_per_normal_call': maps,
           'one_card_map_ms_per_normal_call': one_maps,
           'wall_s': overlap_room0['wall_s'],
           'one_card_wall_s': one['wall_s'],
           'one_card_map_device': one['map_device'],
           'ate_rmse_m': overlap_room0['ate_rmse_m'],
           'one_card_ate_rmse_m': one['ate_rmse_m'],
           'bound_ate_rmse_m': LOOSE_ROOM0_FACTOR * strict_room0[
               'ate_rmse_m'],
           'refreshes': overlap_room0['refreshes'],
           'sync_method': overlap_room0['sync_method']}
    emit(res)
    if overlap_room0['map_device'] == 'cuda:0' or not (
            res['ate_rmse_m'] <= res['bound_ate_rmse_m']):
        raise AssertionError('pipeline: the mapper did not run on the '
                             'second card, or its ATE is outside 5x the '
                             'strict run\'s')


def expected_panels(cfg: dict, n_img: int) -> dict:
    """The panel files of a strict run by the JAX package's rule
    (nice_slam_tpu/engine/slam.py): a tracking panel on every frame past 0
    that is a multiple of tracking.vis_freq; on mapped frames that are
    multiples of mapping.vis_freq (frame 0 not while
    no_vis_on_first_frame), one before every chunk of the mapping call
    whose start is a multiple of vis_inside_freq (chunks of `iters`
    iterations, at most vis_inside_freq), and past frame 0 one after it
    (iteration 0000)."""
    t, m = cfg['tracking'], cfg['mapping']
    t_freq, m_freq = t.get('vis_freq', 50), m.get('vis_freq', 50)
    inside = m.get('vis_inside_freq', 0)
    every = m['every_frame']
    out = {'tracking_vis': {f'{i:05d}_0000.jpg' for i in range(1, n_img)
                            if i % t_freq == 0},
           'mapping_vis': set()}
    for i in range(n_img):
        if not (i == 0 or i % every == 0 or i == n_img - 1) or i % m_freq:
            continue
        if i > 0:
            out['mapping_vis'].add(f'{i:05d}_0000.jpg')
        if i == 0 and m.get('no_vis_on_first_frame', True) or not inside:
            continue
        n_iters = m['iters_first'] if i == 0 else m['iters']
        chunk = max(min(m['iters'], n_iters, inside), 1)
        out['mapping_vis'] |= {f'{i:05d}_{c:04d}.jpg'
                               for c in range(0, n_iters, chunk)
                               if c % inside == 0}
    return {k: sorted(v) for k, v in out.items()}


def phase_services(accuracy_c2w) -> None:
    """synthetic.yaml with render panels and the live dashboard, against
    the accuracy phase's run; then the replay tool on its output."""
    import threading
    import urllib.request

    import numpy as np
    import torch
    from nice_slam_tpu_torch.io.codecs import read_color
    from nice_slam_tpu_torch.tools import visualizer as replay_tool
    from nice_slam_tpu_torch.utils.config import deep_update, load_config
    from nice_slam_tpu_torch.utils.visualizer import panel_size
    cfg = load_config('configs/Synthetic/synthetic.yaml',
                      'configs/nice_slam.yaml')
    cfg['verbose'] = False
    cfg['mapping']['mesh_freq'] = 20          # as the accuracy phase
    deep_update(cfg, json.loads(json.dumps(SERVICES_VIS)))
    if (cfg.get('debug') or {}).get('profile_dir'):
        raise AssertionError('debug.profile_dir is set')
    fetched, stop = [], threading.Event()

    def start_polling(slam):
        url = f'http://127.0.0.1:{slam.live.port}/status.json'

        def poll():
            while not stop.is_set():
                try:
                    with urllib.request.urlopen(url, timeout=5) as r:
                        fetched.append(json.loads(r.read()))
                except OSError:
                    pass
                stop.wait(0.5)

        threading.Thread(target=poll, daemon=True).start()

    with tempfile.TemporaryDirectory() as out:
        try:
            res, slam = run_slam(cfg, out, on_start=start_polling)
        finally:
            stop.set()
        panels = {d: sorted(os.listdir(os.path.join(out, d)))
                  for d in ('tracking_vis', 'mapping_vis')}
        want = expected_panels(cfg, slam.n_img)
        size = list(panel_size(slam.intr.H, slam.intr.W))
        decoded = {f'{d}/{name}': list(read_color(
            os.path.join(out, d, name)).shape[:2])
            for d, names in panels.items() for name in names}
        live = os.path.join(out, 'live')
        with open(os.path.join(live, 'status.json')) as f:
            final = json.load(f)
        live_files = sorted(os.listdir(live))
        dashboard = {name: list(read_color(os.path.join(live, name)).shape)
                     for name in ('traj.png', 'mesh.png', 'panel.jpg')}
        _reset_launch_counts()
        t0 = time.perf_counter()
        frames = replay_tool.replay(cfg, out, stride=10, device='cuda')
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        replay_launches = _launch_counts()
    bit_equal = bool(np.array_equal(slam.estimate_c2w, accuracy_c2w))
    res.update(phase='services', config='configs/Synthetic/synthetic.yaml',
               options=SERVICES_VIS, poses_bit_equal_to_accuracy=bit_equal,
               panels=panels, expected_panels=want, panel_size=size,
               tracking_panel_s=slam.track_vis.timings,
               mapping_panel_s=slam.map_vis.timings,
               live_files=live_files, dashboard_shapes=dashboard,
               status_fetched_during_run=len(fetched),
               status_fetched_frames=sorted({s['frame'] for s in fetched}),
               final_status={k: final[k] for k in ('frame', 'n_img',
                                                   'pose_err_vs_gt_m')},
               replay_frames=len(frames), replay_s=replay_s,
               replay_launches=replay_launches)
    emit(res)
    if not bit_equal:
        raise AssertionError('the poses with panels and the dashboard '
                             'differ from the accuracy run')
    if panels != want:
        raise AssertionError(f'panels {panels}, the JAX rule {want}')
    bad = {k: v for k, v in decoded.items() if v != size}
    if bad or not decoded:
        raise AssertionError(f'panels not of the layout size {size}: {bad}')
    if not fetched:
        raise AssertionError('status.json was not served during the run')
    if (final['frame'], final['n_img']) != (slam.n_img - 1, slam.n_img):
        raise AssertionError(f'final status {final}')
    if live_files != ['index.html', 'mesh.png', 'panel.jpg', 'status.json',
                      'traj.png']:
        raise AssertionError(f'live/ holds {live_files}')
    if len(frames) != len(range(0, slam.n_img, 10)):   # 4 of 40 frames
        raise AssertionError(f'the replay wrote {len(frames)} frames')


def phase_pretrain() -> None:
    """Decoder pretraining at the tool's defaults, the blobs' round trip,
    and pretrained mode on an unseen room."""
    import numpy as np
    import torch
    from nice_slam_tpu_torch.models.decoders import init_nice_decoders
    from nice_slam_tpu_torch.models.pretrain import (
        load_torch_pretrain, save_torch_pretrain)
    from nice_slam_tpu_torch.tools._small_config import small_config
    from nice_slam_tpu_torch.tools.pretrain_decoders import train_decoders
    from nice_slam_tpu_torch.utils.config import decoder_config_from_cfg
    _reset_launch_counts()
    t0 = time.perf_counter()
    decs = train_decoders(device='cuda')
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = _launch_counts()
    with tempfile.TemporaryDirectory() as blobs:
        pre = {'coarse': os.path.join(blobs, 'coarse.pt'),
               'middle_fine': os.path.join(blobs, 'middle_fine.pt')}
        save_torch_pretrain(decs, pre['coarse'], pre['middle_fine'])
        fresh = init_nice_decoders(
            decoder_config_from_cfg(small_config()),
            generator=torch.Generator().manual_seed(99), device='cpu')
        load_torch_pretrain(fresh, pre, coarse=True)
        differ = [f'{name}.{k}' for name in ('middle', 'fine', 'coarse')
                  for k, v in decs[name].state_dict().items()
                  if not torch.equal(fresh[name].state_dict()[k],
                                     v.detach().cpu())]
        cfg = small_config(n_frames=9, h=60, w=80)
        cfg['synthetic']['box'] = PRETRAIN_TEST_BOX
        bound = (np.asarray(PRETRAIN_TEST_BOX)
                 + np.array([-0.3, 0.3])).tolist()
        cfg['mapping']['bound'] = bound
        cfg['mapping']['marching_cubes_bound'] = bound
        cfg['pretrained_decoders'] = pre
        cfg['mapping'].update(fix_fine=True, train_middle=False)
        cfg['tracking']['var_floor'] = 1.0e-10
        runs = []
        for seed in PRETRAIN_SEEDS:
            with tempfile.TemporaryDirectory() as out:
                res, slam = run_slam(cfg, out, seed=seed)
            err = np.linalg.norm(slam.estimate_c2w[:, :3, 3]
                                 - slam.gt_c2w[:, :3, 3], axis=-1)
            runs.append({'seed': seed, 'wall_s': res['wall_s'],
                         'launches': res['launches'],
                         'trainable': sorted(slam.trainable),
                         'max_err_m': float(err.max()),
                         'mean_err_m': float(err.mean()),
                         'last_err_m': float(err[-1]),
                         'frame_err_m': res['frame_err_m']})
    keys = ('max_err_m', 'mean_err_m', 'last_err_m')
    worst = [max(r[k] for r in runs) for k in keys]
    emit({'phase': 'pretrain', 'train_s': train_s,
          'train_launches': train_launches, 'blobs_bit_equal': not differ,
          'transfer': runs, 'worst_max_mean_last_m': worst,
          'bound_m': list(PRETRAIN_BOUND_M),
          'median_max_mean_last_m': [float(np.median([r[k] for r in runs]))
                                     for k in keys],
          'test_bars_m': list(PRETRAIN_TEST_BARS_M),
          'seeds_within_test_bars': [r['seed'] for r in runs if all(
              r[k] < b for k, b in zip(keys, PRETRAIN_TEST_BARS_M))]})
    if differ:
        raise AssertionError(f'reloaded blobs differ: {differ}')
    if any(r['trainable'] != ['color'] for r in runs):
        raise AssertionError('pretrained mode trains more than color')
    if not all(w <= b for w, b in zip(worst, PRETRAIN_BOUND_M)):
        raise AssertionError(f'pretrained transfer errors {worst} outside '
                             f'the JAX bound {PRETRAIN_BOUND_M}')


def phase_entry() -> None:
    """graft_entry: the forward step on the card against the CPU, and the
    parallel dry run."""
    import contextlib
    import io

    import torch
    from nice_slam_tpu_torch import graft_entry
    fn, args = graft_entry.entry()
    cpu_fn, cpu_args = graft_entry.entry(device='cpu')
    _reset_launch_counts()
    got = fn(*args)
    torch.cuda.synchronize()
    launches = _launch_counts()
    want = cpu_fn(*cpu_args)
    err = max(float((a.cpu() - b).abs().max())
              / max(1.0, float(b.abs().max())) for a, b in zip(got, want))
    n = torch.cuda.device_count()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        backend = (graft_entry.dryrun_multichip(n) if n >= 2 else
                   graft_entry.dryrun_multichip(2, share=True))
    lines = buf.getvalue().splitlines()
    res = {'phase': 'entry', 'rel_err': err, 'tolerance': ENTRY_TOL,
           'launches': launches,
           'dryrun': {'ranks': max(n, 2), 'backend': backend,
                      'shared_card': n < 2,
                      's': time.perf_counter() - t0, 'lines': lines}}
    emit(res)
    if not err <= ENTRY_TOL:
        raise AssertionError(f'entry() on the card off by {err}')
    if not (launches['expand_corners'] and launches['gather_rows']):
        raise AssertionError(f'entry() launched {launches}')
    if len(lines) != 4:
        raise AssertionError(f'dryrun_multichip printed {lines}')


# the bench phase: the port's measurement entry points, each run as a user
# runs it (python -m ...), its last stdout line parsed
BENCH_RUNS = (
    ('bench', ['nice_slam_tpu_torch.bench']),
    *((f'bench_budget {s}', ['nice_slam_tpu_torch.tools.bench_budget', s])
      for s in ('replica', 'scannet', 'tum', 'apartment')),
    # 10 mapping iterations a call (its default 100: the script's time;
    # 30 until the session_precision phase took its seconds)
    ('bench_imap', ['nice_slam_tpu_torch.tools.bench_imap', '10']),
    ('bench_sync_modes', ['nice_slam_tpu_torch.tools.bench_sync_modes', '5',
                          'strict', 'loose', 'free']))
# the figures that must be above 0 (every number must be finite)
BENCH_POSITIVE = ('value', 'vs_baseline', 'tracking_only_fps',
                  'track_ms_per_frame', 'map_iters_per_s', 'map_device_util',
                  'dispatch_ms', 'expand_gbps', 'expand_hbm_frac',
                  'track_s_per_frame', 'map_s_per_call', 'wall_s',
                  'fps_incl_compiles', 'ate_rmse_m', 'track_s', 'map_s',
                  'mesh_s')
BENCH_KERNELS = ('expand_corners', 'fold_corners', 'gather_rows',
                 'scatter_add_rows')
BENCH_TIMEOUT_S = 300
# the bench runs two at a time, the longest first (one after another on
# the H100 machine, PERF.md section 6: sync modes 58.8 s, bench 37.0, tum
# 30.2, scannet 21.5, bench_imap 19.8, apartment 18.7, replica 16.8)
BENCH_LANES = 2
BENCH_ORDER = ('bench_budget replica', 'bench_budget apartment',
               'bench_imap', 'bench_budget scannet', 'bench_budget tum',
               'bench', 'bench_sync_modes')


def _bench_run(module_args: list) -> tuple:
    """`python -m MODULE ARGS` from the checkout: (its JSON lines, its
    text lines, its stderr, seconds); raises when it fails."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, '-m', *module_args], cwd=REPO,
                         capture_output=True, text=True,
                         timeout=BENCH_TIMEOUT_S)
    if res.returncode != 0:
        raise AssertionError(f'{" ".join(module_args)} exited '
                             f'{res.returncode}:\n{res.stderr[-4000:]}')
    lines = res.stdout.strip().splitlines()
    rows = [json.loads(ln) for ln in lines if ln.startswith('{')]
    if not lines or not lines[-1].startswith('{'):
        raise AssertionError(f'{module_args[0]}: no JSON last line')
    return (rows, [ln for ln in lines if not ln.startswith('{')],
            res.stderr, time.perf_counter() - t0)


def _bench_faults(name: str, row: dict, card: str) -> list:
    """What is wrong with one result line: a number not finite, a figure
    not above 0, a device that is not the card, a row kernel of the NICE
    path not launched (the iMAP* path launches none)."""
    bad = [f'{name}: {k} = {v}' for k, v in row.items()
           if isinstance(v, (int, float)) and not isinstance(v, bool)
           and not math.isfinite(v)]
    bad += [f'{name}: {k} = {row[k]}' for k in BENCH_POSITIVE
            if k in row and not (isinstance(row[k], (int, float))
                                 and row[k] > 0)]
    if row.get('device') != card or 'H100' not in card:
        bad.append(f'{name}: device {row.get("device")!r}, card {card!r}')
    launched = [row['launches'][k] > 0 for k in BENCH_KERNELS]
    if name == 'bench_imap':
        if any(row['launches'].values()):
            bad.append(f'{name}: launches {row["launches"]}')
    elif not all(launched):
        bad.append(f'{name}: launches {row["launches"]}')
    return bad


def phase_bench() -> None:
    """The port's measurement entry points as a user runs them: bench.py;
    tools/bench_budget.py for replica, scannet, tum and apartment;
    tools/bench_imap.py 10; tools/bench_sync_modes.py 5 strict
    loose free.  Two processes at a time, the longest first (the
    script's time: 203 s one after another, PERF.md section 6), so their
    times share the card and the host and are not measurements (run the
    entry points alone for those).  Each result line printed; every
    number finite, the figures of BENCH_POSITIVE above 0, `device` this
    H100, the four row kernels of the NICE path launched (none on the
    iMAP* path), and the free row run as free with no fallback warning."""
    import torch
    from nice_slam_tpu_torch.utils.measure import card
    name_limit = card(torch.device('cuda', 0))
    torch.cuda.empty_cache()     # the card's memory to the entry points
    bad, seconds = [], {}
    with concurrent.futures.ThreadPoolExecutor(BENCH_LANES) as pool:
        runs = {name: pool.submit(_bench_run, args) for name, args in
                sorted(BENCH_RUNS, key=lambda r: -BENCH_ORDER.index(r[0]))}
        results = {name: fut.result() for name, fut in runs.items()}
    for name, _ in BENCH_RUNS:
        rows, text, err, sec = results[name]
        seconds[name] = sec
        for row in rows:
            emit({'phase': 'bench', 'run': name, **row})
            bad += _bench_faults(name, row, name_limit)
        if name == 'bench_imap' and len(text) != 2:
            bad.append(f'{name}: printed {text}')
        if name == 'bench_sync_modes':
            modes = [r['mode'] for r in rows]
            if modes != ['strict', 'loose', 'free'] or "'free'" in err:
                bad.append(f'{name}: ran {modes}, stderr {err[-400:]}')
    emit({'phase': 'bench', 'seconds': seconds})
    if bad:
        raise AssertionError(f'bench failed: {bad}')


# the measure phase: the JAX system's last measurement scripts, ported as
# tools/bench_demo, bench_imap_e2e, bench_fused_eval, profile_steps,
# profile_components, ablate_track_step, ablate_map_step and
# diagnose_strict, at full width with depth and repetitions cut (their
# full depths: scripts/port_measure_phases.py).  The two SLAM runs and the
# precision study as a user runs them (python -m, a process each), the
# short ones as calls of their main() in one more process; the four run at
# once, so their times
# share the card and the host and are not the measurements of PERF.md
MEASURE_RUNS = (
    # the Demo budget under loose to frame 59: the first map, rounds every
    # 5 frames, a 256^3 mesh at frame 50, the final mesh and the checkpoint
    ('bench_demo', ['nice_slam_tpu_torch.tools.bench_demo', '60']),
    ('bench_imap_e2e', ['nice_slam_tpu_torch.tools.bench_imap_e2e', '6']),
    # the decoder precision study: 10 mapping iterations a precision and a
    # 4-frame orbit (scripts/port_measure_phases.py: 60 and 8)
    ('bench_precision', ['nice_slam_tpu_torch.tools.bench_precision', '10',
                         '--orbit-frames', '4']))
# one repetition each (the script's limit of 1,050 s of 1,200: the
# phase is the four processes' longest, which these set unless cut)
MEASURE_SHORT = (
    ('bench_fused_eval', {'reps': 1}),
    ('profile_steps', {'track_frames': 1, 'map_calls': 1}),
    ('profile_components', {'n': 1}),
    ('ablate_track_step', {'reps': 1}),
    ('ablate_map_step', {'reps': 1}),
    # the first map and 2 frames unprofiled, then 3 under cProfile: a
    # tracked frame, and the last (mapped, meshed, checkpointed)
    ('diagnose_strict', {'n_frames': 6, 'warm': 3}))
# the row kernels each run must launch after its set-up (the lattice
# query's and the tracked frame's volumes are expanded before the counts
# start); the iMAP* path launches none
MEASURE_KERNELS = {
    'bench_demo': BENCH_KERNELS + ('fused_mlp',),
    'bench_imap_e2e': (),
    'bench_precision': BENCH_KERNELS,
    'bench_fused_eval': ('gather_rows', 'fused_mlp'),
    'profile_steps': BENCH_KERNELS,
    'profile_components': BENCH_KERNELS,
    'ablate_track_step': ('gather_rows',),
    'ablate_map_step': BENCH_KERNELS,
    'diagnose_strict': BENCH_KERNELS + ('fused_mlp',)}
MEASURE_TIMEOUT_S = 600
_MEASURE_SHORT_CHILD = """
import importlib, json, sys
for name, kwargs in json.loads(sys.argv[1]):
    row = importlib.import_module('nice_slam_tpu_torch.tools.' + name).main(
        **kwargs)
    print('MEASURE ' + json.dumps({'run': name, **row}), flush=True)
"""


def _numbers(obj):
    """Every int or float in a nested result (bools left out)."""
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _numbers(v)
    elif isinstance(obj, list):
        for v in obj:
            yield from _numbers(v)
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        yield obj


def _measure_faults(name: str, row: dict, card: str) -> list:
    """What is wrong with one entry point's result: a number not finite,
    a device that is not the card, a kernel of its path not launched (on
    the iMAP* path one launched), a gate of its own failed."""
    bad = [f'{name}: not finite'] if not all(
        math.isfinite(v) for v in _numbers(row)) else []
    if row.get('device') != card or 'H100' not in card:
        bad.append(f'{name}: device {row.get("device")!r}, card {card!r}')
    want = MEASURE_KERNELS[name]
    launches = row['launches']
    if (not all(launches.get(k, 0) > 0 for k in want)
            or (not want and any(launches.values()))):
        bad.append(f'{name}: launches {launches}')
    checks = {
        'bench_demo': lambda r: (r['mode'] == 'loose'
                                 and r['frames_tracked'] == 60
                                 and r['meshes'] == 2
                                 and r['checkpoints'] == 1
                                 and r['peak_mem_gb'] > 0),
        'bench_imap_e2e': lambda r: (r['frames_tracked'] == 6
                                     and r['peak_mem_gb'] > 0),
        'bench_precision': lambda r: (
            set(r['imap']) == set(r['orbit']) == {
                'float32', 'BF16_BF16_F32_X3', 'bfloat16'}
            and min(v['iters_per_s'] for v in r['imap'].values()) > 0
            and r['orbit_frames'] == 4 and r['peak_mem_gb'] > 0),
        'bench_fused_eval': lambda r: (r['agree'] and r['resolution'] == 256
                                       and r['peak_mem_gb'] > 0),
        'ablate_track_step': lambda r: (r['full_matches_production']
                                        and len(r['cases']) == 6),
        'ablate_map_step': lambda r: (r['full_matches_production']
                                      and len(r['cases']) == 7),
        'diagnose_strict': lambda r: len(r['top']) > 0}
    try:
        passed = checks[name](row) if name in checks else True
    except KeyError as key:
        passed = False
        bad.append(f'{name}: no {key} in its result')
    if not passed:
        bad.append(f'{name}: its gate failed')
    return bad


def start_measure() -> dict:
    """Start the four processes of the measure phase (MEASURE_RUNS, and
    MEASURE_SHORT in one process); each writes to files of its own, so
    none waits on a full pipe.  `finish_measure` collects them."""
    tmp = tempfile.TemporaryDirectory(prefix='measure_')
    cmds = {name: [sys.executable, '-m', *args]
            for name, args in MEASURE_RUNS}
    cmds['short'] = [sys.executable, '-c', _MEASURE_SHORT_CHILD,
                     json.dumps(MEASURE_SHORT)]
    files = {name: (open(os.path.join(tmp.name, f'{name}.out'), 'w+'),
                    open(os.path.join(tmp.name, f'{name}.err'), 'w+'))
             for name in cmds}
    procs = {name: subprocess.Popen(cmd, cwd=REPO, stdout=files[name][0],
                                    stderr=files[name][1], text=True)
             for name, cmd in cmds.items()}
    return {'tmp': tmp, 'files': files, 'procs': procs,
            't0': time.perf_counter()}


def stop_measure(run: dict) -> None:
    """Kill what is left of a started measure phase and drop its files."""
    for name, proc in run['procs'].items():
        proc.kill()
        proc.wait()
        for f in run['files'][name]:
            f.close()
    run['tmp'].cleanup()


def finish_measure(run: dict) -> None:
    """Wait for the measure phase's processes; each result line printed
    (the cProfile table cut to its first five calls), and every run held
    to _measure_faults."""
    import torch
    from nice_slam_tpu_torch.utils.measure import card
    name_limit = card(torch.device('cuda', 0))
    outs, seconds = {}, {}
    try:
        for name, proc in run['procs'].items():
            proc.wait(timeout=max(1.0, MEASURE_TIMEOUT_S
                                  - (time.perf_counter() - run['t0'])))
            seconds[name] = time.perf_counter() - run['t0']
            for f in run['files'][name]:
                f.seek(0)
            out, err = (f.read() for f in run['files'][name])
            if proc.returncode != 0:
                raise AssertionError(f'measure {name} exited '
                                     f'{proc.returncode}:\n{err[-4000:]}')
            outs[name] = out
    finally:
        stop_measure(run)
    rows = {name: json.loads(outs[name].strip().splitlines()[-1])
            for name, _ in MEASURE_RUNS}
    for ln in outs['short'].splitlines():
        if ln.startswith('MEASURE '):
            row = json.loads(ln[len('MEASURE '):])
            rows[row.pop('run')] = row
    missing = [n for n in MEASURE_KERNELS if n not in rows]
    bad = [f'no result from {missing}'] if missing else []
    for name, row in rows.items():
        shown = dict(row, top=row['top'][:5]) if 'top' in row else row
        emit({'phase': 'measure', 'run': name, **shown})
        bad += _measure_faults(name, row, name_limit)
    emit({'phase': 'measure', 'seconds': seconds})
    if bad:
        raise AssertionError(f'measure failed: {bad}')


def _entry(row, name, source, replaces, launches, err, ms, plain_ms,
           bound_ms, library_ms, shape, bound_by='bytes', **extra):
    return {'row': row, 'name': name, 'route': 'cuda',
            'source': f'nice_slam_tpu_torch/csrc/{source}',
            'replaces': replaces, 'launches': launches, 'max_abs_err': err,
            'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
            'bound_by': bound_by, 'library_ms': library_ms, 'shape': shape,
            **extra}


def kernel_table(kern: dict, mlp: dict, room0: dict, gather: dict,
                 roof: dict, mlp_bf16: dict, session: dict) -> list:
    """One entry per TPU function that reaches pl.pallas_call (rows 1-11
    of PERF.md's table; row 10's three bodies one entry each; row 5 one
    entry per mode of its kernel), plus the gather's backward.  Launches
    are the room0 run's, the probes' those of the roofline study, the
    fused MLP's bf16 modes those of the session_precision runs.
    measured_bound_ms: the bytes over the measured
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

    def bf16_row(prec):
        m = mlp_bf16[prec]
        f = m['main_shapes']['fine']
        return _entry(f'5 {m["mode"].split("_")[-1]}', m['mode'],
                      'fused_mlp.cu', pal + 'fused_mlp.py:90',
                      session[prec]['launches'][m['mode']], m['max_abs_err'],
                      f['ms'], f['plain_ms'], f['bound_ms'], None,
                      f'fine decoder, {POINTS_BATCH} points, c 64, '
                      f'matmul precision {prec} ({m["passes"]} bf16 pass'
                      f'{"es" if m["passes"] > 1 else ""})',
                      bound_by=f['bound_by'],
                      bytes_bound_ms=f['bytes_bound_ms'],
                      others={k: {x: m['main_shapes'][k][x] for x in (
                          'ms', 'plain_ms', 'bound_ms')}
                          for k in ('middle', 'color')})

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
        *(bf16_row(prec) for prec in BF16_MODES),
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
    ap = argparse.ArgumentParser(description='Chip smoke test of the '
                                 'PyTorch/CUDA port on one GPU.')
    ap.add_argument('--ab-parent', metavar='DIR',
                    help="time the fused MLP against another tree's "
                    "(DIR holds that tree's ops/fused_mlp.py and "
                    'csrc/fused_mlp.cu) after the kernels phase')
    # a rank of the parallel phases (started by this script, NSTPU_* set)
    ap.add_argument('--rank-task',
                    choices=('parity', 'tum', 'loose_room0', 'loose',
                             'loose_c1'),
                    help=argparse.SUPPRESS)
    ap.add_argument('--out', help=argparse.SUPPRESS)
    ap.add_argument('--input', help=argparse.SUPPRESS)
    ap.add_argument('--output-dir', help=argparse.SUPPRESS)
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
    if args.rank_task:
        return run_rank_task(args.rank_task, args.out, args)
    seconds = {}
    measure = None
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
        mlp_bf16 = phase_fused_mlp_bf16()
        phase_model_parity()
        phase_precision()
        lap('kernels')
        phase_formats()
        lap('formats')
        if args.ab_parent:
            phase_mlp_ab(args.ab_parent)
            lap('fused_mlp_ab')
        gather = phase_gather()
        lap('gather')
        roof = phase_roofline()
        lap('roofline')
        accuracy_c2w = phase_accuracy()
        lap('accuracy')
        session = phase_session_precision()
        lap('session_precision')
        phase_disk_accuracy()
        lap('disk_accuracy')
        with tempfile.TemporaryDirectory() as out:
            room0, slam, real = phase_room0(out)
            lap('room0')
            phase_render(slam)
        del slam
        lap('render')
        gather.update(phase_real_index(real))
        del real
        lap('real_index')
        phase_disk_room0(room0)
        lap('disk_room0')
        loose_room0 = phase_overlap(room0)
        lap('overlap')
        phase_imap_accuracy()
        lap('imap_accuracy')
        phase_imap_room0()
        lap('imap_room0')
        phase_parallel_parity()
        lap('parallel_parity')
        with tempfile.TemporaryDirectory() as root:
            data, write_s = write_tum(root)
            tum_one, tum_strict = phase_parallel_tum(root, data, write_s)
            lap('parallel_tum')
            phase_parallel_loose(root, data, tum_one, tum_strict)
            lap('parallel_loose')
        phase_pipeline(room0, loose_room0)
        lap('pipeline')
        # the measure phase's processes run beside the next three phases,
        # whose gates are bits and files, not times (the script's time
        # limit); their times are not measurements while it runs
        measure = start_measure()
        phase_services(accuracy_c2w)
        lap('services')
        phase_pretrain()
        lap('pretrain')
        phase_entry()
        lap('entry')
        finish_measure(measure)
        measure = None
        lap('measure')
        phase_bench()
        lap('bench')
        if any(k in sys.modules for k in ('jax', 'nice_slam_tpu')):
            raise AssertionError('the JAX package was imported')
    except Exception:
        traceback.print_exc()
        if measure is not None:
            stop_measure(measure)
        return 1
    emit({'phase': 'seconds', **seconds})
    emit({'kernels': kernel_table(kern, mlp, room0, gather, roof, mlp_bf16,
                                  session)})
    print(card, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
