"""Where the time goes in the port at room0's full width: a torch.profiler
trace of one tracked frame and one normal mapping call on the GPU.

    python scripts/port_profile_room0.py [--out build/profile_room0] [--imap]

configs/Replica/room0.yaml as loaded (pretrained decoders, 680x1200, grid
shapes, budgets) on the analytic synthetic scene.  Set-up, not profiled:
frame 0 is tracked and mapped with the first-frame map cut to 60
iterations (the trace is of steady-state calls, whose cost does not depend
on how well the first map fit).  Profiled: tracking frame 1 (10 iterations)
and one normal mapping call at frame 1 (60 iterations), each after one
warm-up call of the same kind.  Prints one JSON line: wall time of each
profiled call, the device-busy share (union of kernel intervals over the
wall time), the kernel count, the top operations by device time and the
row kernels' launches; then, from one more mapping call outside the
profiler, the index distribution the scatter kernel sees (per table: calls,
points, distinct rows, longest segment) and the scatter's time on the last
index of each table beside index_add_ and index_put_ with accumulate;
writes the key_averages tables under --out.

--imap profiles iMAP* instead: configs/Replica/room0_imap.yaml over
configs/imap.yaml (680x1200, 5000 px x 50 tracking iterations, 5000 px x
300 mapping iterations as 3 outer x 100, hidden 256) on the same scene,
the first map cut to 60 iterations; profiled are tracking frame 1 and one
normal mapping call at frame 1, and the line adds each call's FP32-core
bound: the decoder MLP's multiply-adds for the points the call decodes
(forward, and the backward's input gradients, plus its weight gradients
in mapping) over the H100's 67 TFLOP/s FP32 rate (data sheet; TF32 stays
off).  There is no scatter to record; instead the line adds the wall time
of the last frame's color refine (5 x 300 iterations on a window of 10),
tracked and mapped after the profiled calls, outside the profiler.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


FP32_FLOP_PER_S = 67e12        # H100 SXM FP32 without tensor cores


def imap_mlp_macs(dcfg) -> int:
    """Multiply-adds of the iMAP* decoder per point: p @ B, the dense
    layers and the 4-wide head (Fourier embedding of 93)."""
    h = dcfg.imap_hidden
    return 3 * 93 + 93 * h + (dcfg.imap_blocks - 1) * h * h + h * 4


def imap_bounds_ms(slam) -> dict:
    """FP32-core bounds of one tracked frame and one normal mapping call:
    tracking decodes pixels x (n_samples + n_importance) points an
    iteration, forward and the input-gradient backward (2x); mapping also
    decodes the regulation's n_samples per pixel, with the weight
    gradients too (3x)."""
    rc, tc, mc = slam.rcfg, slam.tcfg, slam.mcfg
    macs = imap_mlp_macs(slam.dcfg)
    track_pts = tc.pixels * (rc.n_samples + rc.n_importance) * tc.iters
    map_pts = mc.pixels * (2 * rc.n_samples + rc.n_importance) \
        * (mc.iters // 3) * 3
    flop = lambda pts, passes: 2.0 * macs * pts * passes
    return {'mlp_macs_per_point': macs,
            'track_frame_fp32_bound_ms': flop(track_pts, 2)
            / FP32_FLOP_PER_S * 1e3,
            'map_call_fp32_bound_ms': flop(map_pts, 3)
            / FP32_FLOP_PER_S * 1e3}


def busy_share(events, wall_us: float) -> tuple[float, int]:
    """Union of device kernel intervals over the wall time, and the number
    of kernels."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type.name == 'CUDA')
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / wall_us, len(spans)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('--out', default='build/profile_room0')
    ap.add_argument('--imap', action='store_true',
                    help='profile iMAP* on room0_imap.yaml')
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from nice_slam_tpu_torch.engine.slam import SlamSystem
    from nice_slam_tpu_torch.ops import gather as ga
    from nice_slam_tpu_torch.utils.config import load_config

    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA device')
    os.makedirs(args.out, exist_ok=True)
    if args.imap:
        cfg = load_config('configs/Replica/room0_imap.yaml',
                          'configs/imap.yaml')
    else:
        cfg = load_config('configs/Replica/room0.yaml',
                          'configs/nice_slam.yaml')
    cfg['dataset'] = 'synthetic'
    cfg['synthetic'] = {'n_frames': 3, 'radius': 0.8, 'step': 0.02,
                        'noise': 0.003,
                        'box': [[-2.8, 8.8], [-3.1, 5.4], [-3.4, 3.2]]}
    cfg['verbose'] = False
    cfg['mapping']['iters_first'] = 60
    slam = SlamSystem(cfg, nice=not args.imap, device='cuda', seed=0,
                      output=os.path.join(args.out, 'run'))
    slam.step(0)
    frame = slam.frame_reader[1]

    def track():
        slam.track(1, *frame[1:])

    def map_call():
        slam.map_frame(1, *frame[1:])

    out = {'gpu': torch.cuda.get_device_name(0),
           'method': 'imap' if args.imap else 'nice'}
    if args.imap:
        out.update(imap_bounds_ms(slam))
    for name, fn in (('track_frame', track), ('map_call', map_call)):
        fn()                                   # warm-up
        torch.cuda.synchronize()
        ga.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        share, n_kernels = busy_share(prof.events(), wall * 1e6)
        avg = prof.key_averages()
        top = sorted((e for e in avg if e.device_time_total > 0),
                     key=lambda e: -e.device_time_total)[:12]
        out[name] = {
            'wall_ms': wall * 1e3, 'device_busy_share': share,
            'device_busy_ms': share * wall * 1e3,
            'kernels': n_kernels, 'row_kernel_launches': dict(ga.LAUNCHES),
            'top_device_ms': [[e.key[:60], e.device_time_total / 1e3,
                               e.count] for e in top]}
        with open(os.path.join(args.out, f'{name}.txt'), 'w') as f:
            f.write(avg.table(sort_by='device_time_total', row_limit=40))
    if args.imap:
        out['refine_call_ms'] = refine_ms(slam)
    else:
        out['scatter_index'] = index_distribution(ga, map_call)
    print(json.dumps(out))


def refine_ms(slam) -> float:
    """Track the last frame, then time its mapping call, the color refine
    (wall clock, synchronized)."""
    import torch
    idx = slam.n_img - 1
    frame = slam.frame_reader[idx]
    slam.track(idx, *frame[1:])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam.map_frame(idx, *frame[1:])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if slam.timers.maps[-1][1] != 'refine':
        raise AssertionError('the last mapping call was not a color refine')
    return ms


def index_distribution(ga, map_call) -> dict:
    """Run map_call with the scatter wrapper recording, per call, the
    table's rows, the points, the distinct rows hit and the longest
    segment (the most points on one row); summarized per table shape.
    Then, on the last index of each table and a random gradient, the
    scatter's time (CUDA events) beside index_add_ into zeros and
    index_put_ with accumulate, and whether it equals the latter's bits."""
    import statistics
    import torch
    from chip_smoke import cuda_ms
    seen, last = {}, {}
    scatter = ga.scatter_add_rows

    def recording(grad, idx, m):
        seg = torch.bincount(idx, minlength=m)
        key = f'[{m}, {grad.shape[1]}]'
        seen.setdefault(key, []).append(
            (idx.shape[0], int((seg > 0).sum()), int(seg.max())))
        last[key] = (m, grad.shape[1], idx)
        return scatter(grad, idx, m)

    ga.scatter_add_rows = recording
    try:
        map_call()
        torch.cuda.synchronize()
    finally:
        ga.scatter_add_rows = scatter
    out = {}
    gen = torch.Generator(device='cuda').manual_seed(0)
    for table, v in seen.items():
        m, w, idx = last[table]
        grad = torch.randn((idx.shape[0], w), generator=gen, device='cuda')
        put = torch.zeros((m, w), device='cuda').index_put_(
            (idx,), grad, accumulate=True)
        out[table] = {
            'calls': len(v), 'points': sorted({n for n, _, _ in v}),
            'distinct_rows_median': statistics.median(d for _, d, _ in v),
            'longest_segment_median': statistics.median(s for _, _, s in v),
            'longest_segment_max': max(s for _, _, s in v),
            'last_index_scatter_ms': cuda_ms(
                lambda: ga.scatter_add_rows(grad, idx, m)),
            'last_index_index_add_ms': cuda_ms(
                lambda: ga.scatter_add_rows_plain(grad, idx, m)),
            'last_index_index_put_accumulate_ms': cuda_ms(
                lambda: torch.zeros((m, w), device='cuda').index_put_(
                    (idx,), grad, accumulate=True)),
            'last_index_bit_equal_index_put': bool(torch.equal(
                ga.scatter_add_rows(grad, idx, m), put))}
    return out


if __name__ == '__main__':
    main()
