"""Where the time goes in the port at room0's full width: a torch.profiler
trace of one tracked frame and one normal mapping call on the GPU.

    python scripts/port_profile_room0.py [--out build/profile_room0]

configs/Replica/room0.yaml as loaded (pretrained decoders, 680x1200, grid
shapes, budgets) on the analytic synthetic scene.  Set-up, not profiled:
frame 0 is tracked and mapped with the first-frame map cut to 60
iterations (the trace is of steady-state calls, whose cost does not depend
on how well the first map fit).  Profiled: tracking frame 1 (10 iterations)
and one normal mapping call at frame 1 (60 iterations), each after one
warm-up call of the same kind.  Prints one JSON line: wall time of each
profiled call, the device-busy share (union of kernel intervals over the
wall time), the kernel count, and the top operations by device time;
writes the key_averages tables under --out.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


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
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from nice_slam_tpu_torch.engine.slam import SlamSystem
    from nice_slam_tpu_torch.utils.config import load_config

    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA device')
    os.makedirs(args.out, exist_ok=True)
    cfg = load_config('configs/Replica/room0.yaml', 'configs/nice_slam.yaml')
    cfg['dataset'] = 'synthetic'
    cfg['synthetic'] = {'n_frames': 3, 'radius': 0.8, 'step': 0.02,
                        'noise': 0.003,
                        'box': [[-2.8, 8.8], [-3.1, 5.4], [-3.4, 3.2]]}
    cfg['verbose'] = False
    cfg['mapping']['iters_first'] = 60
    slam = SlamSystem(cfg, device='cuda', seed=0,
                      output=os.path.join(args.out, 'run'))
    slam.step(0)
    frame = slam.frame_reader[1]

    def track():
        slam.track(1, *frame[1:])

    def map_call():
        slam.map_frame(1, *frame[1:])

    out = {'gpu': torch.cuda.get_device_name(0)}
    for name, fn in (('track_frame', track), ('map_call', map_call)):
        fn()                                   # warm-up
        torch.cuda.synchronize()
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
            'kernels': n_kernels,
            'top_device_ms': [[e.key[:60], e.device_time_total / 1e3,
                               e.count] for e in top]}
        with open(os.path.join(args.out, f'{name}.txt'), 'w') as f:
            f.write(avg.table(sort_by='device_time_total', row_limit=40))
    print(json.dumps(out))


if __name__ == '__main__':
    main()
