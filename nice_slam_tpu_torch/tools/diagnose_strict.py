"""Where a strict session's host time goes, by cProfile, on the card; the
port's `scripts/diagnose_strict.py`.

    python -m nice_slam_tpu_torch.tools.diagnose_strict [n_frames] \
        [--device cuda|cpu]

Runs a short strict session (default 40 frames) at the budget of the
sync-mode bench (`tools/bench_sync_modes.mode_config`: the test scene at
680x1200, 200 px x 10 tracking iterations, 1000 px x 60 mapping
iterations every 5 frames over a window of 5, 400 first, 32 + 16 samples,
a 128^3 final mesh) frame by frame through `SlamSystem.step`.  The first
12 frames run outside the profile (the first map, the kernels' first
calls); the rest run under cProfile.  Prints each frame's seconds with the
mapping seconds so far, the profiled frames' wall and
`PhaseTimers.summary()`, and the 35 host calls of the largest cumulative
time.  On the card the calls where the host waits for the device
(`.item()`, `synchronize`, copies to the host) are expected near the top:
that is what the profile shows of a host that launches work and then
waits for it, not a fault.

Then one JSON line: the frames' seconds, the profiled wall, the summary,
the top calls (function, calls, cumulative and own seconds), the card
(`device`), each row kernel's launches over the run (`launches`) and the
peak device memory (`peak_mem_gb`, None on the CPU).  The run's output
goes to a temporary directory.

Left out as TPU machinery: the compile cache and the compile log.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import tempfile
import time

from nice_slam_tpu_torch.engine.slam import SlamSystem, resolve_device
from nice_slam_tpu_torch.tools.bench_sync_modes import mode_config
from nice_slam_tpu_torch.utils import measure

WARM_FRAMES = 12
TOP = 35


def top_calls(prof: cProfile.Profile, n: int = TOP) -> list:
    """The n calls of the largest cumulative time: [{'function', 'calls',
    'cum_s', 'own_s'}]."""
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: kv[1][3], reverse=True)
    return [{'function': pstats.func_std_string(func), 'calls': nc,
             'cum_s': ct, 'own_s': tt}
            for func, (_, nc, tt, ct, _) in rows[:n]]


def main(n_frames: int = 40, device=None, *, warm: int = WARM_FRAMES,
         **sizes) -> dict:
    """Run the session; prints the frames, the profile's table and
    returns the JSON line's object.  `warm` and `sizes` (h, w, and
    `update`, a config laid over the script's) exist for the CPU tests and
    the chip smoke test; the defaults are the JAX script's."""
    dev = resolve_device(device)
    cfg = mode_config('strict', n_frames, **sizes)
    measure.build_kernels(dev)
    measure.reset_launch_counts()
    measure.reset_peak(dev)
    frames = []

    def step(slam, idx):
        t1 = time.perf_counter()
        slam.step(idx)
        sec = time.perf_counter() - t1
        map_s = slam.timers.summary()['map_s']
        print(f'frame {idx}: {sec:.2f} s map_s={map_s:.1f}', flush=True)
        frames.append(sec)

    with tempfile.TemporaryDirectory(prefix='diag_strict_') as out:
        slam = SlamSystem(cfg, nice=True, device=dev, output=out,
                          verbose=False)
        t0 = time.perf_counter()
        for idx in range(warm):
            step(slam, idx)
        warm_s = time.perf_counter() - t0
        print(f'warmup {warm} frames: {warm_s:.1f} s', flush=True)
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        for idx in range(warm, n_frames):
            step(slam, idx)
        prof.disable()
        wall = time.perf_counter() - t0
        slam.join_mesh()
    summary = slam.timers.summary()
    print(f'profiled {n_frames - warm} frames: {wall:.1f} s ({summary})',
          flush=True)
    s = io.StringIO()
    pstats.Stats(prof, stream=s).sort_stats('cumulative').print_stats(TOP)
    print(s.getvalue(), flush=True)
    return {'metric': 'diagnose_strict', 'frames': n_frames,
            'warm_frames': warm, 'frame_s': frames, 'warm_s': warm_s,
            'profiled_s': wall, **summary, 'top': top_calls(prof),
            'device': measure.card(dev),
            'launches': measure.launch_counts(),
            'peak_mem_gb': measure.peak_mem_gb(dev)}


def cli(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="A short strict session's host calls by cProfile; "
        'prints the table and one JSON line.')
    ap.add_argument('n_frames', nargs='?', type=int, default=40)
    ap.add_argument('--device', default=None, help='cuda (default) or cpu')
    args = ap.parse_args(argv)
    print(json.dumps(main(args.n_frames, args.device)), flush=True)


if __name__ == '__main__':
    cli()
