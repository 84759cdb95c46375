"""The port's measurement scripts at their full depths on the GPU, one
after another, each as a user runs it (`python -m`, a process of its own);
beside scripts/port_parallel_phases.py.

    python scripts/port_measure_phases.py [--runs NAME ...] [--out DIR]

The runs (all by default):
  demo_loose, demo_strict, demo_loose_pretrained, demo_strict_pretrained
      tools.bench_demo at 500 frames under loose and under strict, from
      scratch and with --pretrained, at the JAX script's seed 0;
  demo_loose_seed4, demo_strict_seed4
      from scratch at seed 4 (the port's seed 0 draws a model whose
      first-frame map leaves the fine decoder untrained, in the JAX
      package too: ROADMAP section 3);
  imap_e2e        tools.bench_imap_e2e at 40 frames (bfloat16 decoder
                  products, as the JAX script sets them);
  precision       tools.bench_precision at the JAX script's depth (60
                  mapping iterations a precision, an 8-frame orbit);
  fused_eval      tools.bench_fused_eval at 256^3;
  ablate_track, ablate_map, profile_steps, profile_components,
  diagnose_strict
      at the JAX scripts' repetitions (diagnose_strict 40 frames).
Each run's output is written to DIR/NAME.txt (default
build/measure_phases/, in the checkout's git-ignored build directory); its
JSON last line and seconds are printed.  Exits 1 if a run failed (the
others still run).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 'nice_slam_tpu_torch.tools.'
RUNS = {
    'demo_loose': [T + 'bench_demo', '500', '--sync=loose'],
    'demo_strict': [T + 'bench_demo', '500', '--sync=strict'],
    'demo_loose_pretrained': [T + 'bench_demo', '500', '--sync=loose',
                              '--pretrained'],
    'demo_strict_pretrained': [T + 'bench_demo', '500', '--sync=strict',
                               '--pretrained'],
    'demo_loose_seed4': [T + 'bench_demo', '500', '--sync=loose',
                         '--seed', '4'],
    'demo_strict_seed4': [T + 'bench_demo', '500', '--sync=strict',
                          '--seed', '4'],
    'imap_e2e': [T + 'bench_imap_e2e', '40'],
    'precision': [T + 'bench_precision', '60', '--orbit-frames', '8'],
    'fused_eval': [T + 'bench_fused_eval', '256'],
    'ablate_track': [T + 'ablate_track_step'],
    'ablate_map': [T + 'ablate_map_step'],
    'profile_steps': [T + 'profile_steps'],
    'profile_components': [T + 'profile_components'],
    'diagnose_strict': [T + 'diagnose_strict', '40'],
}
RUN_TIMEOUT_S = 1200


def run(name: str, out: str) -> bool:
    t0 = time.perf_counter()
    try:
        res = subprocess.run([sys.executable, '-m', *RUNS[name]], cwd=REPO,
                             capture_output=True, text=True,
                             timeout=RUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        print(f'{name}: timed out after {RUN_TIMEOUT_S} s', flush=True)
        return False
    sec = time.perf_counter() - t0
    with open(os.path.join(out, f'{name}.txt'), 'w') as f:
        f.write(res.stdout + '\n--- stderr ---\n' + res.stderr)
    lines = res.stdout.strip().splitlines()
    if res.returncode != 0 or not lines or not lines[-1].startswith('{'):
        print(f'{name}: exited {res.returncode} in {sec:.1f} s\n'
              f'{res.stderr[-3000:]}', flush=True)
        return False
    row = json.loads(lines[-1])
    row.pop('top', None)        # diagnose_strict's table: in the file
    print(json.dumps({'run': name, 'seconds': sec, **row}), flush=True)
    return True


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--runs', nargs='+', choices=tuple(RUNS),
                    default=tuple(RUNS))
    ap.add_argument('--out', default=os.path.join(REPO, 'build',
                                                  'measure_phases'),
                    help="the runs' output files (default build/"
                    'measure_phases)')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('port_measure_phases: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    try:
        print(cs.phase_card(), flush=True)
        cs.phase_build()
    except Exception:
        traceback.print_exc()
        return 1
    failed = [name for name in args.runs if not run(name, args.out)]
    print(f'total {time.perf_counter() - t0:.1f} s; failed {failed}',
          flush=True)
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main())
