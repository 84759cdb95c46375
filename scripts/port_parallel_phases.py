"""The parallel phases of chip_smoke.py alone, on the GPUs this machine
has: the build, then parallel_parity, parallel_tum and parallel_loose (two
ranks sharing the card on one GPU, one rank a card on more); with two or
more cards also the strict and loose room0 runs without meshes and the
pipeline phase (the loose run on the two-device pipeline beside one
card).  `--phases parallel_loose` runs the build and that phase alone
(with parallel_tum before it, whose runs it is compared with).
`--phases loose_c1` runs check C1, which no default phase runs:
synthetic.yaml under loose with parallel: {track: rays, map: kf} and with
{track: rays} alone, on the ranks (chip_smoke.phase_loose_c1).

    python scripts/port_parallel_phases.py [--phases P ...]

Prints chip_smoke.py's JSON lines of those phases and each phase's
seconds; exits 1 if a phase fails.  A cheaper call than the whole script
when only the parallel backends changed.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

PHASES = ('parallel_parity', 'parallel_tum', 'parallel_loose', 'pipeline')


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--phases', nargs='+', default=PHASES,
                    choices=PHASES + ('loose_c1',))
    phases = ap.parse_args().phases
    if not torch.cuda.is_available():
        print('port_parallel_phases: no CUDA device', file=sys.stderr)
        return 2
    os.chdir(cs.REPO)
    t0 = time.perf_counter()

    def timed(name, phase, *args):
        t = time.perf_counter()
        out = phase(*args)
        print(f'{name} {time.perf_counter() - t:.1f} s', flush=True)
        return out

    try:
        print(cs.phase_card(), flush=True)
        cs.phase_build()
        if 'parallel_parity' in phases:
            timed('parallel_parity', cs.phase_parallel_parity)
        if 'parallel_tum' in phases or 'parallel_loose' in phases:
            with tempfile.TemporaryDirectory() as root:
                data, write_s = cs.write_tum(root)
                one, strict = timed('parallel_tum', cs.phase_parallel_tum,
                                    root, data, write_s)
                if 'parallel_loose' in phases:
                    timed('parallel_loose', cs.phase_parallel_loose, root,
                          data, one, strict)
        if 'loose_c1' in phases:
            timed('loose_c1', cs.phase_loose_c1)
        if 'pipeline' in phases and torch.cuda.device_count() >= 2:
            with tempfile.TemporaryDirectory() as out:
                strict, _ = cs.run_slam(cs.room0_cfg(), out, mesh=False)
            cs.phase_pipeline(strict, cs.phase_overlap(strict))
        elif 'pipeline' in phases:
            cs.phase_pipeline({}, {})
    except Exception:
        traceback.print_exc()
        return 1
    print(f'total {time.perf_counter() - t0:.1f} s')
    return 0


if __name__ == '__main__':
    sys.exit(main())
