"""The services phases of chip_smoke.py alone, on one GPU: the build, the
accuracy run (the services phase's reference poses), then services
(render panels, live dashboard, replay), pretrain (decoder pretraining and
pretrained mode on an unseen room) and entry (graft_entry's forward step
and the parallel dry run), or those named by --phases (the accuracy run
only with services); with --room0 also the room0 run and the render phase
with its 680x1200 panel.

    python scripts/port_services_phases.py [--room0] \
        [--phases services pretrain entry]

Prints chip_smoke.py's JSON lines of those phases and each phase's
seconds; exits 1 if a phase fails.  A cheaper call than the whole script
when only the services changed.
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

PHASES = ['services', 'pretrain', 'entry']


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--room0', action='store_true',
                    help='also the room0 run and its render phase')
    ap.add_argument('--phases', nargs='+', default=PHASES, choices=PHASES,
                    help='the phases to run, in this order (default: all)')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('port_services_phases: no CUDA device', file=sys.stderr)
        return 2
    os.chdir(cs.REPO)
    t0 = time.perf_counter()

    def lap(name, t):
        torch.cuda.synchronize()
        print(f'{name} {time.perf_counter() - t:.1f} s', flush=True)
        return time.perf_counter()

    try:
        print(cs.phase_card(), flush=True)
        t = time.perf_counter()
        cs.phase_build()
        t = lap('build', t)
        if 'services' in args.phases:
            accuracy_c2w = cs.phase_accuracy()
            t = lap('accuracy', t)
        if args.room0:
            with tempfile.TemporaryDirectory() as out:
                _, slam, _ = cs.phase_room0(out)
                t = lap('room0', t)
                cs.phase_render(slam)
            del slam
            t = lap('render', t)
        for name in args.phases:
            if name == 'services':
                cs.phase_services(accuracy_c2w)
            else:
                getattr(cs, f'phase_{name}')()
            t = lap(name, t)
    except Exception:
        traceback.print_exc()
        return 1
    print(f'total {time.perf_counter() - t0:.1f} s')
    return 0


if __name__ == '__main__':
    sys.exit(main())
