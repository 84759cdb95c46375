"""The precision phases of chip_smoke.py alone, on one GPU: the bfloat16
products against their plain version (phase precision), then the two
iMAP* phases (imap_accuracy, imap_room0) at each decoder precision named,
one after another, so that the float32 path (as before the key was
honoured) and imap.yaml's bfloat16 run in one call on one card; then
session_accuracy: synthetic.yaml as shipped (40 frames, the 128^3 mesh)
under each session-wide `matmul_precision` named, held to the JAX
package's seeds under the TPU's rule (chip_smoke.SESSION_WORST).

    python scripts/port_precision_phases.py \
        [--phases precision imap_accuracy imap_room0 session_accuracy] \
        [--precisions float32 bfloat16 bfloat16 float32] \
        [--session-precisions bfloat16 tensorfloat32]

Prints chip_smoke.py's JSON lines of those phases and each phase's seconds
with its precision; exits 1 if a phase fails (its gates are chip_smoke.py's
at every precision).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

PHASES = ['precision', 'imap_accuracy', 'imap_room0', 'session_accuracy']


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--phases', nargs='+', default=PHASES, choices=PHASES,
                    help='the phases to run, in this order (default: all)')
    ap.add_argument('--precisions', nargs='+',
                    default=['float32', 'bfloat16', 'bfloat16', 'float32'],
                    help='the decoder precisions of the iMAP* phases, in '
                    'turn')
    ap.add_argument('--session-precisions', nargs='+',
                    default=list(cs.SESSION_WORST),
                    choices=list(cs.SESSION_WORST),
                    help="the session_accuracy phase's matmul_precision, in "
                    'turn')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('port_precision_phases: no CUDA device', file=sys.stderr)
        return 2
    os.chdir(cs.REPO)
    seconds = []
    try:
        print(cs.phase_card(), flush=True)
        for name in args.phases:
            precs = {'precision': [None],
                     'session_accuracy': args.session_precisions}.get(
                         name, args.precisions)
            for prec in precs:
                torch.cuda.synchronize()
                t = time.perf_counter()
                if prec is None:
                    cs.phase_precision()
                else:
                    getattr(cs, f'phase_{name}')(prec)
                torch.cuda.synchronize()
                seconds.append([name, prec, time.perf_counter() - t])
                print(json.dumps({'phase_seconds': seconds[-1]}),
                      flush=True)
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps({'seconds': seconds}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
