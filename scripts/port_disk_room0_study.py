"""room0 at full width from files against room0 on the analytic scene, on
one GPU: where the disk run's time and trajectory differ, and why.

    python scripts/port_disk_room0_study.py [--frames 12]

chip_smoke.py's room0 configuration (configs/Replica/room0.yaml as
loaded: 680x1200, pretrained decoders, the full budgets; the analytic
scene, 12 frames) is run in one process, seed 0, no meshes:
  1. in turns, analytic, disk, disk, analytic: `disk` reads the scene from
     a Replica-format directory that the port's writer made (JPEG color at
     quality 97, uint16 PNG depth at 6553.5), through the Prefetcher and
     the port's decoders; so the two sources are timed in one call;
  2. the analytic frames with one part of the file round trip applied in
     memory (a `frame_reader`), to attribute a change of trajectory: `u8`
     color cut to 8 bits as the writer cuts it; `jpeg` the same color
     through the port's JPEG encoder and decoder; `depth16` depth rounded
     to the PNG's 1/6553.5 m.
One JSON line a run: wall seconds, ms per tracked frame (mean, median),
ms per mapping call by kind, the Prefetcher's read and wait seconds, the
ATE RMSE, the largest and each per-frame translation error.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class RoundTrip:
    """The analytic scene with one part of the file round trip applied."""

    prefetch_workers = 4

    def __init__(self, reader, part: str):
        self.reader, self.part = reader, part

    def __len__(self) -> int:
        return len(self.reader)

    def __getitem__(self, index: int):
        import numpy as np
        from nice_slam_tpu_torch.io import codecs
        idx, color, depth, pose = self.reader[index]
        u8 = (color * 255).astype(np.uint8)
        if self.part == 'u8':
            color = u8.astype(np.float32) / 255.0
        elif self.part == 'jpeg':
            color = codecs.decode_jpeg(codecs.encode_jpeg(u8, 97)).astype(
                np.float32) / 255.0
        elif self.part == 'depth16':
            depth = np.round(depth * 6553.5).astype(np.uint16).astype(
                np.float32) / 6553.5
        return idx, color, depth, pose


def run(cfg: dict, name: str, **kwargs) -> dict:
    import numpy as np
    import torch
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    from nice_slam_tpu_torch.eval.ate import evaluate_ate
    with tempfile.TemporaryDirectory() as out:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slam = SlamSystem(cfg, device='cuda', seed=0, output=out, **kwargs)
        slam.mesher = None
        slam.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    err = np.linalg.norm(slam.estimate_c2w[:, :3, 3]
                         - slam.gt_c2w[:, :3, 3], axis=-1)
    tracked = [s * 1e3 for idx, s in slam.timers.track if idx > 0]
    maps = {}
    for _, kind, _, s in slam.timers.maps:
        maps.setdefault(kind, []).append(s * 1e3)
    return {'run': name, 'wall_s': wall,
            'track_ms_per_frame': statistics.mean(tracked),
            'track_ms_median': statistics.median(tracked),
            'map_ms': maps, 'frame_read_s': slam.timers.read_s,
            'prefetch_wait_s': slam.timers.prefetch_wait_s,
            'ate_rmse_m': evaluate_ate(slam.estimate_c2w, slam.gt_c2w)[
                'absolute_translational_error.rmse'],
            'max_frame_err_m': float(err.max()),
            'frame_err_m': [round(float(e), 6) for e in err]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--frames', type=int, default=12)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('port_disk_room0_study: no CUDA device')
    os.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import room0_cfg
    from nice_slam_tpu_torch.io.datasets import get_dataset
    from nice_slam_tpu_torch.tools.make_fixture_dataset import write_scene
    cfg = room0_cfg()
    cfg['synthetic']['n_frames'] = args.frames
    print(json.dumps({'card': torch.cuda.get_device_name(0),
                      'config': 'configs/Replica/room0.yaml',
                      'frames': args.frames}), flush=True)
    with tempfile.TemporaryDirectory() as data:
        disk = write_scene(cfg, 'replica', data)
        for name in ('analytic', 'disk', 'disk', 'analytic'):
            res = run(disk if name == 'disk' else cfg, name)
            print(json.dumps(res), flush=True)
    for part in ('u8', 'jpeg', 'depth16'):
        res = run(cfg, part, frame_reader=RoundTrip(get_dataset(cfg), part))
        print(json.dumps(res), flush=True)


if __name__ == '__main__':
    main()
