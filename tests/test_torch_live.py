"""The port's live dashboard (nice_slam_tpu_torch/utils/live.py) and the
`debug.profile_dir` trace: the cases of tests/test_engine.py's live tests
on the port, the CLI's --live, the mesh view against the JAX package's
rasterization of the same mesh and pose, and a profiled run."""

import json
import os
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch
import yaml

from nice_slam_tpu_torch.core.cameras import Intrinsics
from nice_slam_tpu_torch.io.codecs import read_color
from nice_slam_tpu_torch.utils.live import LiveViewer
from tests.util import make_test_cfg

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fetch(port: int, name: str):
    with urllib.request.urlopen(f'http://localhost:{port}/{name}',
                                timeout=10) as r:
        return r.read()


def test_live_viewer_during_run(tmp_path):
    """`visualization.live` keeps an updating dashboard while the run
    executes: trajectory plot, mesh render (both decodable PNGs),
    status.json reaching the last frame, served over HTTP during the run
    (live_port: 0), the server closed by run()."""
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    cfg = make_test_cfg(n_frames=5)
    cfg['mapping'].update(mesh_freq=4, iters_first=200)   # a mesh mid-run
    cfg['visualization'] = {'live': True, 'live_freq': 2, 'live_port': 0}
    slam = SlamSystem(cfg, device='cpu', seed=4, output=str(tmp_path))
    port = slam.live.port
    assert port
    fetched, stop = [], threading.Event()

    def poll():
        while not stop.is_set() and not fetched:
            try:
                fetched.append(json.loads(_fetch(port, 'status.json')))
            except OSError:
                stop.wait(0.2)

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    try:
        slam.run()
    finally:
        stop.set()
        poller.join(timeout=15)
    assert not poller.is_alive()
    assert fetched and fetched[0]['n_img'] == 5

    live = tmp_path / 'live'
    assert (live / 'index.html').exists()
    for name in ('traj.png', 'mesh.png'):
        img = read_color(str(live / name))
        assert img.ndim == 3 and img.shape[2] == 3 and img.std() > 0, name
    status = json.loads((live / 'status.json').read_text())
    assert status['frame'] == 4 and status['n_img'] == 5
    assert status['pose_err_vs_gt_m'] < 0.03
    assert {'track_s', 'map_s', 'elapsed_s'} <= set(status)
    assert slam.live._server is None      # closed in run()'s finally
    with pytest.raises(OSError):
        _fetch(port, 'status.json')


def test_live_viewer_http_serves(tmp_path):
    """The HTTP endpoint serves the dashboard files; `update` draws on the
    cadence and on the last frame only."""
    intr = Intrinsics(H=24, W=32, fx=16.0, fy=16.0, cx=15.5, cy=11.5)
    lv = LiveViewer(str(tmp_path), intr, freq=2, port=0)
    try:
        est = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
        gt = est.copy()
        est[3, :3, 3] += 0.01
        assert not lv.update(1, 4, est, gt)
        assert lv.update(3, 4, est, gt)
        status = json.loads(_fetch(lv.port, 'status.json'))
        assert abs(status['pose_err_vs_gt_m'] - 0.01 * 3 ** 0.5) < 1e-4
        assert b'traj.png' in _fetch(lv.port, 'index.html')
        assert sorted(os.listdir(tmp_path)) == ['index.html', 'status.json',
                                                'traj.png']
    finally:
        lv.close()


def test_mesh_view_equals_the_jax_rasterization(tmp_path):
    """`mesh.png`'s depth: the mesh seen from the estimated pose, the
    pose flipped from OpenGL's to CV's convention, at view_size pixels,
    bit for bit the JAX LiveViewer's rasterization of the same mesh."""
    from nice_slam_tpu.mesh.mesher import load_ply as jload_ply
    from nice_slam_tpu.mesh.native import rasterize_depth as jrasterize
    from nice_slam_tpu_torch.io.datasets import synthetic_gt_mesh
    from nice_slam_tpu_torch.mesh.mesher import save_ply
    path = str(tmp_path / 'mesh' / '00004_mesh.ply')
    os.makedirs(os.path.dirname(path))
    save_ply(path, *synthetic_gt_mesh([[-1, 1], [-0.8, 0.8], [-1, 1]],
                                      resolution=48))
    intr = Intrinsics(H=60, W=80, fx=40.0, fy=40.0, cx=39.5, cy=29.5)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.1, 0.05, 0.2]
    ang = 0.4
    c2w[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                   [-np.sin(ang), 0, np.cos(ang)]]
    lv = LiveViewer(str(tmp_path / 'live'), intr, view_size=120)
    got = lv.mesh_depth(path, c2w)
    # nice_slam_tpu/utils/live.py LiveViewer._plot_mesh
    verts, tris = jload_ply(path)
    s = 120 / max(intr.H, intr.W)
    h, w = max(int(intr.H * s), 2), max(int(intr.W * s), 2)
    cv = c2w.astype(np.float64).copy()
    cv[:3, 1] *= -1
    cv[:3, 2] *= -1
    want = jrasterize(verts.astype(np.float64), tris, np.linalg.inv(cv),
                      intr.fx * s, intr.fy * s, intr.cx * s, intr.cy * s,
                      h, w)
    assert got.shape == (90, 120) and (got > 0).mean() > 0.9
    np.testing.assert_array_equal(got, want)
    # the drawn view: the mesh's name over its depth under plasma
    lv.update(0, 1, c2w[None], c2w[None], mesh_dir=str(tmp_path / 'mesh'))
    img = read_color(str(tmp_path / 'live' / 'mesh.png'))
    assert img.shape[1] >= 120 and img.shape[0] > 90


def test_cli_live_writes_the_dashboard(tmp_path):
    """`python -m nice_slam_tpu_torch CONFIG --live` (run.py's --live):
    the dashboard reaches the last frame."""
    cfg = make_test_cfg(n_frames=3, h=30, w=40, coarse=False)
    cfg['mapping'].update(iters_first=10, iters=5)
    cfg['tracking'].update(iters=3)
    path = tmp_path / 'tiny.yaml'
    path.write_text(yaml.safe_dump(cfg))
    out = tmp_path / 'out'
    res = subprocess.run(
        [sys.executable, '-m', 'nice_slam_tpu_torch', str(path), '--device',
         'cpu', '--output', str(out), '--live'], cwd=REPO,
        env={**os.environ, 'OMP_NUM_THREADS': '2'}, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    status = json.loads((out / 'live' / 'status.json').read_text())
    assert status['frame'] == 2 and status['n_img'] == 3
    assert (out / 'live' / 'traj.png').exists()


def test_profile_dir_traces_the_run(tmp_path):
    """`debug.profile_dir`: torch.profiler around run() writes a trace into
    the directory, and the poses are those of the run without it."""
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    poses = []
    for profile in (True, False):
        cfg = make_test_cfg(n_frames=2, h=30, w=40, coarse=False)
        cfg['mapping'].update(iters_first=10, iters=5)
        cfg['tracking'].update(iters=3)
        if profile:
            cfg['debug']['profile_dir'] = str(tmp_path / 'trace')
        slam = SlamSystem(cfg, device='cpu', seed=4,
                          output=str(tmp_path / f'run{int(profile)}'))
        slam.run()
        poses.append(slam.estimate_c2w)
    traces = os.listdir(tmp_path / 'trace')
    assert len(traces) == 1 and traces[0].endswith('.pt.trace.json')
    with open(tmp_path / 'trace' / traces[0]) as f:
        assert json.load(f)['traceEvents']
    np.testing.assert_array_equal(poses[0], poses[1])
