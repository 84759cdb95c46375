"""Meshing from the port's SlamSystem on the CPU: a mesh after the first
frame, background meshing over a run, a background mesh that reads the
state of the moment it was asked for, and the reconstruction of the
synthetic scene scored against its analytic ground truth (the port's
versions of tests/test_mesher.py:46-85 and
tests/test_recon_acceptance.py:40-74, with the same bars)."""

import copy
import os
import threading

import numpy as np
import torch

from tests.util import make_test_cfg

torch.set_num_threads(2)

# a seed whose initial decoders map the first frame of this scene (some
# initial draws make that map diverge, in either package)
SEED = 4


def test_mesh_extraction_from_slam(tmp_path):
    """Map the box for one frame, extract a mesh: the back wall seen by the
    first camera appears near z = -1."""
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    from nice_slam_tpu_torch.mesh.mesher import load_ply
    cfg = make_test_cfg(n_frames=5)
    cfg['meshing']['resolution'] = 48
    slam = SlamSystem(cfg, device='cpu', seed=SEED, output=str(tmp_path))
    slam.step(0)
    path = slam.mesh_now(0)   # on the background thread: join, then read
    slam.join_mesh()
    assert path == str(tmp_path / 'mesh' / '00000_mesh.ply')
    verts, tris = load_ply(path)
    assert len(verts) > 200 and len(tris) > 200
    assert verts[:, 2].min() > -1.4
    back = verts[np.abs(verts[:, 2] + 1.0) < 0.15]
    assert len(back) > 50


def test_async_meshing_writes_every_mesh(tmp_path):
    """Background meshing over a run loses no mesh: both cadence meshes,
    the final mesh and the evaluation mesh exist after run()."""
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    from nice_slam_tpu_torch.mesh.mesher import load_ply
    cfg = make_test_cfg(n_frames=9)
    cfg['meshing'].update(resolution=48, eval_rec=True)
    cfg['mapping']['mesh_freq'] = 4
    slam = SlamSystem(cfg, device='cpu', seed=SEED, output=str(tmp_path))
    assert slam.mesh_async
    slam.run()
    files = ['00004_mesh.ply', '00008_mesh.ply', 'final_mesh.ply',
             'final_mesh_eval_rec.ply']
    assert sorted(os.listdir(tmp_path / 'mesh')) == files
    for f in files:
        verts, tris = load_ply(str(tmp_path / 'mesh' / f))
        assert len(verts) > 0 and len(tris) > 0, f
    assert sorted(name for name, _, _ in slam.timers.meshes) == files
    pieces = dict((name, p) for name, _, p in slam.timers.meshes)
    assert set(pieces['final_mesh.ply']) == {
        'expand_s', 'hull_s', 'query_s', 'marching_s', 'seen_s',
        'components_s', 'color_s', 'ply_s'}
    assert slam.timers.summary()['mesh_s'] > 0
    assert slam._mesh_pool is None      # run() stopped the mesh thread


def test_async_mesh_equals_sync_mesh_of_the_same_snapshot(tmp_path):
    """The mapper updates the map in place and BA moves keyframe poses
    while a background mesh runs: the background mesh is the one a
    blocking extraction of the state at mesh_now gives."""
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    from nice_slam_tpu_torch.engine.keyframes import Keyframe, KeyframeStore
    cfg = make_test_cfg(n_frames=5)
    cfg['meshing']['resolution'] = 32
    slam = SlamSystem(cfg, device='cpu', seed=SEED, output=str(tmp_path))
    slam.step(0)
    snap_decoders = copy.deepcopy(slam.decoders)
    snap_grids = {k: g.detach().clone() for k, g in slam.grids.items()}
    snap_kfs = KeyframeStore([Keyframe(kf.idx, kf.color, kf.depth,
                                       kf.est_c2w.copy(), kf.gt_c2w)
                              for kf in slam.keyframes.frames])
    snap_est = slam.estimate_c2w.copy()

    extract = slam.mesher.extract
    gate = threading.Event()

    def gated_extract(*args, **kwargs):
        assert gate.wait(120)
        return extract(*args, **kwargs)

    slam.mesher.extract = gated_extract
    path = slam.mesh_now(0)             # the thread waits at the gate
    with torch.no_grad():
        for g in slam.grids.values():
            g.mul_(-1.0)
        for p in slam.decoders.parameters():
            p.mul_(0.5)
    slam.keyframes.frames[0].est_c2w[:3, 3] += 0.3
    slam.estimate_c2w[0, :3, 3] += 0.3
    gate.set()
    slam.join_mesh()

    sync_path = str(tmp_path / 'sync.ply')
    assert extract(sync_path, snap_decoders, snap_grids, snap_kfs, snap_est,
                   0) == sync_path
    with open(path, 'rb') as f, open(sync_path, 'rb') as g:
        background, blocking = f.read(), g.read()
    assert len(blocking) > 1000
    assert background == blocking


def test_slam_reconstruction_vs_analytic_box(tmp_path):
    """The whole system on an orbit of the synthetic room with ground-truth
    poses, its final mesh scored against the analytic ground-truth mesh
    under the JAX package's bars."""
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    from nice_slam_tpu_torch.eval.recon import calc_3d_metric
    from nice_slam_tpu_torch.io.datasets import synthetic_gt_mesh
    from nice_slam_tpu_torch.mesh.mesher import load_ply
    cfg = make_test_cfg(n_frames=16)
    cfg['synthetic']['step'] = 0.4
    cfg['tracking']['gt_camera'] = True
    cfg['mapping'].update(every_frame=2, keyframe_every=2,
                          mapping_window_size=5, iters=40)
    cfg['meshing']['resolution'] = 96
    slam = SlamSystem(cfg, device='cpu', seed=SEED, output=str(tmp_path))
    slam.run()
    rec_v, rec_t = load_ply(str(tmp_path / 'mesh' / 'final_mesh.ply'))
    gt_v, gt_t = synthetic_gt_mesh(cfg['synthetic']['box'], resolution=128)
    m = calc_3d_metric(rec_v, rec_t, gt_v, gt_t, align=False,
                       n_samples=50000)
    assert m['accuracy_cm'] < 6.0, m
    assert m['completion_cm'] < 25.0, m
    assert m['completion_ratio_%'] > 33.0, m
