"""Port parity of the reconstruction metrics (eval/recon.py) and of the
synthetic scene's ground-truth mesh (io/datasets.synthetic_gt_mesh) on the
CPU, against the JAX package on the same meshes and seeds.

Both sides are the same numpy and scipy code over the same native library
source (marching tetrahedra, the depth rasterizer), so the results must be
equal, not merely close.
"""

import numpy as np
import pytest

from nice_slam_tpu.eval import recon as jr
from nice_slam_tpu.io.datasets import synthetic_gt_mesh as jax_gt_mesh
from nice_slam_tpu_torch.eval import recon as tr
from nice_slam_tpu_torch.io.datasets import synthetic_gt_mesh

BOX = np.array([[-1.0, 1.0], [-0.8, 0.8], [-1.0, 1.0]])


@pytest.fixture(scope='module')
def meshes():
    """The scene's ground truth, and a coarser mesh of a slightly moved and
    shrunk scene standing in for a reconstruction."""
    gt = synthetic_gt_mesh(BOX, resolution=48)
    rec = synthetic_gt_mesh(BOX * 0.97 + 0.02, resolution=40)
    return gt, rec


@pytest.mark.parametrize('resolution', [48, 96])
def test_synthetic_gt_mesh_equals_jax(resolution):
    v, t = synthetic_gt_mesh(BOX, resolution=resolution)
    jv, jt = jax_gt_mesh(BOX, resolution=resolution)
    assert len(v) > 1000
    assert np.array_equal(v, jv) and np.array_equal(t, jt)


@pytest.mark.parametrize('align', [False, True])
def test_calc_3d_metric_equals_jax(meshes, align):
    (gv, gt), (rv, rt) = meshes
    kw = dict(align=align, n_samples=20000, seed=3)
    got = tr.calc_3d_metric(rv, rt, gv, gt, **kw)
    assert got == jr.calc_3d_metric(rv, rt, gv, gt, **kw)
    assert 0 < got['accuracy_cm'] < 10 and got['completion_ratio_%'] > 10


@pytest.mark.parametrize('view_sampling', ['reference', 'uniform'])
def test_calc_2d_metric_equals_jax(meshes, view_sampling):
    (gv, gt), (rv, rt) = meshes
    # the reference sampler rejects views that see these "unseen" points
    unseen = gv[gv[:, 1] > 0.75]
    kw = dict(n_imgs=4, seed=1, image_size=96, focal=60.0,
              view_sampling=view_sampling, unseen_pts=unseen)
    got = tr.calc_2d_metric(rv, rt, gv, gt, **kw)
    assert got == jr.calc_2d_metric(rv, rt, gv, gt, **kw)
    assert got['n_views'] == 4 and np.isfinite(got['depth_l1_cm'])
