"""Port parity of the mesh path on the CPU: the native geometry library
(mesh/native.py, the port's own build of the same source), the PLY
writer/reader, and every piece of the Mesher (mesh/mesher.py) against the
JAX package's Mesher on the same model, keyframes and points, then the
extraction end to end.

Tolerances: host code that is the same numpy, and the native library built
from the same source, must agree exactly.  The decoder field agrees to
the decoder tolerance, 2e-5 absolute and 1e-5 relative (trilinear gather
plus the float32 MLPs).  Visibility masks agree exactly
except at points whose projection lies within 1e-4 px of an image edge
(float32 projections of the two packages differ in the last bits).
"""

import os

import numpy as np
import pytest
import torch

from nice_slam_tpu.core.cameras import Intrinsics as JIntrinsics
from nice_slam_tpu.engine.keyframes import Keyframe as JKeyframe
from nice_slam_tpu.engine.keyframes import KeyframeStore as JKeyframeStore
from nice_slam_tpu.io.datasets import get_dataset
from nice_slam_tpu.mesh import mesher as jm
from nice_slam_tpu.mesh.native import marching_tetrahedra as jax_mt
from nice_slam_tpu.models.grids import prepare_grids as jax_prepare
from nice_slam_tpu_torch.core.cameras import Intrinsics
from nice_slam_tpu_torch.engine.keyframes import Keyframe, KeyframeStore
from nice_slam_tpu_torch.mesh import mesher as tm
from nice_slam_tpu_torch.mesh import native
from nice_slam_tpu_torch.models.grids import prepare_grids
from tests.test_torch_util import jax_nice_setup
from tests.util import make_test_cfg

torch.set_num_threads(2)

H, W = 30, 40
RES = 32
BOUND = ((-1.0, 1.0), (-0.8, 0.8), (-1.0, 1.0))


# ---------------------------------------------------------------------------
# native library and PLY
# ---------------------------------------------------------------------------

def test_marching_tetrahedra_bit_equal_to_the_jax_library():
    rng = np.random.default_rng(0)
    n = 24
    xs = np.linspace(-1, 1, n)
    ys = np.linspace(-0.7, 0.9, n)
    zs = np.linspace(-1.2, 0.8, n)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing='ij')
    field = (0.6 - np.sqrt(X ** 2 + Y ** 2 + Z ** 2)
             + 0.05 * rng.normal(size=X.shape)).astype(np.float32)
    v, t = native.marching_tetrahedra(field, xs, ys, zs, 0.0)
    jv, jt = jax_mt(field, xs, ys, zs, 0.0)
    assert len(v) > 500
    assert np.array_equal(v, jv) and np.array_equal(t, jt)


def test_library_builds_into_the_build_directory():
    native.get_lib()
    assert os.path.dirname(native.LIBRARY).endswith('build')
    assert os.path.exists(native.LIBRARY)
    assert 'nice_slam_tpu' + os.sep not in native.LIBRARY


def test_marching_tetrahedra_sphere():
    n = 40
    xs = np.linspace(-1, 1, n)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing='ij')
    field = (0.6 - np.sqrt(X ** 2 + Y ** 2 + Z ** 2)).astype(np.float32)
    verts, tris = native.marching_tetrahedra(field, xs, xs, xs, 0.0)
    r = np.linalg.norm(verts, axis=1)
    assert len(verts) > 1000
    np.testing.assert_allclose(r.mean(), 0.6, atol=0.005)
    assert r.std() < 0.005
    assert tris.max() < len(verts)


def test_rasterize_depth_plane():
    verts = np.array([[-1, -1, 2], [1, -1, 2], [1, 1, 2], [-1, 1, 2]],
                     np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    d = native.rasterize_depth(verts, tris, np.eye(4), 50, 50, 31.5, 31.5,
                               64, 64)
    assert abs(d[32, 32] - 2.0) < 1e-4
    assert (d > 0).mean() > 0.5


def test_ply_roundtrip(tmp_path):
    verts = np.random.default_rng(0).random((17, 3)).astype(np.float32)
    tris = np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8]], np.int32)
    colors = (verts * 255).astype(np.uint8)
    p = str(tmp_path / 'm.ply')
    tm.save_ply(p, verts, tris, colors)
    v2, t2 = tm.load_ply(p)
    np.testing.assert_array_equal(v2, verts)
    np.testing.assert_array_equal(t2, tris)
    # the JAX reader reads the port's file
    v3, t3 = jm.load_ply(p)
    np.testing.assert_array_equal(v3, verts)
    np.testing.assert_array_equal(t3, tris)


# ---------------------------------------------------------------------------
# mesher pieces against the JAX Mesher
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def world():
    jmodel, params, grids, tmodel, decs, tgrids = jax_nice_setup(0, BOUND)
    fx = 0.5 * W
    jintr = JIntrinsics(H, W, fx, fx, W / 2 - 0.5, H / 2 - 0.5)
    tintr = Intrinsics(H, W, fx, fx, W / 2 - 0.5, H / 2 - 0.5)
    cfg = make_test_cfg(n_frames=12, h=H, w=W)
    cfg['synthetic']['step'] = 0.25
    ds = get_dataset(cfg)
    frames = [ds[i] for i in (0, 4, 8)]
    jkfs = JKeyframeStore([JKeyframe(i, c, d, p.copy(), p.copy())
                           for i, c, d, p in frames])
    tkfs = KeyframeStore([Keyframe(i, c, d, p.copy(), p.copy())
                          for i, c, d, p in frames])
    kw = dict(resolution=RES, marching_cubes_bound=BOUND, points_batch=9000)
    jmesher = jm.Mesher(jm.MesherConfig(**kw), jmodel, jintr)
    tmesher = tm.Mesher(tm.MesherConfig(**kw), tmodel, tintr)
    return dict(jmesher=jmesher, tmesher=tmesher, params=params,
                grids=grids, decs=decs, tgrids=tgrids, jkfs=jkfs, tkfs=tkfs,
                jgrids_x=jax_prepare(grids, jmodel.grid_shapes),
                tgrids_x=prepare_grids(tgrids, tmodel.grid_shapes),
                est=np.stack([p for _, _, _, p in frames]))


def test_lattice_exact(world):
    for a, b in zip(world['tmesher'].lattice(), world['jmesher'].lattice()):
        assert np.array_equal(a, b)


def test_eval_field_matches(world):
    jmesher, tmesher = world['jmesher'], world['tmesher']
    pts = tmesher.lattice()[0]
    got = tmesher.eval_field(world['decs'], world['tgrids_x'], pts, 'fine',
                             cache='lattice')
    want = jmesher.eval_field(world['params'], world['jgrids_x'], pts,
                              'fine', cache='lattice')
    assert got.shape == (RES ** 3,)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    got = tmesher.eval_field(world['decs'], world['tgrids_x'], pts[:3000],
                             'color', column=slice(0, 3))
    want = jmesher.eval_field(world['params'], world['jgrids_x'],
                              pts[:3000], 'color', column=slice(0, 3))
    assert got.shape == (3000, 3)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def _near_edge(points, c2ws, intr, edge):
    """Points whose projection into any frame lies within 1e-4 px of the
    image rect shrunk by `edge` (float64 projection)."""
    near = np.zeros(len(points), bool)
    ph = np.concatenate([points, np.ones_like(points[:, :1])], 1)
    for c2w in c2ws:
        cam = (ph.astype(np.float64) @ np.linalg.inv(c2w).T)[:, :3]
        z = cam[:, 2] + 1e-5
        u = (intr.fx * (-cam[:, 0]) + intr.cx * z) / z
        v = (intr.fy * cam[:, 1] + intr.cy * z) / z
        for a, lim in ((u, edge), (u, intr.W - edge), (v, edge),
                       (v, intr.H - edge)):
            near |= np.abs(a - lim) < 1e-4
    return near


@pytest.mark.parametrize('use_depth', [False, True])
def test_seen_mask_matches(world, use_depth):
    jmesher, tmesher = world['jmesher'], world['tmesher']
    pts = tmesher.lattice()[0]
    c2ws = [kf.est_c2w for kf in world['tkfs'].frames]
    depths = [kf.depth for kf in world['tkfs'].frames]
    got = tmesher.seen_mask(pts, c2ws, depths, use_depth=use_depth)
    want = jmesher.seen_mask(pts, c2ws, depths, use_depth=use_depth)
    assert 0 < got.sum() < len(got)
    diff = got != want
    assert not (diff & ~_near_edge(pts, c2ws, tmesher.intr, 0)).any()


def test_scene_hull_and_inside_hull_exact(world):
    jmesher, tmesher = world['jmesher'], world['tmesher']
    eq = tmesher.scene_hull(world['tkfs'])
    assert np.array_equal(eq, jmesher.scene_hull(world['jkfs']))
    pts = tmesher.lattice()[0]
    got = tmesher.inside_hull(pts, eq)
    assert 0 < got.sum() < len(got)
    assert np.array_equal(got, jmesher.inside_hull(pts, eq))


def _jax_field(world):
    """The field the JAX extract meshes (its own pieces, as extract runs
    them without the forecast path)."""
    jmesher = world['jmesher']
    pts = jmesher.lattice()[0]
    inside = jmesher.inside_hull(pts, jmesher.scene_hull(world['jkfs']),
                                 cache='lattice')
    z = jmesher.eval_field(world['params'], world['jgrids_x'], pts, 'fine',
                           cache='lattice')
    z[~inside] = 100.0
    return z.reshape(RES, RES, RES)


def test_extract_end_to_end(world, tmp_path):
    """The JAX field through the port's post-processing gives the JAX
    mesh exactly; the port's own extraction gives a mesh within 1% of its
    vertex count and a tenth of a cell in symmetric Chamfer distance."""
    jmesher, tmesher = world['jmesher'], world['tmesher']
    jpath = str(tmp_path / 'jax.ply')
    assert jmesher.extract(jpath, world['params'], world['grids'],
                           world['jkfs'], world['est'], 8,
                           color=False) == jpath
    jv, jt = jm.load_ply(jpath)
    assert len(jv) > 100
    v, t = tmesher.surface(_jax_field(world), world['tkfs'], world['est'], 8)
    assert np.array_equal(v, jv) and np.array_equal(t, jt)

    path = str(tmp_path / 'port.ply')
    assert tmesher.extract(path, world['decs'], world['tgrids'],
                           world['tkfs'], world['est'], 8) == path
    pv, _ = tm.load_ply(path)
    assert abs(len(pv) - len(jv)) <= 0.01 * len(jv)
    from scipy.spatial import cKDTree
    chamfer = 0.5 * (cKDTree(jv).query(pv)[0].mean()
                     + cKDTree(pv).query(jv)[0].mean())
    cell = (BOUND[0][1] - BOUND[0][0] + 0.1) / (RES - 1)
    assert chamfer < 0.1 * cell, chamfer


def test_native_wrappers_refuse_what_the_library_cannot_take():
    """Shapes are checked before any pointer reaches the C++ code."""
    xs = np.linspace(0, 1, 4)
    with pytest.raises(ValueError):
        native.marching_tetrahedra(np.zeros((4, 4, 5), np.float32), xs, xs,
                                   xs, 0.0)
    verts = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError):
        native.rasterize_depth(verts, np.array([[0, 1, 3]]), np.eye(4),
                               10, 10, 4, 4, 8, 8)
    with pytest.raises(ValueError):
        native.rasterize_depth(verts[:, :2], np.array([[0, 1, 2]]),
                               np.eye(4), 10, 10, 4, 4, 8, 8)
