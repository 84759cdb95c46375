"""Reconstruction quality metrics (L7); port of
`nice_slam_tpu/eval/recon.py` (numpy and scipy, as there).

  * 3D: sample points on each mesh surface; accuracy = mean nearest-
    neighbour distance rec -> gt, completion = gt -> rec, completion ratio
    = fraction of gt samples within 5 cm; optional ICP pre-alignment.
  * 2D: depth-L1 over random views, the depth images from the port's
    native rasterizer (mesh/native.py).

All distances are reported in centimeters (x100).
"""

from __future__ import annotations

import warnings

import numpy as np

from nice_slam_tpu_torch.mesh.native import rasterize_depth


def sample_surface(verts: np.ndarray, tris: np.ndarray, n: int,
                   rng: np.random.Generator) -> np.ndarray:
    """Uniform area-weighted surface sampling (trimesh.sample equivalent)."""
    a = verts[tris[:, 1]] - verts[tris[:, 0]]
    b = verts[tris[:, 2]] - verts[tris[:, 0]]
    area = 0.5 * np.linalg.norm(np.cross(a, b), axis=1)
    total = area.sum()
    if total <= 0:
        raise ValueError('mesh has no area')
    face = rng.choice(len(tris), size=n, p=area / total)
    r1 = np.sqrt(rng.random(n))
    r2 = rng.random(n)
    v0, v1, v2 = (verts[tris[face, 0]], verts[tris[face, 1]],
                  verts[tris[face, 2]])
    return (1 - r1)[:, None] * v0 + (r1 * (1 - r2))[:, None] * v1 \
        + (r1 * r2)[:, None] * v2


def nn_distances(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    from scipy.spatial import cKDTree
    tree = cKDTree(dst)
    d, _ = tree.query(src, k=1, workers=-1)
    return d


def icp_align(source_pts: np.ndarray, target_pts: np.ndarray,
              iters: int = 20, threshold: float = 0.1) -> np.ndarray:
    """Point-to-point ICP returning a 4x4 transform of source onto target
    (replaces Open3D registration_icp used at eval_recon.py:45-59)."""
    from scipy.spatial import cKDTree
    transform = np.eye(4)
    src = source_pts.copy()
    tree = cKDTree(target_pts)
    for _ in range(iters):
        d, idx = tree.query(src, k=1, workers=-1)
        m = d < threshold
        if m.sum() < 10:
            break
        p = src[m]
        q = target_pts[idx[m]]
        pm, qm = p.mean(0), q.mean(0)
        w = (p - pm).T @ (q - qm)
        u, _, vt = np.linalg.svd(w)
        s = np.eye(3)
        if np.linalg.det(u @ vt) < 0:
            s[2, 2] = -1
        rot = vt.T @ s @ u.T
        t = qm - rot @ pm
        step = np.eye(4)
        step[:3, :3] = rot
        step[:3, 3] = t
        src = src @ rot.T + t
        transform = step @ transform
    return transform


def calc_3d_metric(rec_verts, rec_tris, gt_verts, gt_tris, *,
                   align: bool = True, n_samples: int = 200000,
                   completion_thresh: float = 0.05, seed: int = 0) -> dict:
    """Accuracy / completion / completion-ratio in cm (eval_recon.py:24-117)."""
    rng = np.random.default_rng(seed)
    rec_pts = sample_surface(rec_verts, rec_tris, n_samples, rng)
    gt_pts = sample_surface(gt_verts, gt_tris, n_samples, rng)

    if align:
        transform = icp_align(rec_pts[::20], gt_pts[::20])
        rec_pts = rec_pts @ transform[:3, :3].T + transform[:3, 3]

    acc = nn_distances(rec_pts, gt_pts)
    comp = nn_distances(gt_pts, rec_pts)
    return {
        'accuracy_cm': float(acc.mean() * 100),
        'completion_cm': float(comp.mean() * 100),
        'completion_ratio_%': float((comp < completion_thresh).mean() * 100),
    }


def oriented_bounds(verts: np.ndarray):
    """PCA-approximate oriented bounding box.

    Replaces trimesh.bounds.oriented_bounds (used by the reference's
    get_cam_position, eval_recon.py:120-128) without the trimesh
    dependency: axes come from the vertex covariance eigenvectors
    (descending variance) rather than the exact minimal-volume search —
    for room scans the two agree closely.
    Returns (to_origin [4,4], extents [3]) with to_origin mapping the mesh
    into a centered axis-aligned frame.
    """
    c = verts.mean(axis=0)
    cov = np.cov((verts - c).T)
    _, evecs = np.linalg.eigh(cov)
    rot = evecs[:, ::-1].T            # rows = box axes, descending variance
    if np.linalg.det(rot) < 0:
        rot[2] *= -1
    local = (verts - c) @ rot.T
    lo, hi = local.min(axis=0), local.max(axis=0)
    to_origin = np.eye(4)
    to_origin[:3, :3] = rot
    to_origin[:3, 3] = -rot @ c - (lo + hi) / 2
    return to_origin, hi - lo


def _viewmatrix(z, up, pos) -> np.ndarray:
    """Look-at camera basis (reference eval_recon.py:15-21): columns
    [right, up', forward, pos], forward toward the target (CV +z)."""
    vec2 = z / np.linalg.norm(z)
    vec0 = np.cross(up, vec2)
    vec0 /= np.linalg.norm(vec0)
    vec1 = np.cross(vec2, vec0)
    vec1 /= np.linalg.norm(vec1)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([vec0, vec1, vec2], axis=1)
    c2w[:3, 3] = pos
    return c2w


def _sees_points(points, w, h, fx, fy, cx, cy, c2w) -> bool:
    """Whether any of `points` projects inside the view (the reference's
    check_proj, eval_recon.py:62-88, reduced to its net CV-convention
    effect: in front of the camera and inside the image rect)."""
    if len(points) == 0:
        return False
    w2c = np.linalg.inv(c2w)
    cam = points @ w2c[:3, :3].T + w2c[:3, 3]
    z = cam[:, 2] + 1e-5
    u = fx * cam[:, 0] / z + cx
    v = fy * cam[:, 1] / z + cy
    vis = (z > 0) & (u > 0) & (u < w) & (v > 0) & (v < h)
    return bool(vis.any())


def reference_view_sampler(gt_verts: np.ndarray, rng,
                           unseen_pts: np.ndarray | None = None,
                           w: int = 500, h: int = 500,
                           focal: float = 300.0, max_tries: int = 200,
                           stats: dict | None = None):
    """Generator of c2w views with the REFERENCE'S view measure
    (eval_recon.py:152-178): camera origins uniform in the GT mesh's
    shrunk oriented bounding box (x extent x0.3, y/z x0.7, +0.4 lift),
    looking at a uniform random far target with up=[0,0,-1], rejecting any
    view that sees a point of `unseen_pts` (the culled GT mesh's unseen
    companion cloud) — so depth-L1 numbers are comparable to the paper's.

    The reference resamples unboundedly (`while True`); we cap at
    `max_tries` per view.  When the cap is exhausted the yielded view DOES
    see unseen points — that degrades comparability to the paper's number,
    so it is warned about and counted in `stats['rejection_exhausted']`.
    """
    to_origin, extents = oriented_bounds(gt_verts)
    extents = extents * np.array([0.3, 0.7, 0.7])
    transform = np.linalg.inv(to_origin)
    transform[2, 3] += 0.4
    cx = w / 2.0 - 0.5
    cy = h / 2.0 - 0.5
    while True:
        accepted = False
        for _ in range(max_tries):
            local = (rng.random(3) - 0.5) * extents
            origin = transform[:3, :3] @ local + transform[:3, 3]
            target = rng.uniform(-10000.0, 10000.0, 3) - origin
            c2w = _viewmatrix(target, np.array([0.0, 0.0, -1.0]), origin)
            if unseen_pts is None or not _sees_points(
                    unseen_pts, w, h, focal, focal, cx, cy, c2w):
                accepted = True
                break
            if stats is not None:
                stats['rejected_tries'] = stats.get('rejected_tries', 0) + 1
        if not accepted:
            if stats is not None:
                stats['rejection_exhausted'] = \
                    stats.get('rejection_exhausted', 0) + 1
            warnings.warn(
                f'reference_view_sampler: no unseen-free view in '
                f'{max_tries} tries; yielding a view that sees unseen '
                f'points (depth-L1 may read high vs the reference)',
                stacklevel=2)
        yield c2w


def _random_inward_pose(bounds_lo, bounds_hi, rng) -> np.ndarray:
    """Random camera inside the scene AABB looking in a random direction
    (c2w, CV convention: +z forward)."""
    eye = rng.uniform(bounds_lo, bounds_hi)
    fwd = rng.normal(size=3)
    fwd /= np.linalg.norm(fwd)
    up = np.array([0.0, 1.0, 0.0])
    if abs(fwd @ up) > 0.95:
        up = np.array([1.0, 0.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    true_up = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = fwd
    c2w[:3, 3] = eye
    return c2w


def calc_2d_metric(rec_verts, rec_tris, gt_verts, gt_tris, *,
                   n_imgs: int = 1000, seed: int = 0,
                   image_size: int = 500, focal: float = 300.0,
                   min_valid_ratio: float = 0.5,
                   view_sampling: str = 'reference',
                   unseen_pts: np.ndarray | None = None) -> dict:
    """Depth-L1 over rendered views, cm (eval_recon.py:131-210).

    view_sampling:
      * 'reference' (default): the reference's exact view measure —
        origins uniform in the GT mesh's shrunk oriented bounding box,
        look-at with up=[0,0,-1], views seeing any `unseen_pts` rejected
        (check_proj), and the per-view error is the UNMASKED full-image
        |gt - rec| mean like the reference's (:206) — numbers are then
        comparable to the paper's 1.90 cm.
      * 'uniform': uniform in-AABB poses with a valid-coverage filter and
        the error masked to pixels both meshes cover (a stricter surface
        metric, kept for the synthetic acceptance tests).

    unseen_pts: point cloud of GT regions no camera observed (the culled
    GT mesh's `*_pc_unseen.npy` companion in the reference's data release);
    None disables the rejection.
    """
    rng = np.random.default_rng(seed)
    h = w = image_size
    cx = cy = image_size / 2.0 - 0.5
    errors = []

    if view_sampling == 'reference':
        stats: dict = {}
        views = reference_view_sampler(gt_verts, rng, unseen_pts,
                                       w=w, h=h, focal=focal, stats=stats)
        for _ in range(n_imgs):
            w2c = np.linalg.inv(next(views))
            gt_d = rasterize_depth(gt_verts, gt_tris, w2c, focal, focal,
                                   cx, cy, h, w)
            rec_d = rasterize_depth(rec_verts, rec_tris, w2c, focal, focal,
                                    cx, cy, h, w)
            errors.append(np.abs(gt_d - rec_d).mean())
        return {
            'depth_l1_cm': float(np.mean(errors) * 100),
            'n_views': len(errors),
            'views_rejected_tries': stats.get('rejected_tries', 0),
            'views_rejection_exhausted': stats.get('rejection_exhausted', 0),
        }

    lo = gt_verts.min(axis=0)
    hi = gt_verts.max(axis=0)
    attempts = 0
    while len(errors) < n_imgs and attempts < n_imgs * 20:
        attempts += 1
        c2w = _random_inward_pose(lo, hi, rng)
        w2c = np.linalg.inv(c2w)
        gt_d = rasterize_depth(gt_verts, gt_tris, w2c, focal, focal,
                               cx, cy, h, w)
        valid = gt_d > 0
        if valid.mean() < min_valid_ratio:
            continue
        rec_d = rasterize_depth(rec_verts, rec_tris, w2c, focal, focal,
                                cx, cy, h, w)
        both = valid & (rec_d > 0)
        if both.sum() == 0:
            continue
        errors.append(np.abs(gt_d[both] - rec_d[both]).mean())
    return {
        'depth_l1_cm': float(np.mean(errors) * 100) if errors else np.nan,
        'n_views': len(errors),
    }
