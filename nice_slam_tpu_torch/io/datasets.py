"""RGB-D sequence ingest (L5); port of `nice_slam_tpu/io/datasets.py`,
the analytic `synthetic` scene only (the file-based loaders are not ported
yet).

A loader yields (index, color [H, W, 3] float32 in [0, 1], depth [H, W]
float32 meters*scale, c2w [4, 4] float32) with OpenGL-style poses.
"""

from __future__ import annotations

import numpy as np


def get_dataset(cfg: dict):
    name = cfg['dataset']
    if name != 'synthetic':
        raise NotImplementedError(
            f'dataset {name!r}: only the synthetic scene is ported so far')
    return SyntheticBox(cfg, cfg.get('scale', 1.0))


class SyntheticBox:
    """Analytic box-room RGB-D sequence: a camera orbits inside an
    axis-aligned box with three box obstacles; depth is the exact ray/box
    exit distance and color a smooth function of the hit point, plus a
    fixed per-frame sensor noise."""

    def __init__(self, cfg: dict, scale: float = 1.0):
        cam = cfg['cam']
        self.H, self.W = cam['H'], cam['W']
        self.fx, self.fy = cam['fx'], cam['fy']
        self.cx, self.cy = cam['cx'], cam['cy']
        self.scale = scale
        syn = cfg.get('synthetic', {})
        self.n_img = int(syn.get('n_frames', 40))
        self.box = np.array(syn.get('box', [[-3, 3], [-2.5, 2.5], [-2, 2]]),
                            dtype=np.float64)
        radius = float(syn.get('radius', 0.8))
        step = float(syn.get('step', 0.02))
        # multiplicative depth noise sigma (fraction of depth)
        self.noise = float(syn.get('noise', 0.003))
        self.poses = []
        for t in range(self.n_img):
            ang = step * t
            c2w = np.eye(4)
            cy, sy = np.cos(ang * 0.5), np.sin(ang * 0.5)
            c2w[:3, :3] = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
            c2w[:3, 3] = [radius * np.cos(ang), 0.05 * np.sin(ang),
                          radius * np.sin(ang)]
            self.poses.append(c2w)

    def __len__(self) -> int:
        return self.n_img

    def __getitem__(self, index: int):
        pose = self.poses[index].copy()
        color, depth = render_box_frame(
            pose, self.H, self.W, self.fx, self.fy, self.cx, self.cy,
            self.box)
        if self.noise > 0:
            rng = np.random.default_rng(1000 + index)
            depth = depth * (1.0 + self.noise
                             * rng.standard_normal(depth.shape))
            color = np.clip(
                color + 3 * self.noise * rng.standard_normal(color.shape),
                0.0, 1.0)
        pose[:3, 3] *= self.scale
        return (index, color.astype(np.float32),
                depth.astype(np.float32) * self.scale,
                pose.astype(np.float32))


def synthetic_gt_mesh(box, obstacles=None, resolution=192):
    """Ground-truth surface mesh of the synthetic scene (room walls and
    obstacle faces), for scoring a SLAM mesh with eval/recon.py.

    The free-space field f(p) = min(room interior distance, -obstacle
    interior distances) is analytic; its zero level set, extracted with the
    native marching tetrahedra at `resolution`^3, is the scene surface
    (vertex error bounded by the cell diagonal).
    Returns (vertices [N, 3] float32, triangles [M, 3] int32).
    """
    from nice_slam_tpu_torch.mesh.native import marching_tetrahedra
    box = np.asarray(box, dtype=np.float64)
    if obstacles is None:
        obstacles = default_obstacles(box)
    pad = 0.05 * (box[:, 1] - box[:, 0])
    xs, ys, zs = (np.linspace(box[a, 0] - pad[a], box[a, 1] + pad[a],
                              resolution) for a in range(3))
    p = np.stack(np.meshgrid(xs, ys, zs, indexing='ij'), axis=-1)

    def inside_dist(b):
        """Positive inside box b: the distance to its nearest face."""
        return np.minimum((p - b[:, 0]).min(axis=-1),
                          (b[:, 1] - p).min(axis=-1))

    f = inside_dist(box)
    for ob in obstacles:
        f = np.minimum(f, -inside_dist(np.asarray(ob, dtype=np.float64)))
    return marching_tetrahedra(f.astype(np.float32), xs, ys, zs, 0.0)


def default_obstacles(box):
    """Three interior boxes, so depth varies with every pose axis."""
    lo = box[:, 0]
    ext = box[:, 1] - box[:, 0]

    def rel(a, b):
        return lo + np.asarray(a) * ext, lo + np.asarray(b) * ext

    return [np.stack(rel([0.10, 0.05, 0.05], [0.35, 0.55, 0.30]), axis=1),
            np.stack(rel([0.60, 0.10, 0.55], [0.85, 0.40, 0.80]), axis=1),
            np.stack(rel([0.40, 0.55, 0.15], [0.60, 0.90, 0.40]), axis=1)]


def _camera_dirs(h, w, fx, fy, cx, cy) -> np.ndarray:
    """Camera-frame ray directions [h, w, 3] (f32)."""
    jj, ii = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing='ij')
    return np.stack([(ii - cx) / fx, -(jj - cy) / fy, -np.ones_like(ii)],
                    axis=-1)


def render_box_frame(c2w, h, w, fx, fy, cx, cy, box, obstacles=None):
    """Exact RGB-D of the inside of a box room with box obstacles (camera
    along -z, y up), float32."""
    if obstacles is None:
        obstacles = default_obstacles(box)
    box = np.asarray(box, dtype=np.float32)
    obstacles = [np.asarray(ob, dtype=np.float32) for ob in obstacles]
    dirs = _camera_dirs(h, w, fx, fy, cx, cy)
    rays_d = dirs @ c2w[:3, :3].T.astype(np.float32)
    rays_o = c2w[:3, 3].astype(np.float32)
    with np.errstate(divide='ignore', invalid='ignore'):
        t = (box[None, None, :, :] - rays_o[None, None, :, None]) / \
            rays_d[..., :, None]                       # [h, w, 3, 2]
        t_hit = np.min(np.max(t, axis=-1), axis=-1)    # room-wall exit
        for ob in obstacles:
            tb = (ob[None, None, :, :] - rays_o[None, None, :, None]) / \
                rays_d[..., :, None]
            t_near = np.max(np.min(tb, axis=-1), axis=-1)
            t_far = np.min(np.max(tb, axis=-1), axis=-1)
            hits = (t_near <= t_far) & (t_near > 1e-6)
            t_hit = np.where(hits, np.minimum(t_hit, t_near), t_hit)
    # the camera-frame z-component of rays_d is -1, so the ray parameter is
    # the z-buffer depth a sensor reports
    depth = t_hit
    hit = rays_o + rays_d * t_hit[..., None]
    ext = box[:, 1] - box[:, 0]
    u = (hit - box[:, 0]) / ext
    color = np.stack([
        0.5 + 0.5 * np.sin(11.0 * u[..., 0]) * np.cos(9.0 * u[..., 1]),
        0.5 + 0.5 * np.sin(7.0 * u[..., 1] + 1.0) * np.cos(5.0 * u[..., 0]),
        0.5 + 0.5 * np.cos(13.0 * u[..., 2] + 2.0 * u[..., 0]),
    ], axis=-1)
    return np.clip(color, 0, 1), depth
