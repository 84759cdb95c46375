"""RGB-D sequence ingest (L5); port of `nice_slam_tpu/io/datasets.py`.

A loader yields (index, color [H, W, 3] float32 RGB in [0, 1], depth
[H, W] float32 meters*scale, c2w [4, 4] float32), with the JAX package's
conventions:
  * color decoded as `cv2.imread` decodes it (io/codecs.py: PNG, and
    baseline JPEG with libjpeg-turbo's integer arithmetic), /255;
  * depth PNGs (uint16) and CoFusion's EXR depth divided by
    `cam.png_depth_scale`, then * `scale`;
  * `cam.distortion`: the color image undistorted as `cv2.undistort`
    does (`undistort`); depth is not;
  * color resized to the depth's size when they differ (real ScanNet:
    1296x968 color, 640x480 depth) as `cv2.resize` INTER_LINEAR does
    (`resize_linear`);
  * `cam.crop_size`: bilinear (align_corners) color, nearest depth;
    `cam.crop_edge`: that many pixels cut from every side;
  * every pose loader flips the y and z columns (OpenGL-style camera), and
    pose translations scale with `scale`;
  * TUM: timestamp association (max_dt 0.08), subsampling to 32 frames a
    second, the first pose rebased to identity;
  * CoFusion: EXR depth, identity poses; Azure: the Open3D
    `trajectory.log`, else identity poses.
Plus the analytic `synthetic` scene (no files).  A file-based loader that
finds no frames raises FileNotFoundError naming the folder and the pattern.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from nice_slam_tpu_torch.io import codecs
from nice_slam_tpu_torch.io.exr import read_exr_depth

DATASET_REGISTRY: dict[str, type] = {}


def register(name: str):
    def deco(cls):
        DATASET_REGISTRY[name] = cls
        return cls
    return deco


def get_dataset(cfg: dict, input_folder: str | None = None,
                scale: float | None = None):
    """The config's loader; `input_folder` overrides `data.input_folder`."""
    scale = cfg.get('scale', 1.0) if scale is None else scale
    name = cfg['dataset']
    if name not in DATASET_REGISTRY:
        raise ValueError(f'unknown dataset {name!r} (known: '
                         f'{sorted(DATASET_REGISTRY)})')
    return DATASET_REGISTRY[name](cfg, input_folder, scale)


def _intrinsics_matrix(fx, fy, cx, cy) -> np.ndarray:
    k = np.eye(3)
    k[0, 0], k[1, 1], k[0, 2], k[1, 2] = fx, fy, cx, cy
    return k


def _frames(folder: str, pattern: str, key=None) -> list[str]:
    """The sorted files of `pattern` under `folder`; raises when there are
    none."""
    paths = sorted(glob.glob(os.path.join(folder, pattern)), key=key)
    if not paths:
        raise FileNotFoundError(
            f'{folder}: no frames match {pattern!r} (is --input_folder / '
            'data.input_folder the sequence\'s directory?)')
    return paths


class BaseDataset:
    """Index-addressable frame reader over files."""

    def __init__(self, cfg: dict, input_folder: str | None, scale: float):
        cam = cfg['cam']
        self.name = cfg['dataset']
        self.scale = scale
        self.png_depth_scale = cam.get('png_depth_scale', 1000.0)
        self.H, self.W = cam['H'], cam['W']
        self.fx, self.fy = cam['fx'], cam['fy']
        self.cx, self.cy = cam['cx'], cam['cy']
        self.distortion = (np.array(cam['distortion'])
                           if 'distortion' in cam else None)
        self.crop_size = cam.get('crop_size')
        self.crop_edge = int(cam.get('crop_edge', 0))
        self.input_folder = (input_folder if input_folder is not None
                             else cfg['data']['input_folder'])
        self.color_paths: list[str] = []
        self.depth_paths: list[str] = []
        self.poses: list[np.ndarray] = []

    def __len__(self) -> int:
        return self.n_img

    def _read_depth(self, path: str) -> np.ndarray:
        if path.endswith('.exr'):
            return read_exr_depth(path) / self.png_depth_scale
        return codecs.read_png(path).astype(np.float32) / self.png_depth_scale

    def __getitem__(self, index: int):
        color = codecs.read_color(self.color_paths[index])
        depth = self._read_depth(self.depth_paths[index])
        if self.distortion is not None:
            k = _intrinsics_matrix(self.fx, self.fy, self.cx, self.cy)
            color = undistort(color, k, self.distortion)
        color = color.astype(np.float32) / 255.0
        depth = depth.astype(np.float32) * self.scale
        h, w = depth.shape
        if color.shape[:2] != (h, w):
            color = resize_linear(color, h, w)
        if self.crop_size is not None:
            ch, cw = self.crop_size
            color = _resize_bilinear_align_corners(color, ch, cw)
            depth = _resize_nearest(depth, ch, cw)
        e = self.crop_edge
        if e > 0:
            color = color[e:-e, e:-e]
            depth = depth[e:-e, e:-e]
        pose = self.poses[index].copy()
        pose[:3, 3] *= self.scale
        return index, color, depth, pose.astype(np.float32)


def undistort(img: np.ndarray, k: np.ndarray, dist) -> np.ndarray:
    """`cv2.undistort(img, k, dist)` of a uint8 [H, W, C] image, the new
    camera matrix = k: for each output pixel its source position under the
    Brown model (k1, k2, p1, p2[, k3[, k4, k5, k6[, s1..s4]]]), rounded to
    1/32 pixel as OpenCV's CV_16SC2 map is, then the fixed-point bilinear
    remap of INTER_LINEAR on uint8 (15-bit weights, round half up), outside
    the image 0."""
    h, w = img.shape[:2]
    d = np.zeros(12)
    d[:len(dist)] = dist
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4 = d
    fx, fy, cx, cy = k[0, 0], k[1, 1], k[0, 2], k[1, 2]
    x = (np.arange(w, dtype=np.float64) * (1.0 / fx) - cx / fx)[None, :]
    y = (np.arange(h, dtype=np.float64) * (1.0 / fy) - cy / fy)[:, None]
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    xy2 = 2 * x * y
    kr = ((1 + ((k3 * r2 + k2) * r2 + k1) * r2)
          / (1 + ((k6 * r2 + k5) * r2 + k4) * r2))
    u = fx * (x * kr + p1 * xy2 + p2 * (r2 + 2 * x2) + s1 * r2
              + s2 * r2 * r2) + cx
    v = fy * (y * kr + p1 * (r2 + 2 * y2) + p2 * xy2 + s3 * r2
              + s4 * r2 * r2) + cy
    iu = np.rint(u * 32).astype(np.int64)
    iv = np.rint(v * 32).astype(np.int64)
    sx, ax = iu >> 5, iu & 31
    sy, ay = iv >> 5, iv & 31
    # a zero border: neighbors outside the image read 0, and a pixel whose
    # four neighbors are all outside comes out 0
    pad = np.zeros((h + 2, w + 2) + img.shape[2:], np.int64)
    pad[1:-1, 1:-1] = img
    x0 = np.clip(sx + 1, 0, w + 1)
    x1 = np.clip(sx + 2, 0, w + 1)
    y0 = np.clip(sy + 1, 0, h + 1)
    y1 = np.clip(sy + 2, 0, h + 1)
    wx1, wy1 = ax, ay
    wx0, wy0 = 32 - ax, 32 - ay
    if img.ndim == 3:
        wx0, wx1, wy0, wy1 = (a[..., None] for a in (wx0, wx1, wy0, wy1))
    acc = (pad[y0, x0] * (wy0 * wx0) + pad[y0, x1] * (wy0 * wx1)
           + pad[y1, x0] * (wy1 * wx0) + pad[y1, x1] * (wy1 * wx1)) * 32
    return np.clip((acc + (1 << 14)) >> 15, 0, 255).astype(np.uint8)


def resize_linear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """`cv2.resize(img, (w, h))` with INTER_LINEAR on float32 [H, W, C]:
    half-pixel centers, source = (dst + 0.5) * in / out - 0.5 in float64,
    clamped at the edges, the weights and the sums in float32."""

    def axis(n_out, n_in):
        f = (np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5
        i0 = np.floor(f).astype(np.int64)
        frac = (f - i0).astype(np.float32)
        low = i0 < 0
        high = i0 >= n_in - 1
        frac[low | high] = 0
        i0 = np.clip(i0, 0, n_in - 1)
        return i0, np.minimum(i0 + 1, n_in - 1), frac

    img = img.astype(np.float32, copy=False)
    x0, x1, fx = axis(w, img.shape[1])
    y0, y1, fy = axis(h, img.shape[0])
    ax1 = fx[:, None]
    ax0 = np.float32(1) - ax1
    rows = img[:, x0] * ax0 + img[:, x1] * ax1
    by1 = fy[:, None, None]
    by0 = np.float32(1) - by1
    return rows[y0] * by0 + rows[y1] * by1


def _resize_bilinear_align_corners(img: np.ndarray, ch: int, cw: int
                                   ) -> np.ndarray:
    """Bilinear resize with torch's align_corners=True convention: source
    coordinate = dst * (in - 1) / (out - 1).  img is [H, W, C]."""
    h, w = img.shape[:2]
    ys = (np.arange(ch, dtype=np.float64) * (h - 1) / max(ch - 1, 1))
    xs = (np.arange(cw, dtype=np.float64) * (w - 1) / max(cw - 1, 1))
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0).astype(img.dtype)[:, None, None]
    wx = (xs - x0).astype(img.dtype)[None, :, None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def _resize_nearest(img: np.ndarray, ch: int, cw: int) -> np.ndarray:
    """Nearest resize with torch's 'nearest' convention: source index =
    floor(dst * in / out)."""
    h, w = img.shape[:2]
    ys = np.minimum((np.arange(ch) * h) // ch, h - 1)
    xs = np.minimum((np.arange(cw) * w) // cw, w - 1)
    return img[ys][:, xs]


def _flip_yz(c2w: np.ndarray) -> np.ndarray:
    out = c2w.copy()
    out[:3, 1] *= -1
    out[:3, 2] *= -1
    return out


@register('replica')
class Replica(BaseDataset):
    def __init__(self, cfg, input_folder, scale):
        super().__init__(cfg, input_folder, scale)
        self.color_paths = _frames(self.input_folder, 'results/frame*.jpg')
        self.depth_paths = _frames(self.input_folder, 'results/depth*.png')
        self.n_img = len(self.color_paths)
        with open(os.path.join(self.input_folder, 'traj.txt')) as f:
            lines = f.readlines()
        self.poses = [
            _flip_yz(np.array(list(map(float, lines[i].split())),
                              dtype=np.float64).reshape(4, 4))
            for i in range(self.n_img)]


@register('scannet')
class ScanNet(BaseDataset):
    def __init__(self, cfg, input_folder, scale):
        super().__init__(cfg, input_folder, scale)
        root = os.path.join(self.input_folder, 'frames')

        def bynum(p):
            return int(os.path.basename(p).split('.')[0])

        self.color_paths = _frames(root, os.path.join('color', '*.jpg'),
                                   bynum)
        self.depth_paths = _frames(root, os.path.join('depth', '*.png'),
                                   bynum)
        self.poses = [
            _flip_yz(np.loadtxt(p).reshape(4, 4))
            for p in _frames(root, os.path.join('pose', '*.txt'), bynum)]
        self.n_img = len(self.color_paths)


@register('cofusion')
class CoFusion(BaseDataset):
    def __init__(self, cfg, input_folder, scale):
        super().__init__(cfg, input_folder, scale)
        self.color_paths = _frames(self.input_folder, 'colour/*.png')
        self.depth_paths = _frames(self.input_folder, 'depth_noise/*.exr')
        self.n_img = len(self.color_paths)
        # CoFusion's frame has no usable alignment; identity poses (the
        # ATE aligns trajectories before scoring)
        self.poses = [np.eye(4) for _ in range(self.n_img)]


@register('azure')
class Azure(BaseDataset):
    def __init__(self, cfg, input_folder, scale):
        super().__init__(cfg, input_folder, scale)
        self.color_paths = _frames(self.input_folder, 'color/*.jpg')
        self.depth_paths = _frames(self.input_folder, 'depth/*.png')
        self.n_img = len(self.color_paths)
        log = os.path.join(self.input_folder, 'scene', 'trajectory.log')
        self.poses = []
        if os.path.exists(log):
            with open(log) as f:
                content = f.readlines()
            for i in range(0, len(content), 5):
                mat = np.array(
                    list(map(float,
                             ''.join(content[i + 1:i + 5]).split()))
                ).reshape(4, 4)
                self.poses.append(_flip_yz(mat))
        else:
            self.poses = [np.eye(4) for _ in range(self.n_img)]


@register('tumrgbd')
class TumRGBD(BaseDataset):
    def __init__(self, cfg, input_folder, scale, frame_rate: int = 32):
        super().__init__(cfg, input_folder, scale)
        root = self.input_folder
        pose_file = os.path.join(root, 'groundtruth.txt')
        if not os.path.isfile(pose_file):
            pose_file = os.path.join(root, 'pose.txt')
        images = np.loadtxt(os.path.join(root, 'rgb.txt'), dtype=str,
                            ndmin=2)
        depths = np.loadtxt(os.path.join(root, 'depth.txt'), dtype=str,
                            ndmin=2)
        posesd = np.loadtxt(pose_file, dtype=np.float64, skiprows=1,
                            ndmin=2)

        t_img = images[:, 0].astype(np.float64)
        t_dep = depths[:, 0].astype(np.float64)
        t_pose = posesd[:, 0]

        # each image to the nearest depth and pose (max_dt 0.08)
        assoc = []
        for i, t in enumerate(t_img):
            j = int(np.argmin(np.abs(t_dep - t)))
            k = int(np.argmin(np.abs(t_pose - t)))
            if abs(t_dep[j] - t) < 0.08 and abs(t_pose[k] - t) < 0.08:
                assoc.append((i, j, k))
        if not assoc:
            raise FileNotFoundError(
                f'{root}: no frame of rgb.txt has a depth.txt and a '
                f'{os.path.basename(pose_file)} entry within 0.08 s')

        # subsample to the target frame rate
        keep = [0]
        for n in range(1, len(assoc)):
            if t_img[assoc[n][0]] - t_img[assoc[keep[-1]][0]] \
                    > 1.0 / frame_rate:
                keep.append(n)

        inv_first = None
        for n in keep:
            i, j, k = assoc[n]
            self.color_paths.append(os.path.join(root, str(images[i, 1])))
            self.depth_paths.append(os.path.join(root, str(depths[j, 1])))
            c2w = _pose_from_quat(posesd[k, 1:])
            if inv_first is None:
                inv_first = np.linalg.inv(c2w)
                c2w = np.eye(4)
            else:
                c2w = inv_first @ c2w
            self.poses.append(_flip_yz(c2w))
        self.n_img = len(self.color_paths)


def _pose_from_quat(pvec: np.ndarray) -> np.ndarray:
    """[tx ty tz qx qy qz qw] -> 4x4 (TUM groundtruth convention)."""
    tx, ty, tz, qx, qy, qz, qw = pvec[:7]
    n = qw * qw + qx * qx + qy * qy + qz * qz
    s = 2.0 / n
    rot = np.array([
        [1 - s * (qy * qy + qz * qz), s * (qx * qy - qz * qw),
         s * (qx * qz + qy * qw)],
        [s * (qx * qy + qz * qw), 1 - s * (qx * qx + qz * qz),
         s * (qy * qz - qx * qw)],
        [s * (qx * qz - qy * qw), s * (qy * qz + qx * qw),
         1 - s * (qx * qx + qy * qy)],
    ])
    pose = np.eye(4)
    pose[:3, :3] = rot
    pose[:3, 3] = (tx, ty, tz)
    return pose


@register('synthetic')
class SyntheticBox:
    """Analytic box-room RGB-D sequence: a camera orbits inside an
    axis-aligned box with three box obstacles; depth is the exact ray/box
    exit distance and color a smooth function of the hit point, plus a
    fixed per-frame sensor noise."""

    # the analytic rendering is CPU-heavy at full frame size and releases
    # the interpreter lock: the Prefetcher runs this many frames at once
    prefetch_workers = 4

    def __init__(self, cfg: dict, input_folder: str | None = None,
                 scale: float = 1.0):
        cam = cfg['cam']
        self.name = cfg['dataset']
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
