"""Mesh extraction (L5); port of `nice_slam_tpu/mesh/mesher.py`.

  * lattice query: `resolution` points per axis over marching_cubes_bound
    padded by 0.05; field = fine-stage occupancy (iMAP*: the color stage's
    density, cut at the config's level_set); points outside the scene hull
    forced to 100.
  * scene hull: scipy's convex hull of the back-projected keyframe depth
    and the camera centres, scaled by clean_mesh_bound_scale.
  * iso-surface: the native marching tetrahedra (mesh/native.py).
  * cleaning: cull faces whose three vertices no keyframe saw; keep the
    largest component or drop components below an area threshold.
  * color: 'direct_point_query' evaluates the color stage at the vertices;
    'render_ray_along_normal' renders a short ray along each normal.
  * forecast (mesh_coarse_level): the seen region queried at fine, the
    forecast region at coarse + 0.2, the rest clamped to -100.

The field and color queries run on the model's device in fixed-size
chunks under `no_grad` (with a `group` of ranks each chunk is split over
them: parallel/sharded.sharded_eval_points), through the fused
decoder-MLP kernel (`SceneModel.fused_eval`; ops/fused_mlp.py) for NICE
(iMAP*'s decoder has no grid features and takes the plain path); hull,
marching tetrahedra and cleaning run on the host.  `Mesher.timings` holds
the wall seconds of each piece of the last extraction (every device piece
ends with its host copy).

This mesher stands in for the JAX package's default one, whose queries
run its decoders in XLA under their precision scope (its Pallas kernel
only under NSTPU_FUSED_MLP=1).  So the kernel computes the decoders'
effective precision (`model.decoder_matmul_precision`, else the session's
`matmul_precision`): 3xTF32 for the float32 names, one or three bfloat16
passes for the others.  For BF16_BF16_F32_X6 / _X9, which the kernel has
no mode for, the queries take the decoders' own forward, chosen when the
mesher is built (`renderer.with_fused_eval`, which warns).  The seen-frame
projection and the hull test are products at the session's precision.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Mapping, NamedTuple

import numpy as np
import torch
from torch import nn

from nice_slam_tpu_torch.core.cameras import Intrinsics
from nice_slam_tpu_torch.engine.frustum import bilinear_sample_zero_border
from nice_slam_tpu_torch.mesh.native import marching_tetrahedra
from nice_slam_tpu_torch.models.grids import prepare_grids
from nice_slam_tpu_torch.models.precision import matmul
from nice_slam_tpu_torch.parallel.sharded import sharded_eval_points
from nice_slam_tpu_torch.render.renderer import (
    RenderConfig, SceneModel, eval_raw, render_rays, with_fused_eval)


class MesherConfig(NamedTuple):
    """Static meshing parameters (config `meshing.*`)."""

    resolution: int = 256
    level_set: float = 0.0
    clean_mesh: bool = True
    depth_test: bool = False
    mesh_coarse_level: bool = False
    clean_mesh_bound_scale: float = 1.02
    get_largest_components: bool = False
    remove_small_geometry_threshold: float = 0.2
    color_mesh_extraction_method: str = 'direct_point_query'
    points_batch: int = 262144
    marching_cubes_bound: tuple = ()
    scale: float = 1.0


class Mesher:
    def __init__(self, mcfg: MesherConfig, model: SceneModel,
                 intr: Intrinsics, *, rcfg: RenderConfig | None = None,
                 group=None):
        """`group`: ranks (parallel/mesh.RankGroup) that split the field
        queries between them; every rank of it runs the same
        extraction."""
        self.cfg = mcfg
        self.group = group if group is not None and group.size > 1 else None
        # every query of the mesher is forward-only: the fused kernel, at
        # the decoders' effective precision when it has a mode for it
        self.model = with_fused_eval(model)
        self.intr = intr
        self.device = model.bound.device
        self._ray_rcfg = rcfg if rcfg is not None else RenderConfig()
        self._lattice = None
        self._dev_cache: dict[str, torch.Tensor] = {}
        self.timings: dict[str, float] = {}
        # the stage whose last channel is the geometry
        self.geo_stage = 'fine' if model.kind == 'nice' else 'color'

    @contextlib.contextmanager
    def _timed(self, piece: str):
        t0 = time.perf_counter()
        yield
        self.timings[piece] = (self.timings.get(piece, 0.0)
                               + time.perf_counter() - t0)

    # ------------------------------------------------------------------
    # lattice + field evaluation
    # ------------------------------------------------------------------

    def lattice(self):
        """Query lattice (points [R^3, 3] float32 x-major, xs, ys, zs):
        linspace over the padded marching-cubes bound; cached."""
        if self._lattice is None:
            res = self.cfg.resolution
            b = np.asarray(self.cfg.marching_cubes_bound, dtype=np.float64)
            pad = 0.05
            xs, ys, zs = (np.linspace(b[a, 0] - pad, b[a, 1] + pad, res)
                          for a in range(3))
            gx, gy, gz = np.meshgrid(xs, ys, zs, indexing='ij')
            pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
            self._lattice = (pts.astype(np.float32), xs, ys, zs)
        return self._lattice

    def _points(self, points: np.ndarray, cache: str | None = None
                ) -> torch.Tensor:
        """Host points on the device in one upload; `cache` keeps it (the
        lattice is the same for every extraction)."""
        if cache is not None and cache in self._dev_cache:
            return self._dev_cache[cache]
        dev = torch.as_tensor(np.ascontiguousarray(points, np.float32),
                              device=self.device)
        if cache is not None:
            self._dev_cache[cache] = dev
        return dev

    def _chunks(self, n: int):
        step = self.cfg.points_batch
        return ((i, min(i + step, n)) for i in range(0, n, step))

    def eval_field(self, decoders: Mapping[str, nn.Module], grids: Mapping,
                   points: np.ndarray, stage: str,
                   column: slice | int = 3, cache: str | None = None
                   ) -> np.ndarray:
        """Decoder outputs at host points, evaluated on the device in
        `points_batch` chunks into one preallocated tensor, copied to the
        host once."""
        pts = self._points(points, cache)
        n = len(pts)
        width = () if isinstance(column, int) else (
            len(range(4)[column]),)
        out = torch.empty((n,) + width, device=self.device)
        with torch.no_grad():
            for i, j in self._chunks(n):
                if self.group is not None:
                    raw = sharded_eval_points(decoders, grids, pts[i:j],
                                              stage, self.model, self.group)
                else:
                    raw = eval_raw(decoders, grids, pts[i:j], stage,
                                   self.model)
                out[i:j] = raw[:, column]
        return out.cpu().numpy()

    # ------------------------------------------------------------------
    # visibility
    # ------------------------------------------------------------------

    def _seen_one_frame(self, pts: torch.Tensor, c2w: torch.Tensor,
                        depth: torch.Tensor | None, edge: int
                        ) -> torch.Tensor:
        """Project points into one frame (OpenGL camera: forward is -z);
        with `depth`, also require the point not far behind the surface."""
        intr = self.intr
        w2c = torch.linalg.inv(c2w)
        ones = torch.ones_like(pts[:, :1])
        cam = matmul(torch.cat([pts, ones], dim=1), w2c.T,
                     self.model.matmul_precision)[:, :3]
        z = cam[:, 2] + 1e-5
        u = (intr.fx * (-cam[:, 0]) + intr.cx * z) / z
        v = (intr.fy * cam[:, 1] + intr.cy * z) / z
        inb = ((u < intr.W - edge) & (u > edge)
               & (v < intr.H - edge) & (v > edge) & (z < 0))
        if depth is not None:
            sampled = bilinear_sample_zero_border(depth, u, v)
            proj_depth = -z
            inb = inb & ((proj_depth > 0) & (proj_depth < sampled + 2.4)
                         & (sampled > 0))
        return inb

    def seen_mask(self, points: np.ndarray, c2ws: list[np.ndarray],
                  depths: list[np.ndarray] | None, *, edge: int = 0,
                  use_depth: bool = False, cache: str | None = None
                  ) -> np.ndarray:
        """Union of per-frame visibility over all given frames."""
        if len(c2ws) == 0:
            return np.zeros((len(points),), dtype=bool)
        pts = self._points(points, cache)
        c2w_t = [torch.as_tensor(np.asarray(c, np.float32),
                                 device=self.device) for c in c2ws]
        d_t = ([torch.as_tensor(np.asarray(d, np.float32),
                                device=self.device) for d in depths]
               if use_depth else [None] * len(c2ws))
        out = torch.zeros((len(pts),), dtype=torch.bool, device=self.device)
        for i, j in self._chunks(len(pts)):
            for c2w, d in zip(c2w_t, d_t):
                out[i:j] |= self._seen_one_frame(pts[i:j], c2w, d, edge)
        return out.cpu().numpy()

    # ------------------------------------------------------------------
    # scene hull
    # ------------------------------------------------------------------

    def scene_hull(self, keyframes, depth_stride: int = 8) -> np.ndarray:
        """Half-space equations [F, 4] of the convex hull of the
        back-projected keyframe depth and the camera centres, scaled by
        clean_mesh_bound_scale: p is inside iff max_f(eq[f, :3].p +
        eq[f, 3]) <= 0."""
        from scipy.spatial import ConvexHull

        intr = self.intr
        jj, ii = np.meshgrid(
            np.arange(0, intr.H, depth_stride, dtype=np.float64),
            np.arange(0, intr.W, depth_stride, dtype=np.float64),
            indexing='ij')
        pts_all = []
        for kf in keyframes.frames:
            d = kf.depth[::depth_stride, ::depth_stride].astype(np.float64)
            valid = d > 0
            dirs = np.stack([(ii - intr.cx) / intr.fx,
                             -(jj - intr.cy) / intr.fy,
                             -np.ones_like(ii)], axis=-1)
            world = kf.est_c2w[:3, 3] + (dirs @ kf.est_c2w[:3, :3].T) \
                * d[..., None]
            pts_all.append(world[valid])
            pts_all.append(kf.est_c2w[None, :3, 3])
        cloud = np.concatenate(pts_all, axis=0)
        hull = ConvexHull(cloud)
        hull_pts = cloud[hull.vertices] * self.cfg.clean_mesh_bound_scale
        return ConvexHull(hull_pts).equations.astype(np.float32)

    def inside_hull(self, points: np.ndarray, equations: np.ndarray,
                    tol: float = 1e-6, cache: str | None = None
                    ) -> np.ndarray:
        """Convex-hull membership from the half-space equations, one
        [chunk, 3] x [3, F] product per chunk on the device, at the
        session's precision."""
        pts = self._points(points, cache)
        eq = torch.as_tensor(equations, device=self.device)
        out = torch.empty((len(pts),), dtype=torch.bool, device=self.device)
        for i, j in self._chunks(len(pts)):
            d = matmul(pts[i:j], eq[:, :3].T,
                       self.model.matmul_precision) + eq[:, 3]
            out[i:j] = torch.amax(d, dim=1) <= tol
        return out.cpu().numpy()

    # ------------------------------------------------------------------
    # extraction
    # ------------------------------------------------------------------

    def field(self, decoders, grids, keyframes, *,
              show_forecast: bool | None = None):
        """The lattice field [R, R, R] of `extract` (grids as stored; one
        corner expansion serves the whole query) and the seen mask of the
        forecast path (None otherwise)."""
        cfg = self.cfg
        show_forecast = (cfg.mesh_coarse_level if show_forecast is None
                         else show_forecast)
        points = self.lattice()[0]
        kf_c2ws = [kf.est_c2w for kf in keyframes.frames]
        kf_depths = [kf.depth for kf in keyframes.frames]
        seen = None
        if show_forecast:
            with self._timed('seen_s'):
                seen = self.seen_mask(points, kf_c2ws, kf_depths,
                                      use_depth=cfg.depth_test,
                                      cache='lattice')
                forecast = self.seen_mask(points, kf_c2ws, None, edge=-1000,
                                          cache='lattice') & ~seen
            z = np.full((len(points),), -100.0, dtype=np.float32)
            with self._timed('query_s'):
                if seen.any():
                    z[seen] = self.eval_field(decoders, grids, points[seen],
                                              self.geo_stage)
                if forecast.any():
                    z[forecast] = self.eval_field(
                        decoders, grids, points[forecast], 'coarse') + 0.2
        else:
            with self._timed('hull_s'):
                if len(keyframes.frames) > 0:
                    eqs = self.scene_hull(keyframes)
                    inside = self.inside_hull(points, eqs, cache='lattice')
                else:
                    inside = np.ones((len(points),), dtype=bool)
            with self._timed('query_s'):
                z = self.eval_field(decoders, grids, points, self.geo_stage,
                                    cache='lattice')
            z[~inside] = 100.0
        res = cfg.resolution
        return z.reshape(res, res, res), seen

    def surface(self, field: np.ndarray, keyframes,
                estimate_c2w: np.ndarray, idx: int, *,
                clean_mesh: bool | None = None,
                get_mask_use_all_frames: bool = False):
        """Marching tetrahedra of the field, then the visibility cull and
        the component filter; returns (verts, tris), or None when no
        surface crosses the level set."""
        cfg = self.cfg
        clean_mesh = cfg.clean_mesh if clean_mesh is None else clean_mesh
        _, xs, ys, zs = self.lattice()
        with self._timed('marching_s'):
            verts, tris = marching_tetrahedra(field, xs, ys, zs,
                                              cfg.level_set)
        if len(verts) == 0:
            return None
        if not clean_mesh:
            return verts, tris
        with self._timed('seen_s'):
            if get_mask_use_all_frames:
                frames = [estimate_c2w[i] for i in range(idx + 1)]
                v_seen = self.seen_mask(verts, frames, None, use_depth=False)
            else:
                v_seen = self.seen_mask(
                    verts, [kf.est_c2w for kf in keyframes.frames],
                    [kf.depth for kf in keyframes.frames],
                    use_depth=cfg.depth_test)
        with self._timed('components_s'):
            # cull faces whose three vertices are all unseen
            tris = tris[v_seen[tris].any(axis=1)]
            verts, tris = _compact(verts, tris)
            return _filter_components(
                verts, tris, largest=cfg.get_largest_components,
                min_area=cfg.remove_small_geometry_threshold
                * cfg.scale ** 2)

    def extract(self, out_file: str, decoders: Mapping[str, nn.Module],
                grids: Mapping, keyframes, estimate_c2w: np.ndarray,
                idx: int, *, show_forecast: bool | None = None,
                color: bool = True, clean_mesh: bool | None = None,
                get_mask_use_all_frames: bool = False) -> str | None:
        """The whole pipeline: field, surface, vertex colors, PLY (none
        written when `out_file` is None)."""
        cfg = self.cfg
        show_forecast = (cfg.mesh_coarse_level if show_forecast is None
                         else show_forecast)
        self.timings = {}
        if self.model.kind == 'nice':
            with self._timed('expand_s'), torch.no_grad():
                grids = prepare_grids(grids, self.model.grid_shapes)
                if self.device.type == 'cuda':
                    torch.cuda.synchronize(self.device)
        field, seen = self.field(decoders, grids, keyframes,
                                 show_forecast=show_forecast)
        surf = self.surface(
            field, keyframes, estimate_c2w, idx, clean_mesh=clean_mesh,
            get_mask_use_all_frames=get_mask_use_all_frames)
        if surf is None:
            print('mesher: no surface crossed the level set')
            return None
        verts, tris = surf

        colors = None
        if color and len(verts):
            with self._timed('color_s'):
                colors = self._vertex_colors(decoders, grids, verts, tris)
            if show_forecast and seen is not None:
                v_forecast = ~self.seen_mask(
                    verts, [kf.est_c2w for kf in keyframes.frames],
                    [kf.depth for kf in keyframes.frames],
                    use_depth=cfg.depth_test)
                colors[v_forecast] = np.array([0, 255, 255], np.uint8)

        if out_file is None:
            return None
        with self._timed('ply_s'):
            save_ply(out_file, verts / cfg.scale, tris, colors)
        return out_file

    def _vertex_colors(self, decoders, grids, verts, tris) -> np.ndarray:
        """uint8 RGB per vertex, by `color_mesh_extraction_method`."""
        if self.cfg.color_mesh_extraction_method == 'direct_point_query':
            rgb = self.eval_field(decoders, grids, verts.astype(np.float32),
                                  'color', column=slice(0, 3))
        else:   # 'render_ray_along_normal'
            rgb = self._color_along_normals(decoders, grids, verts, tris)
        return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)

    def _color_along_normals(self, decoders, grids, verts, tris,
                             length: float = 0.1) -> np.ndarray:
        """Render a short ray along each vertex normal and take its color:
        origin 0.1 behind the vertex, gt_depth 0.1, so the surface samples
        bracket the vertex."""
        normals = vertex_normals(verts, tris)
        rays_o = torch.as_tensor((verts - length * normals).astype(
            np.float32), device=self.device)
        rays_d = torch.as_tensor(normals.astype(np.float32),
                                 device=self.device)
        out = torch.empty((len(verts), 3), device=self.device)
        chunk = self.cfg.points_batch // 64
        with torch.no_grad():
            for i in range(0, len(verts), chunk):
                o, d = rays_o[i:i + chunk], rays_d[i:i + chunk]
                _, _, col, _ = render_rays(
                    decoders, grids, o, d, stage='color', model=self.model,
                    rcfg=self._ray_rcfg,
                    gt_depth=torch.full((len(o),), length,
                                        device=self.device))
                out[i:i + len(o)] = col
        return out.cpu().numpy()


def vertex_normals(verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (the ray-along-normal color path)."""
    fn = np.cross(verts[tris[:, 1]] - verts[tris[:, 0]],
                  verts[tris[:, 2]] - verts[tris[:, 0]])
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, tris[:, k], fn)
    norm = np.linalg.norm(vn, axis=1, keepdims=True)
    norm[norm == 0] = 1.0
    return vn / norm


def _compact(verts: np.ndarray, tris: np.ndarray):
    """Drop vertices unused by any face and reindex."""
    used = np.unique(tris)
    remap = np.full((len(verts),), -1, dtype=np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[tris].astype(np.int32)


def _filter_components(verts: np.ndarray, tris: np.ndarray, *,
                       largest: bool, min_area: float):
    """Connected-component filtering: keep the largest component, or drop
    components below the area threshold."""
    if len(tris) == 0:
        return verts, tris
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    n = len(verts)
    e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [0, 2]]])
    adj = coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])), shape=(n, n))
    n_comp, labels = connected_components(adj, directed=False)
    if n_comp <= 1:
        return verts, tris

    face_label = labels[tris[:, 0]]
    a = verts[tris[:, 1]] - verts[tris[:, 0]]
    b = verts[tris[:, 2]] - verts[tris[:, 0]]
    face_area = 0.5 * np.linalg.norm(np.cross(a, b), axis=1)
    areas = np.bincount(face_label, weights=face_area, minlength=n_comp)

    if largest:
        keep_labels = {int(np.argmax(areas))}
    else:
        keep_labels = {i for i in range(n_comp) if areas[i] >= min_area}
    keep = np.isin(face_label, list(keep_labels))
    return _compact(verts, tris[keep])


# ---------------------------------------------------------------------------
# PLY I/O
# ---------------------------------------------------------------------------

def save_ply(path: str, verts: np.ndarray, tris: np.ndarray,
             colors: np.ndarray | None = None) -> None:
    """Binary little-endian PLY writer; the file appears whole (written
    beside it, then moved into place), for the live dashboard's reader."""
    n_v, n_f = len(verts), len(tris)
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        hdr = ['ply', 'format binary_little_endian 1.0',
               f'element vertex {n_v}',
               'property float x', 'property float y', 'property float z']
        if colors is not None:
            hdr += ['property uchar red', 'property uchar green',
                    'property uchar blue']
        hdr += [f'element face {n_f}',
                'property list uchar int vertex_indices', 'end_header']
        f.write(('\n'.join(hdr) + '\n').encode())
        if colors is not None:
            body_v = np.empty((n_v,), dtype=[('xyz', '<f4', 3),
                                             ('rgb', 'u1', 3)])
            body_v['xyz'] = verts.astype('<f4')
            body_v['rgb'] = colors.astype(np.uint8)
            f.write(body_v.tobytes())
        else:
            f.write(verts.astype('<f4').tobytes())
        counts = np.full((n_f, 1), 3, dtype=np.uint8)
        body = np.empty((n_f,), dtype=[('n', 'u1'), ('idx', '<i4', 3)])
        body['n'] = counts[:, 0]
        body['idx'] = tris.astype('<i4')
        f.write(body.tobytes())
    os.replace(tmp, path)


def load_ply(path: str):
    """Minimal binary/ascii PLY reader for our own files and simple
    external ones (eval tooling).  Returns (verts, tris)."""
    with open(path, 'rb') as f:
        header = []
        while True:
            line = f.readline().decode('ascii', 'replace').strip()
            header.append(line)
            if line == 'end_header':
                break
        n_v = n_f = 0
        v_props = []
        fmt = 'binary_little_endian'
        elem = None
        for line in header:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == 'format':
                fmt = parts[1]
            elif parts[0] == 'element':
                elem = parts[1]
                if elem == 'vertex':
                    n_v = int(parts[2])
                elif elem == 'face':
                    n_f = int(parts[2])
            elif parts[0] == 'property' and elem == 'vertex' \
                    and parts[1] != 'list':
                v_props.append((parts[2], parts[1]))

        type_map = {'float': '<f4', 'float32': '<f4', 'double': '<f8',
                    'uchar': 'u1', 'uint8': 'u1', 'int': '<i4',
                    'uint': '<u4', 'short': '<i2', 'ushort': '<u2'}
        if fmt.startswith('ascii'):
            verts = np.zeros((n_v, 3), np.float32)
            for i in range(n_v):
                vals = f.readline().split()
                verts[i] = [float(vals[k]) for k in range(3)]
            tris = np.zeros((n_f, 3), np.int32)
            for i in range(n_f):
                vals = f.readline().split()
                tris[i] = [int(vals[1]), int(vals[2]), int(vals[3])]
            return verts, tris

        vdt = np.dtype([(name, type_map[t]) for name, t in v_props])
        vdata = np.frombuffer(f.read(n_v * vdt.itemsize), dtype=vdt,
                              count=n_v)
        verts = np.stack([vdata['x'], vdata['y'], vdata['z']],
                         axis=-1).astype(np.float32)
        fdt = np.dtype([('n', 'u1'), ('idx', '<i4', 3)])
        fdata = np.frombuffer(f.read(n_f * fdt.itemsize), dtype=fdt,
                              count=n_f)
        tris = fdata['idx'].astype(np.int32)
        return verts, tris
