"""ctypes loader for the port's native geometry library; port of
`nice_slam_tpu/mesh/native/__init__.py`.

`csrc/geometry.cpp` (the port's own copy of the JAX package's source) is
compiled with g++ at first use into the checkout's `build/` directory
(ops/build.py), never beside the source.  It provides marching tetrahedra
(the mesher's iso-surface) and a z-buffer depth rasterizer (the 2-D
reconstruction metric).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from nice_slam_tpu_torch.ops.build import (
    BUILD_DIR, CSRC, compile_cpp, is_stale)

SOURCE = os.path.join(CSRC, 'geometry.cpp')
LIBRARY = os.path.join(BUILD_DIR, 'libnst_geometry.so')

_lib = None

_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_i32p = ctypes.POINTER(ctypes.c_int)


def build_library() -> str:
    """Compile csrc/geometry.cpp into build/."""
    return compile_cpp(SOURCE, LIBRARY)


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if is_stale(SOURCE, LIBRARY):
        build_library()
    lib = ctypes.CDLL(LIBRARY)
    lib.nstpu_marching_tetrahedra.restype = ctypes.c_int
    lib.nstpu_marching_tetrahedra.argtypes = [
        _f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,   # field, nx ny nz
        _f64p, _f64p, _f64p,                               # xs ys zs
        ctypes.c_float,                                    # level
        ctypes.POINTER(_f32p), ctypes.POINTER(_i32p),      # out verts, tris
        _i32p, _i32p,                                      # n_verts, n_tris
    ]
    lib.nstpu_free.argtypes = [ctypes.c_void_p]
    lib.nstpu_free.restype = None
    lib.nstpu_rasterize_depth.argtypes = [
        _f32p, ctypes.c_int, _i32p, ctypes.c_int,          # verts, tris
        _f32p,                                             # w2c (4x4)
        ctypes.c_float, ctypes.c_float,                    # fx fy
        ctypes.c_float, ctypes.c_float,                    # cx cy
        ctypes.c_int, ctypes.c_int,                        # H W
        _f32p,                                             # out depth
    ]
    lib.nstpu_rasterize_depth.restype = None
    _lib = lib
    return lib


def marching_tetrahedra(field: np.ndarray, xs: np.ndarray, ys: np.ndarray,
                        zs: np.ndarray, level: float
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Iso-surface of a scalar field [nx, ny, nz] (float32, x-major) on
    the lattice with axis coordinates xs/ys/zs (float64).  Returns
    (verts [V, 3] float32, tris [T, 3] int32), a shared-vertex mesh."""
    lib = get_lib()
    field = np.ascontiguousarray(field, dtype=np.float32)
    xs, ys, zs = (np.ascontiguousarray(a, dtype=np.float64)
                  for a in (xs, ys, zs))
    if field.ndim != 3 or field.shape != (len(xs), len(ys), len(zs)):
        raise ValueError(f'marching_tetrahedra: field {field.shape} does not '
                         f'match the axes ({len(xs)}, {len(ys)}, {len(zs)})')
    nx, ny, nz = field.shape
    out_v, out_t = _f32p(), _i32p()
    nv, nt = ctypes.c_int(), ctypes.c_int()
    rc = lib.nstpu_marching_tetrahedra(
        field.ctypes.data_as(_f32p), nx, ny, nz, xs.ctypes.data_as(_f64p),
        ys.ctypes.data_as(_f64p), zs.ctypes.data_as(_f64p),
        ctypes.c_float(level), ctypes.byref(out_v), ctypes.byref(out_t),
        ctypes.byref(nv), ctypes.byref(nt))
    if rc != 0:
        raise MemoryError('marching_tetrahedra allocation failed')
    try:
        verts = (np.ctypeslib.as_array(out_v, shape=(nv.value, 3)).copy()
                 if nv.value else np.zeros((0, 3), np.float32))
        tris = (np.ctypeslib.as_array(out_t, shape=(nt.value, 3)).copy()
                if nt.value else np.zeros((0, 3), np.int32))
    finally:
        lib.nstpu_free(out_v)
        lib.nstpu_free(out_t)
    return verts, tris


def rasterize_depth(verts: np.ndarray, tris: np.ndarray, w2c: np.ndarray,
                    fx: float, fy: float, cx: float, cy: float,
                    h: int, w: int) -> np.ndarray:
    """Depth image [h, w] of the mesh (CV pinhole, +z forward); 0 where no
    triangle covers the pixel."""
    lib = get_lib()
    verts = np.ascontiguousarray(verts, dtype=np.float32)
    tris = np.ascontiguousarray(tris, dtype=np.int32)
    w2c = np.ascontiguousarray(w2c, dtype=np.float32)
    if (verts.ndim != 2 or verts.shape[1] != 3 or tris.ndim != 2
            or tris.shape[1] != 3 or w2c.shape != (4, 4)):
        raise ValueError('rasterize_depth: verts [V, 3], tris [T, 3] and a '
                         '4x4 w2c expected')
    if len(tris) and (tris.min() < 0 or tris.max() >= len(verts)):
        raise ValueError('rasterize_depth: a triangle indexes past the '
                         'vertices')
    out = np.zeros((h, w), dtype=np.float32)
    lib.nstpu_rasterize_depth(
        verts.ctypes.data_as(_f32p), len(verts), tris.ctypes.data_as(_i32p),
        len(tris), w2c.ctypes.data_as(_f32p), fx, fy, cx, cy, h, w,
        out.ctypes.data_as(_f32p))
    return out
