"""Corner expansion of flat feature grids and its transpose (the fold).

`expand_corners` turns a flat [M, C] grid (M = nx*ny*nz, x-major) into the
[M, 8C] buffer whose row m holds the 8 edge-clamped corner neighbours of
voxel m, corner k = dx*4 + dy*2 + dz in channels [kC, (k+1)C)
(`ops/trilinear.ExpandedGrid`).  `fold_corners` is its exact transpose, the
gradient of the expansion.  The mapper runs both on every iteration; the
tracker expands once per mapping commit.

Each wrapper launches the CUDA kernel of `csrc/expand.cu` for a CUDA tensor
and uses the plain PyTorch version for a CPU tensor: there is no fallback
from one to the other.  The kernels replace the TPU kernels of
`nice_slam_tpu/ops/pallas/expand.py` (`_expand_kernel`/`_expand_kernel_chunked`
and `_fold_kernel`/`_fold_kernel_chunked`); the source note in the .cu file
says what bounds them on an H100.  The library is built with nvcc into the
checkout's `build/` directory at first use.

`LAUNCHES` counts kernel launches, one per launch and nowhere else, so a
run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import os

import torch

from nice_slam_tpu_torch.ops.build import (
    BUILD_DIR, CSRC, compile_cuda, is_stale)

SOURCE = os.path.join(CSRC, 'expand.cu')
LIBRARY = os.path.join(BUILD_DIR, 'libnst_expand.so')

LAUNCHES = {'expand_corners': 0, 'fold_corners': 0}

_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_library() -> str:
    """Compile csrc/expand.cu for sm_90a into build/ and return the
    compiler's register/spill report."""
    return compile_cuda(SOURCE, LIBRARY)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        if is_stale(SOURCE, LIBRARY):
            build_library()
        lib = ctypes.CDLL(LIBRARY)
        for fn in (lib.nst_expand_corners, lib.nst_fold_corners):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_cuda_f32(x: torch.Tensor, name: str, rows: int, width: int
                    ) -> None:
    if x.dtype != torch.float32 or not x.is_contiguous() or x.dim() != 2:
        raise ValueError(f'{name}: needs a contiguous 2-D float32 tensor, '
                         f'got {x.dtype} {tuple(x.shape)} '
                         f'contiguous={x.is_contiguous()}')
    if x.shape[0] != rows or x.shape[1] != width:
        raise ValueError(f'{name}: shape {tuple(x.shape)} != ({rows}, '
                         f'{width})')
    if x.data_ptr() % 16:
        raise ValueError(f'{name}: data pointer not 16-byte aligned')


def _launch(fn, src: torch.Tensor, dst: torch.Tensor, shape, c: int) -> None:
    nx, ny, nz = shape
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = fn(ctypes.c_void_p(src.data_ptr()),
                 ctypes.c_void_p(dst.data_ptr()), nx, ny, nz, c,
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f'{fn.__name__}: CUDA launch failed with '
                           f'error {err}')


# ---------------------------------------------------------------------------
# plain PyTorch versions (run on any device; the wrappers use them for CPU
# tensors, and the tests and chip_smoke.py hold the kernels against them)
# ---------------------------------------------------------------------------

def expand_plain(grid: torch.Tensor, shape: tuple[int, int, int]
                 ) -> torch.Tensor:
    """[M, C] -> [M, 8C] by slices and concatenation (transcription of
    `nice_slam_tpu.ops.trilinear.expand_grid_xla`); pure copies, so it is
    bit-identical to the JAX expansion and to the CUDA kernel."""
    nx, ny, nz = shape
    g = grid.reshape(nx, ny, nz, grid.shape[-1])
    blocks = []
    for dx in (0, 1):
        gx = g if dx == 0 else torch.cat([g[1:], g[-1:]], dim=0)
        for dy in (0, 1):
            gy = gx if dy == 0 else torch.cat([gx[:, 1:], gx[:, -1:]], dim=1)
            for dz in (0, 1):
                gz = gy if dz == 0 else torch.cat(
                    [gy[:, :, 1:], gy[:, :, -1:]], dim=2)
                blocks.append(gz)
    return torch.cat(blocks, dim=-1).reshape(nx * ny * nz, -1)


def _shift_t(w: torch.Tensor, axis: int) -> torch.Tensor:
    """Transpose of the clamped +1 shift along `axis`:
    out[a] = w[a-1] (a >= 1), plus w[n-1] at the last index."""
    n = w.shape[axis]
    out = torch.zeros_like(w)
    out.narrow(axis, 1, n - 1).copy_(w.narrow(axis, 0, n - 1))
    out.narrow(axis, n - 1, 1).add_(w.narrow(axis, n - 1, 1))
    return out


def fold_plain(de: torch.Tensor, shape: tuple[int, int, int]
               ) -> torch.Tensor:
    """[M, 8C] -> [M, C]: the transpose of `expand_plain`, written out as
    per-axis shifted adds (not through autograd)."""
    nx, ny, nz = shape
    c = de.shape[-1] // 8
    d = de.reshape(nx, ny, nz, 8, c)
    out = torch.zeros((nx, ny, nz, c), dtype=de.dtype, device=de.device)
    for k in range(8):
        w = d[:, :, :, k]
        if k >> 2:
            w = _shift_t(w, 0)
        if (k >> 1) & 1:
            w = _shift_t(w, 1)
        if k & 1:
            w = _shift_t(w, 2)
        out += w
    return out.reshape(nx * ny * nz, c)


# ---------------------------------------------------------------------------
# wrappers: the CUDA kernel for CUDA tensors, the plain version for CPU ones
# ---------------------------------------------------------------------------

def expand_corners(grid: torch.Tensor, shape: tuple[int, int, int]
                   ) -> torch.Tensor:
    """Corner-expand a flat [M, C] grid to [M, 8C]."""
    if grid.device.type == 'cpu':
        return expand_plain(grid, shape)
    if grid.device.type != 'cuda':
        raise ValueError(f'expand_corners: unsupported device {grid.device}')
    m, c = shape[0] * shape[1] * shape[2], grid.shape[-1]
    if c % 4:
        raise ValueError(f'expand_corners: C={c} is not a multiple of 4')
    _check_cuda_f32(grid, 'expand_corners', m, c)
    out = torch.empty((m, 8 * c), dtype=grid.dtype, device=grid.device)
    _launch(_library().nst_expand_corners, grid, out, shape, c)
    LAUNCHES['expand_corners'] += 1
    return out


def fold_corners(de: torch.Tensor, shape: tuple[int, int, int]
                 ) -> torch.Tensor:
    """Fold an [M, 8C] expansion gradient back onto the [M, C] grid."""
    if de.device.type == 'cpu':
        return fold_plain(de, shape)
    if de.device.type != 'cuda':
        raise ValueError(f'fold_corners: unsupported device {de.device}')
    m, c8 = shape[0] * shape[1] * shape[2], de.shape[-1]
    if c8 % 32:
        raise ValueError(f'fold_corners: width {c8} is not 8*C with C a '
                         'multiple of 4')
    _check_cuda_f32(de, 'fold_corners', m, c8)
    out = torch.empty((m, c8 // 8), dtype=de.dtype, device=de.device)
    _launch(_library().nst_fold_corners, de, out, shape, c8 // 8)
    LAUNCHES['fold_corners'] += 1
    return out


class ExpandCorners(torch.autograd.Function):
    """Differentiable corner expansion: forward `expand_corners`, backward
    `fold_corners` (the TPU package's custom_vjp, expand.py:453-472)."""

    @staticmethod
    def forward(ctx, grid: torch.Tensor, shape: tuple[int, int, int]):
        ctx.shape = shape
        return expand_corners(grid, shape)

    @staticmethod
    def backward(ctx, d_e: torch.Tensor):
        return fold_corners(d_e.contiguous(), ctx.shape), None
