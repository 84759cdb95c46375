"""Row gather `table[idx]` and its adjoint, the row scatter-add.

`gather_rows(table [M, W], idx [N]) -> [N, W]` is the lookup under every
grid sample of the main path: `ops/trilinear.trilinear_interp_expanded`
gathers one corner-expanded [8C] row per point (W = 256 for the middle
volume, 512 for the fused fine+color one).  `scatter_add_rows(grad [N, W],
idx [N], M) -> [M, W]` is its gradient: each gradient row added into row
idx[i] of a zeroed buffer; `GatherRows` pairs them for autograd.  The index
may be int32 or int64.

Each wrapper launches the CUDA kernels of `csrc/gather.cu` for a CUDA
tensor and uses the plain PyTorch version for a CPU tensor: there is no
fallback from one to the other.  The kernels replace the Pallas row gathers
of the gather studies (`scripts/studies/proto_gather_sweep.py`
`pallas_gather_tiles`, `proto_pallas_gather.py` `pallas_gather_rows`,
`proto_gather_paths.py` `pallas_gather`); the source note in the .cu file
gives the designs and what bounds them on an H100.  In short:

* the gather is a copy, bit-exact: a group of lanes per row, the index read
  once per row and broadcast, 16 loads in flight per lane (several rows'
  before any store); one launch.  At a tracking iteration's 9,600 rows its
  device work is ~10 us, so the host path matters as much: the wrapper
  checks what guards the kernel with attribute tests and calls the library
  through `ops/build.launch` (pointers and the stream as Python ints).
* the scatter is sort-free and deterministic: int-atomic counts per target
  row, a scan into CSR offsets, the positions placed into their segments,
  each segment put in ascending order by one writer (a thread for up to 32
  positions; a block and a shared-memory bitmap for a longer, listed row),
  then sums that only read the ordered positions and add each row's
  gradient rows from 0 in that order, writing every row once (zeros where
  no position hits): a warp per listed row and 32-column slice, a group of
  lanes per eight short rows and 16-byte column slice.  That order is the
  one PyTorch's sort-based `index_put_` with accumulate forms on the card
  and `index_add_` on the CPU, so the bits are theirs;
  `scatter_add_rows_ordered_plain` writes the grouping out in PyTorch.  A
  call makes one memset and eight kernels; the scratch is one int32
  `torch.empty` of the wrapper's.

An index outside [0, M) fails a device-side assertion in the gather and in
the scatter's count kernel, as `table[idx]` does on the card (the next
synchronizing call raises).

`LAUNCHES` counts calls that launch the kernels, one per call and nowhere
else.
"""

from __future__ import annotations

import ctypes
import os

import torch

from nice_slam_tpu_torch.ops.build import (
    BUILD_DIR, CSRC, compile_cuda, is_stale, launch)

SOURCE = os.path.join(CSRC, 'gather.cu')
LIBRARY = os.path.join(BUILD_DIR, 'libnst_gather.so')

LAUNCHES = {'gather_rows': 0, 'scatter_add_rows': 0}

_INDEX_TYPES = (torch.int32, torch.int64)

_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_library() -> str:
    """Compile csrc/gather.cu for sm_90a into build/ and return the
    compiler's register/spill report."""
    return compile_cuda(SOURCE, LIBRARY)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        if is_stale(SOURCE, LIBRARY):
            build_library()
        lib = ctypes.CDLL(LIBRARY)
        lib.nst_gather_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p]
        lib.nst_scatter_add_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_void_p]
        for fn in (lib.nst_gather_rows, lib.nst_scatter_add_rows):
            fn.restype = ctypes.c_int
        lib.nst_scatter_scratch_ints.argtypes = [ctypes.c_longlong,
                                                 ctypes.c_longlong]
        lib.nst_scatter_scratch_ints.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def _check(rows: torch.Tensor, idx: torch.Tensor, name: str) -> int:
    """Raise on what the kernels do not take; each test is one attribute
    read.  Returns the device index."""
    if (rows.dtype != torch.float32 or rows.dim() != 2
            or not rows.is_contiguous() or rows.shape[1] % 4
            or rows.data_ptr() % 16):
        raise ValueError(f'{name}: needs a contiguous, 16-byte aligned 2-D '
                         f'float32 tensor of a width that is a multiple of '
                         f'4, got {rows.dtype} {tuple(rows.shape)} '
                         f'contiguous={rows.is_contiguous()}')
    device = rows.get_device()
    if (idx.dtype not in _INDEX_TYPES or idx.dim() != 1
            or not idx.is_contiguous() or idx.get_device() != device):
        raise ValueError(f'{name}: needs a contiguous 1-D int32 or int64 '
                         f'index on {rows.device}, got {idx.dtype} '
                         f'{tuple(idx.shape)} on {idx.device}')
    return device


# ---------------------------------------------------------------------------
# plain PyTorch versions (the wrappers use them for CPU tensors; the tests
# and chip_smoke.py hold the kernels against them)
# ---------------------------------------------------------------------------

def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor
                      ) -> torch.Tensor:
    return table[idx]


def scatter_add_rows_plain(grad: torch.Tensor, idx: torch.Tensor, m: int
                           ) -> torch.Tensor:
    out = torch.zeros((m, grad.shape[1]), dtype=grad.dtype,
                      device=grad.device)
    return out.index_add_(0, idx, grad)


def scatter_add_rows_ordered_plain(grad: torch.Tensor, idx: torch.Tensor,
                                   m: int) -> torch.Tensor:
    """The scatter kernel's grouping written in PyTorch: counts per target
    row (bincount), CSR offsets (cumsum), each segment's positions in
    ascending order, each segment summed from 0 in that order (step k adds
    the k-th position of every segment that long).  It documents the order
    the kernel forms; nothing on the main path calls it."""
    idx = idx.long()
    counts = torch.bincount(idx, minlength=m)
    offsets = torch.cumsum(counts, 0) - counts
    positions = torch.argsort(idx, stable=True)   # ascending in each segment
    out = torch.zeros((m, grad.shape[1]), dtype=grad.dtype,
                      device=grad.device)
    longest = int(counts.max()) if m else 0
    for k in range(longest):
        rows = torch.nonzero(counts > k).squeeze(1)
        out[rows] += grad[positions[offsets[rows] + k]]
    return out


# ---------------------------------------------------------------------------
# wrappers: the CUDA kernels for CUDA tensors, the plain version for CPU ones
# ---------------------------------------------------------------------------

def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = table[idx[i]]: [M, W] rows at [N] indices -> [N, W]."""
    if not table.is_cuda:
        if table.device.type == 'cpu':
            return gather_rows_plain(table, idx)
        raise ValueError(f'gather_rows: unsupported device {table.device}')
    device = _check(table, idx, 'gather_rows')
    m, w = table.shape
    n = idx.shape[0]
    out = table.new_empty((n, w))
    launch(_library().nst_gather_rows, table.data_ptr(), idx.data_ptr(),
           idx.dtype == torch.int64, out.data_ptr(), m, n, w, device=device)
    LAUNCHES['gather_rows'] += 1
    return out


def scatter_add_rows(grad: torch.Tensor, idx: torch.Tensor, m: int
                     ) -> torch.Tensor:
    """out[idx[i]] += grad[i] over a zeroed [M, W]: the gather's adjoint,
    each row summed from 0 in the order of the positions that index it."""
    if not grad.is_cuda:
        if grad.device.type == 'cpu':
            return scatter_add_rows_plain(grad, idx, m)
        raise ValueError(f'scatter_add_rows: unsupported device '
                         f'{grad.device}')
    device = _check(grad, idx, 'scatter_add_rows')
    n, w = grad.shape
    if idx.shape[0] != n or n >= 2 ** 31:
        raise ValueError(f'scatter_add_rows: {idx.shape[0]} indices for '
                         f'{n} rows (the kernel takes fewer than 2^31)')
    lib = _library()
    scratch = idx.new_empty((lib.nst_scatter_scratch_ints(m, n),),
                            dtype=torch.int32)
    out = grad.new_empty((m, w))
    launch(lib.nst_scatter_add_rows, grad.data_ptr(), idx.data_ptr(),
           idx.dtype == torch.int64, out.data_ptr(), scratch.data_ptr(), m,
           n, w, device=device)
    LAUNCHES['scatter_add_rows'] += 1
    return out


class GatherRows(torch.autograd.Function):
    """Differentiable row gather: forward `gather_rows`, backward
    `scatter_add_rows` (launched only when the table needs a gradient)."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, idx: torch.Tensor):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return gather_rows(table, idx)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        if not ctx.needs_input_grad[0]:
            return None, None
        idx, = ctx.saved_tensors
        return scatter_add_rows(grad.contiguous(), idx, ctx.rows), None
