"""Row gather `table[idx]` and its adjoint, the row scatter-add.

`gather_rows(table [M, W], idx [N]) -> [N, W]` is the lookup under every
grid sample of the main path: `ops/trilinear.trilinear_interp_expanded`
gathers one corner-expanded [8C] row per point (W = 256 for the middle
volume, 512 for the fused fine+color one).  `scatter_add_rows(grad [N, W],
idx [N], M) -> [M, W]` is its gradient: each gradient row added into row
idx[i] of a zeroed buffer; `GatherRows` pairs them for autograd.

Each wrapper launches the CUDA kernel of `csrc/gather.cu` for a CUDA tensor
and uses the plain PyTorch version for a CPU tensor: there is no fallback
from one to the other.  The kernels replace the Pallas row gathers of the
gather studies (`scripts/studies/proto_gather_sweep.py`
`pallas_gather_tiles`, `proto_pallas_gather.py` `pallas_gather_rows`,
`proto_gather_paths.py` `pallas_gather`); the source note in the .cu file
says what bounds them on an H100.  The gather is a copy, so it is
bit-exact; the scatter sorts the indices stably and sums each target row's
gradient rows in the order of their positions, as PyTorch's sort-based
`index_put_` with accumulate does: deterministic.  An index outside
[0, M) fails a device-side assertion in either kernel, as `table[idx]`
does on the card (the next synchronizing call raises).

`LAUNCHES` counts kernel launches, one per launch and nowhere else.
"""

from __future__ import annotations

import ctypes
import os

import torch

from nice_slam_tpu_torch.ops.build import (
    BUILD_DIR, CSRC, compile_cuda, is_stale)

SOURCE = os.path.join(CSRC, 'gather.cu')
LIBRARY = os.path.join(BUILD_DIR, 'libnst_gather.so')

LAUNCHES = {'gather_rows': 0, 'scatter_add_rows': 0}

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
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p]
        lib.nst_scatter_add_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_void_p]
        for fn in (lib.nst_gather_rows, lib.nst_scatter_add_rows):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _rows(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f'{name}: needs a contiguous 2-D float32 tensor, '
                         f'got {x.dtype} {tuple(x.shape)} '
                         f'contiguous={x.is_contiguous()}')
    if x.shape[1] % 4:
        raise ValueError(f'{name}: row width {x.shape[1]} is not a '
                         'multiple of 4')
    if x.data_ptr() % 16:
        raise ValueError(f'{name}: data pointer not 16-byte aligned')


def _index(idx: torch.Tensor, n: int, device) -> torch.Tensor:
    """The one place the row index becomes int64 (the JAX package's is
    int32)."""
    if idx.dim() != 1 or idx.shape[0] != n:
        raise ValueError(f'index: shape {tuple(idx.shape)} != ({n},)')
    if idx.device != device:
        raise ValueError(f'index on {idx.device}, rows on {device}')
    return idx.to(torch.int64).contiguous()


def _launch(fn, src: torch.Tensor, idx, dst: torch.Tensor, m: int, n: int,
            w: int) -> None:
    """idx: the index tensor, or the (sorted, positions) pair."""
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (src, *idx, dst)]
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = fn(*ptrs, m, n, w, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f'{fn.__name__}: CUDA launch failed with '
                           f'error {err}')


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


# ---------------------------------------------------------------------------
# wrappers: the CUDA kernel for CUDA tensors, the plain version for CPU ones
# ---------------------------------------------------------------------------

def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = table[idx[i]]: [M, W] rows at [N] indices -> [N, W]."""
    if table.device.type == 'cpu':
        return gather_rows_plain(table, idx)
    if table.device.type != 'cuda':
        raise ValueError(f'gather_rows: unsupported device {table.device}')
    _rows(table, 'gather_rows')
    m, w = table.shape
    n = idx.shape[0]
    idx = _index(idx, n, table.device)
    out = torch.empty((n, w), dtype=table.dtype, device=table.device)
    _launch(_library().nst_gather_rows, table, (idx,), out, m, n, w)
    LAUNCHES['gather_rows'] += 1
    return out


def scatter_add_rows(grad: torch.Tensor, idx: torch.Tensor, m: int
                     ) -> torch.Tensor:
    """out[idx[i]] += grad[i] over a zeroed [M, W]: the gather's adjoint,
    each row summed from 0 in the order of the positions that index it."""
    if grad.device.type == 'cpu':
        return scatter_add_rows_plain(grad, idx, m)
    if grad.device.type != 'cuda':
        raise ValueError(f'scatter_add_rows: unsupported device '
                         f'{grad.device}')
    _rows(grad, 'scatter_add_rows')
    n, w = grad.shape
    idx = _index(idx, n, grad.device)
    order = torch.sort(idx, stable=True)
    out = torch.zeros((m, w), dtype=grad.dtype, device=grad.device)
    _launch(_library().nst_scatter_add_rows, grad,
            (order.values, order.indices), out, m, n, w)
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
