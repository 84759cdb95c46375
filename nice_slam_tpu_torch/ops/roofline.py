"""Streaming-roofline probes of the corner expansion.

Four data-movement patterns on the flat [M, C] layout of `ops/expand.py`,
each a mode of the one CUDA kernel in `csrc/roofline.cu`, with its plain
PyTorch version beside it:

  copy           y = x * 1.0 on the [M, 8C] expansion-sized buffer
  widen8         out[m] = concat(x[m] x 8)                [M, C] -> [M, 8C]
  shifts         where(zlast, x, x[m+1]) + where(ylast, x, x[m+nz])
                                                          [M, C] -> [M, C]
  expand_same_x  the expansion whose dx = 1 corners repeat the dx = 0 ones
                                                          [M, C] -> [M, 8C]

They port the Pallas functions of `scripts/studies/proto_expand_roofline.py`
(`pallas_copy` and the `concat8`, `shifts_only` and `full` bodies of
`variants`); the study's `variants2` body is the expansion itself
(`ops/expand.expand_corners`).  The plain versions are written from those
JAX bodies, on x-planes of P = ny*nz rows with the study's plane masks and
tail-replicating shift.  Only chip_smoke.py and the tests call them: as in
the JAX package, the SLAM path never does.  The copy's measured rate is the
streaming bound on the card that the data-movement kernels are compared
with.  The copy streams with several loads in flight per thread and
evict-first hints on buffers larger than the L2 cache.

Each wrapper launches the kernel for a CUDA tensor and uses the plain
version for a CPU tensor.  `LAUNCHES` counts kernel launches per mode.
"""

from __future__ import annotations

import ctypes
import os

import torch

from nice_slam_tpu_torch.ops.build import (
    BUILD_DIR, CSRC, compile_cuda, is_stale, launch)

SOURCE = os.path.join(CSRC, 'roofline.cu')
LIBRARY = os.path.join(BUILD_DIR, 'libnst_roofline.so')

MODES = ('copy', 'widen8', 'shifts', 'expand_same_x')
LAUNCHES = {f'roofline_{mode}': 0 for mode in MODES}

_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_library() -> str:
    """Compile csrc/roofline.cu for sm_90a into build/ and return the
    compiler's register/spill report."""
    return compile_cuda(SOURCE, LIBRARY)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        if is_stale(SOURCE, LIBRARY):
            build_library()
        lib = ctypes.CDLL(LIBRARY)
        lib.nst_roofline_probe.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.nst_roofline_probe.restype = ctypes.c_int
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# plain PyTorch versions, from the JAX bodies
# ---------------------------------------------------------------------------

def plane_masks(ny: int, nz: int, device=None) -> torch.Tensor:
    """[P, 2] float32: column 0 is 1 where z == nz-1, column 1 where
    y == ny-1 (the JAX package's `_plane_masks`)."""
    y = torch.arange(ny, device=device).repeat_interleave(nz)
    z = torch.arange(nz, device=device).repeat(ny)
    return torch.stack([z == nz - 1, y == ny - 1], dim=-1).float()


def shift_up(v: torch.Tensor, k: int) -> torch.Tensor:
    """Rows i -> i+k of a plane [P, C], the tail replicated (the JAX
    package's `_shift_up`)."""
    if k == 0:
        return v
    return torch.cat([v[k:], v[-1:].expand(k, -1)], dim=0)


def _planes(x: torch.Tensor, shape: tuple[int, int, int]):
    nx, ny, nz = shape
    masks = plane_masks(ny, nz, x.device)
    return x.reshape(nx, ny * nz, x.shape[-1]), masks[:, 0:1], masks[:, 1:2]


def copy_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 1.0


def widen8_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x] * 8, dim=-1)


def shifts_plain(x: torch.Tensor, shape: tuple[int, int, int]
                 ) -> torch.Tensor:
    planes, zlast, ylast = _planes(x, shape)
    out = []
    for cur in planes:
        a = torch.where(zlast > 0, cur, shift_up(cur, 1))
        b = torch.where(ylast > 0, cur, shift_up(cur, shape[2]))
        out.append(a + b)
    return torch.stack(out).reshape(x.shape)


def expand_same_x_plain(x: torch.Tensor, shape: tuple[int, int, int]
                        ) -> torch.Tensor:
    planes, zlast, ylast = _planes(x, shape)
    nz = shape[2]
    out = []
    for cur in planes:
        blocks = []
        for base in (cur, cur):
            for by in (base, torch.where(ylast > 0, base,
                                         shift_up(base, nz))):
                blocks.append(by)
                blocks.append(torch.where(zlast > 0, by, shift_up(by, 1)))
        out.append(torch.cat(blocks, dim=-1))
    return torch.stack(out).reshape(x.shape[0], 8 * x.shape[1])


def probe_plain(mode: str, x: torch.Tensor,
                shape: tuple[int, int, int] | None = None) -> torch.Tensor:
    if mode == 'copy':
        return copy_plain(x)
    if mode == 'widen8':
        return widen8_plain(x)
    if mode == 'shifts':
        return shifts_plain(x, shape)
    if mode == 'expand_same_x':
        return expand_same_x_plain(x, shape)
    raise ValueError(f'unknown probe {mode!r}')


# ---------------------------------------------------------------------------
# wrapper: the CUDA kernel for CUDA tensors, the plain version for CPU ones
# ---------------------------------------------------------------------------

_MODE_INDEX = {mode: i for i, mode in enumerate(MODES)}
_WIDEN = {'copy': 1, 'widen8': 8, 'shifts': 1, 'expand_same_x': 8}


def probe(mode: str, x: torch.Tensor,
          shape: tuple[int, int, int] | None = None) -> torch.Tensor:
    """Run probe `mode` on x ([R, W] for copy; [nx*ny*nz, C] of `shape`
    for the others).  The card's path is kept short: at the study's
    smallest shape a call's host time is longer than the copy."""
    index = _MODE_INDEX.get(mode)
    if index is None:
        raise ValueError(f'unknown probe {mode!r}')
    if not x.is_cuda:
        if x.device.type == 'cpu':
            return probe_plain(mode, x, shape)
        raise ValueError(f'probe: unsupported device {x.device}')
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f'probe: needs a contiguous 2-D float32 tensor, '
                         f'got {x.dtype} {tuple(x.shape)}')
    rows, c = x.shape
    ptr = x.data_ptr()
    if c % 4 or ptr % 16:
        raise ValueError(f'probe: width {c} not a multiple of 4, or the '
                         'data pointer not 16-byte aligned')
    ny = nz = 1
    if index:
        nx, ny, nz = shape
        if rows != nx * ny * nz:
            raise ValueError(f'probe: {rows} rows for shape {shape}')
    widen = _WIDEN[mode]
    out = (torch.empty_like(x) if widen == 1 else
           torch.empty((rows, widen * c), dtype=x.dtype, device=x.device))
    launch(_library().nst_roofline_probe, index, ptr, out.data_ptr(), rows,
           ny, nz, c, device=x.get_device())
    LAUNCHES[f'roofline_{mode}'] += 1
    return out


def probe_bytes(mode: str, x: torch.Tensor) -> int:
    """Bytes the probe must move: its input read once, its output written
    once."""
    widen = 8 if mode in ('widen8', 'expand_same_x') else 1
    return x.numel() * x.element_size() * (1 + widen)
