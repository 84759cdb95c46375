"""Fused decoder-MLP forward; port of `nice_slam_tpu/ops/pallas/fused_mlp.py`.

The decoders (models/decoders.MLP with the Fourier embedding and grid
features) are evaluated over very large point batches on the eval-only
paths: the mesher's lattice and vertex-color queries and full-frame
renders.  Eager PyTorch writes every layer's [N, 32] activations to device
memory; `fused_mlp` runs the whole stack in one CUDA kernel
(`csrc/fused_mlp.cu`) that keeps the weights in shared memory and the
activations in registers.  Its source note says what bounds it on an H100.

  * `fused_mlp_plain(p, c, params, color=)`: the plain PyTorch version, the
    same operations as `MLP.forward` (bit-identical to it on the CPU).
  * `fused_mlp_forward`: the wrapper, which launches the kernel for CUDA
    tensors and uses the plain version for CPU tensors; it raises on any
    other device, on a non-float32 or non-contiguous input and on a
    configuration the kernel does not take.  There is no fallback.
  * `FusedMLP`: the autograd Function; its backward is autograd of the plain
    version, recomputed (the JAX package's custom_vjp does the same: it has
    no backward kernel).
  * `fused_mlp(mlp, p, c)`: the entry point for an `MLP` module.

`LAUNCHES['fused_mlp']` counts kernel launches, one per launch and nowhere
else.  The library is built with nvcc into the checkout's `build/` at first
use.
"""

from __future__ import annotations

import ctypes
import os

import torch
from torch.nn import functional as F

from nice_slam_tpu_torch.ops.build import (
    BUILD_DIR, CSRC, compile_cuda, is_stale, launch)

SOURCE = os.path.join(CSRC, 'fused_mlp.cu')
LIBRARY = os.path.join(BUILD_DIR, 'libnst_fused_mlp.so')

LAUNCHES = {'fused_mlp': 0}

# the only configuration the kernel takes (configs/nice_slam.yaml: hidden
# 32, 5 blocks, skip after block 2, 93 Fourier features)
HIDDEN, N_BLOCKS, SKIPS, EMBED = 32, 5, (2,), 93
C_DIMS, OUT_DIMS = (32, 64), (1, 4)

_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_library() -> str:
    """Compile csrc/fused_mlp.cu for sm_90a into build/ and return the
    compiler's register/spill report."""
    return compile_cuda(SOURCE, LIBRARY)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        if is_stale(SOURCE, LIBRARY):
            build_library()
        lib = ctypes.CDLL(LIBRARY)
        lib.nst_fused_mlp.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.nst_fused_mlp.restype = ctypes.c_int
        lib.nst_fused_mlp_pack_size.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.nst_fused_mlp_pack_size.restype = ctypes.c_int
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# parameters: the flat list the Function takes, and the kernel's packing
# ---------------------------------------------------------------------------

def mlp_params(mlp) -> list[torch.Tensor]:
    """An `MLP`'s parameters in the Function's order: B, then (W_i, b_i)
    for each block, then (Wc_i, bc_i), then (W_o, b_o); weights in
    `nn.Linear`'s [out, in] layout."""
    params = [mlp.embedder._B]
    for layer in mlp.pts_linears:
        params += [layer.weight, layer.bias]
    for layer in mlp.fc_c:
        params += [layer.weight, layer.bias]
    return params + [mlp.output_linear.weight, mlp.output_linear.bias]


def _split(params):
    b_mat = params[0]
    pts = list(zip(params[1:2 * N_BLOCKS + 1:2],
                   params[2:2 * N_BLOCKS + 1:2]))
    fcs = list(zip(params[2 * N_BLOCKS + 1:4 * N_BLOCKS + 1:2],
                   params[2 * N_BLOCKS + 2:4 * N_BLOCKS + 1:2]))
    return b_mat, pts, fcs, params[-2], params[-1]


def _pad4(x: torch.Tensor) -> torch.Tensor:
    x = x.reshape(-1)
    pad = (-x.numel()) % 4
    return F.pad(x, (0, pad)) if pad else x


def pack_weights(params) -> torch.Tensor:
    """All weights of one MLP in one contiguous float32 buffer, in the
    layout of csrc/fused_mlp.cu: B [3][93] | (W_i [in][32], b_i) x 5 |
    (Wc_i [C][32], bc_i) x 5 | W_o [32][out] | b_o, each section padded to
    a multiple of 4 floats."""
    b_mat, pts, fcs, w_o, b_o = _split(params)
    pieces = [_pad4(b_mat)]
    for w, b in pts + fcs:
        pieces += [w.t().reshape(-1), b]
    pieces += [w_o.t().reshape(-1), _pad4(b_o)]
    return torch.cat(pieces)


def _check_config(params, c: torch.Tensor) -> tuple[int, int]:
    """(c_dim, out_dim) of an MLP the kernel takes, else ValueError."""
    if len(params) != 4 * N_BLOCKS + 3:
        raise ValueError(f'fused_mlp: expected {N_BLOCKS} blocks with grid '
                         f'features ({4 * N_BLOCKS + 3} parameters), got '
                         f'{len(params)}')
    b_mat, pts, fcs, w_o, _ = _split(params)
    ins = [w.shape[1] for w, _ in pts]
    want = [EMBED] + [EMBED + HIDDEN if i - 1 in SKIPS else HIDDEN
                      for i in range(1, N_BLOCKS)]
    if (tuple(b_mat.shape) != (3, EMBED) or ins != want
            or any(w.shape[0] != HIDDEN for w, _ in pts + fcs)
            or w_o.shape[1] != HIDDEN):
        raise ValueError('fused_mlp: the kernel takes the Fourier-embedding '
                         f'decoder with hidden {HIDDEN}, {N_BLOCKS} blocks '
                         f'and skips {SKIPS} only')
    c_dim, out_dim = c.shape[-1], w_o.shape[0]
    if c_dim not in C_DIMS or out_dim not in OUT_DIMS:
        raise ValueError(f'fused_mlp: c_dim {c_dim} / out_dim {out_dim} not '
                         f'in {C_DIMS} / {OUT_DIMS}')
    return c_dim, out_dim


# ---------------------------------------------------------------------------
# plain version and wrapper
# ---------------------------------------------------------------------------

def fused_mlp_plain(p: torch.Tensor, c: torch.Tensor, params, *,
                    color: bool) -> torch.Tensor:
    """The decoder MLP in plain PyTorch: the operations of `MLP.forward`
    (Fourier embedding), on any device.  [N, 4] if color else [N]."""
    b_mat, pts, fcs, w_o, b_o = _split(params)
    embedded = torch.sin(p @ b_mat)
    w_all = torch.cat([w for w, _ in fcs], dim=0)
    b_all = torch.cat([b for _, b in fcs])
    fc_all = F.linear(c, w_all, b_all)
    hidden = fcs[0][0].shape[0]
    h = embedded
    for i, (w, b) in enumerate(pts):
        h = F.relu(F.linear(h, w, b))
        h = h + fc_all[:, i * hidden:(i + 1) * hidden]
        if i in SKIPS:
            h = torch.cat([embedded, h], dim=-1)
    out = F.linear(h, w_o, b_o)
    return out if color else out[..., 0]


def _check_cuda_f32(x: torch.Tensor, name: str, shape: tuple) -> None:
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f'fused_mlp: {name} needs a contiguous float32 '
                         f'tensor, got {x.dtype} contiguous='
                         f'{x.is_contiguous()}')
    if tuple(x.shape) != shape:
        raise ValueError(f'fused_mlp: {name} has shape {tuple(x.shape)}, '
                         f'expected {shape}')
    if x.data_ptr() % 16:
        raise ValueError(f'fused_mlp: {name} is not 16-byte aligned')


def fused_mlp_forward(p: torch.Tensor, c: torch.Tensor, params, *,
                      color: bool) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors (both
    only for the configuration the kernel takes)."""
    c_dim, out_dim = _check_config(params, c)
    if out_dim != (4 if color else 1):
        raise ValueError(f'fused_mlp: out_dim {out_dim} with color={color}')
    if p.device.type == 'cpu':
        return fused_mlp_plain(p, c, params, color=color)
    if p.device.type != 'cuda':
        raise ValueError(f'fused_mlp: unsupported device {p.device}')
    n = p.shape[0]
    if p.dim() != 2:
        raise ValueError(f'fused_mlp: p has shape {tuple(p.shape)}')
    _check_cuda_f32(p, 'p', (n, 3))
    _check_cuda_f32(c, 'c', (n, c_dim))
    for w in params:
        if w.dtype != torch.float32 or w.device != p.device:
            raise ValueError('fused_mlp: weights must be float32 on '
                             f'{p.device}, got {w.dtype} on {w.device}')
    lib = _library()
    with torch.no_grad():
        packed = pack_weights(params)
    if packed.numel() != lib.nst_fused_mlp_pack_size(c_dim, out_dim):
        raise RuntimeError('fused_mlp: packed weights do not match the '
                           "kernel's layout")
    out = torch.empty((n, out_dim) if color else (n,), dtype=torch.float32,
                      device=p.device)
    launch(lib.nst_fused_mlp, p.data_ptr(), c.data_ptr(), packed.data_ptr(),
           out.data_ptr(), n, c_dim, out_dim, device=p.get_device())
    LAUNCHES['fused_mlp'] += 1
    return out


class FusedMLP(torch.autograd.Function):
    """Forward `fused_mlp_forward`; backward autograd of `fused_mlp_plain`
    recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, p, c, color, *params):
        ctx.color = color
        ctx.save_for_backward(p, c, *params)
        return fused_mlp_forward(p, c, params, color=color)

    @staticmethod
    def backward(ctx, grad_out):
        p, c, *params = ctx.saved_tensors
        needs = (ctx.needs_input_grad[:2] + ctx.needs_input_grad[3:])
        inputs = [x.detach().requires_grad_(n)
                  for x, n in zip([p, c] + params, needs)]
        with torch.enable_grad():
            out = fused_mlp_plain(inputs[0], inputs[1], inputs[2:],
                                  color=ctx.color)
            wanted = [x for x, n in zip(inputs, needs) if n]
            got = iter(torch.autograd.grad(out, wanted, grad_out))
        grads = [next(got) if n else None for n in needs]
        return (grads[0], grads[1], None, *grads[2:])


def fused_mlp(mlp, p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """`mlp(p, c)` of a Fourier-embedding `MLP` through the fused kernel
    (on CUDA tensors) with autograd of the plain version as its backward."""
    return FusedMLP.apply(p, c, mlp.color, *mlp_params(mlp))
