"""Fused decoder-MLP forward; port of `nice_slam_tpu/ops/pallas/fused_mlp.py`.

The decoders (models/decoders.MLP with the Fourier embedding and grid
features) are evaluated over very large point batches on the eval-only
paths: the mesher's lattice and vertex-color queries and full-frame
renders.  Eager PyTorch writes every layer's [N, 32] activations to device
memory; `fused_mlp` runs the whole stack in one CUDA kernel
(`csrc/fused_mlp.cu`) on the tensor cores: 3xTF32 products of tiles of
points against weights kept in shared memory, the activations in
registers.  Its source note says what bounds it on an H100.

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
  * `split_tf32`, `pack_weights`, `unpack`: the weights split into TF32
    hi/lo halves and laid out in the kernel's fragment order, and back;
    `packed_weights` builds that buffer once per parameter set.

`LAUNCHES['fused_mlp']` counts kernel launches, one per launch and nowhere
else.  The library is built with nvcc into the checkout's `build/` at first
use.
"""

from __future__ import annotations

import ctypes
import os
import threading
from collections import OrderedDict

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
# the kernel's padded widths: the embedding to k8 tiles, the head to an n8
# tile
EMBED_PAD, HEAD_PAD = 96, 8
# the kernel's precision bound, x max(1, max|plain|), at a 262,144-point
# lattice chunk: FP32 precision.  1e-4 alone fails 1x and 2xTF32 products
# (4.1e-3 to 6.4e-3 against 8.2e-4 to 1.1e-3) but not the fast hardware
# sine __sinf (1.8e-4 to 2.1e-4); this fails the sine too, and the kernel
# (3xTF32, precise sinf) is off by 2.4e-5 to 5.0e-5 (PERF.md, the fused
# MLP)
PRECISION_TOL = 1e-5

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
        for name in ('nst_fused_mlp_pack_size', 'nst_fused_mlp_smem_bytes',
                     'nst_fused_mlp_warps'):
            getattr(lib, name).argtypes = [ctypes.c_int, ctypes.c_int]
            getattr(lib, name).restype = ctypes.c_int
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


def _rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to TF32's 10 mantissa bits, to nearest with
    ties away from zero (half an ulp added to the magnitude's bits, then
    the low 13 bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of a float32 tensor as the kernel splits an operand for its
    3xTF32 products: hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi).
    x - hi is exact in float32; hi + lo is x within 2^-21 relative."""
    hi = _rna_tf32(x)
    return hi, _rna_tf32(x - hi)


def _fragments(w: torch.Tensor) -> torch.Tensor:
    """A weight [N, K] (nn.Linear's [out, in], N and K multiples of 8) as
    the kernel's B fragments: [K/8][N/8][lane 4g + t][hi(2t), hi(2t+1),
    lo(2t), lo(2t+1)] of row 8 nt + g and columns 8 kt + 2t + {0, 1}."""
    n, k = w.shape
    hi, lo = split_tf32(w)

    def order(x):      # [kt, nt, g, t, j]
        return x.reshape(n // 8, 8, k // 8, 4, 2).permute(2, 0, 1, 3, 4)

    return torch.stack([order(hi), order(lo)], dim=-2).reshape(-1)


def _unfragments(flat: torch.Tensor, n: int, k: int):
    """(hi, lo) [N, K] of `_fragments`' output."""
    x = flat.reshape(k // 8, n // 8, 8, 4, 2, 2)     # kt, nt, g, t, hl, j
    x = x.permute(4, 1, 2, 0, 3, 5).reshape(2, n, k)
    return x[0], x[1]


def _in_width(i: int) -> int:
    """Padded input width of dense layer i: the embedding (93 -> 96) at
    layer 0, [embedding, hidden] after the skip, hidden otherwise."""
    if i == 0:
        return EMBED_PAD
    return EMBED_PAD + HIDDEN if i - 1 in SKIPS else HIDDEN


def pack_size(c_dim: int) -> int:
    """Floats of the packed buffer (nst_fused_mlp_pack_size)."""
    fp32 = 3 * EMBED_PAD + 2 * N_BLOCKS * HIDDEN + HEAD_PAD
    split = (sum(_in_width(i) for i in range(N_BLOCKS)) * HIDDEN
             + N_BLOCKS * c_dim * HIDDEN + HIDDEN * HEAD_PAD)
    return fp32 + 2 * split


def pack_weights(params) -> torch.Tensor:
    """All weights of one MLP in one contiguous float32 buffer, in the
    layout csrc/fused_mlp.cu reads: B [3][96] | b_i [5][32] | bc_i [5][32]
    | b_o [8] in float32, then the hi/lo fragments (`_fragments`) of W_i
    (layer 0's input padded 93 -> 96, layer 3's [e, h] as [e, 0, 0, 0,
    h]), of Wc_i and of W_o (rows padded to 8).  Pads are zero."""
    b_mat, pts, fcs, w_o, b_o = _split(params)
    pad = EMBED_PAD - EMBED

    def pad_embed(w):
        return torch.cat([w[:, :EMBED], w.new_zeros((w.shape[0], pad)),
                          w[:, EMBED:]], dim=1)

    pieces = [F.pad(b_mat, (0, pad)).reshape(-1)]
    pieces += [b for _, b in pts] + [b for _, b in fcs]
    pieces.append(F.pad(b_o, (0, HEAD_PAD - b_o.shape[0])))
    pieces += [_fragments(pad_embed(w) if _in_width(i) != HIDDEN else w)
               for i, (w, _) in enumerate(pts)]
    pieces += [_fragments(w) for w, _ in fcs]
    pieces.append(_fragments(F.pad(w_o, (0, 0, 0, HEAD_PAD - w_o.shape[0]))))
    return torch.cat(pieces)


def unpack(packed: torch.Tensor, c_dim: int, out_dim: int) -> dict:
    """The weights of a packed buffer: 'B' [3, 93], 'b' and 'bc' (five [32]
    each), 'b_o' [out] in float32; 'W', 'Wc' (five (hi, lo) pairs each)
    and 'W_o' (hi, lo) in nn.Linear's [out, in] layout without the pads.
    Raises if the length or a pad is wrong."""
    if packed.numel() != pack_size(c_dim):
        raise ValueError(f'{packed.numel()} floats, the layout has '
                         f'{pack_size(c_dim)}')
    pos = 0

    def take(m):
        nonlocal pos
        pos += m
        return packed[pos - m:pos]

    b_mat = take(3 * EMBED_PAD).reshape(3, EMBED_PAD)
    b = take(N_BLOCKS * HIDDEN).reshape(N_BLOCKS, HIDDEN)
    bc = take(N_BLOCKS * HIDDEN).reshape(N_BLOCKS, HIDDEN)
    b_o = take(HEAD_PAD)
    ws = [_unfragments(take(2 * HIDDEN * _in_width(i)), HIDDEN,
                       _in_width(i)) for i in range(N_BLOCKS)]
    wcs = [_unfragments(take(2 * HIDDEN * c_dim), HIDDEN, c_dim)
           for _ in range(N_BLOCKS)]
    w_o = _unfragments(take(2 * HEAD_PAD * HIDDEN), HEAD_PAD, HIDDEN)
    pads = [b_mat[:, EMBED:], b_o[out_dim:], *(x[out_dim:] for x in w_o)]
    pads += [x[:, EMBED:EMBED_PAD] for i, pair in enumerate(ws)
             if _in_width(i) != HIDDEN for x in pair]
    if any(bool(x.any()) for x in pads):
        raise ValueError('nonzero padding in the packed weights')

    def strip(x, i):
        if _in_width(i) == HIDDEN:
            return x
        return torch.cat([x[:, :EMBED], x[:, EMBED_PAD:]], dim=1)

    return {'B': b_mat[:, :EMBED], 'b': list(b), 'bc': list(bc),
            'b_o': b_o[:out_dim],
            'W': [tuple(strip(x, i) for x in pair)
                  for i, pair in enumerate(ws)],
            'Wc': wcs, 'W_o': tuple(x[:out_dim] for x in w_o)}


# the packed buffers of the parameter sets seen last, newest at the end
_PACKED: OrderedDict = OrderedDict()
_PACKED_MAX = 8
_PACKED_LOCK = threading.Lock()


def packed_weights(params) -> torch.Tensor:
    """`pack_weights(params)`, built once per parameter set.

    Cached under each parameter's device, data pointer, shape and version
    counter (`_version`, which every in-place update bumps: MaskedAdam's
    step, `load_state_dict` in `SlamSystem.restore`, `param.add_`), so an
    update rebuilds it; a write through `.data`, which has a counter of its
    own, would not.  Decoders copied to another card (the two-device
    pipeline's snapshots) get entries of their own.  An entry keeps its
    parameters alive, so no other tensor can take their addresses while it
    is cached.  On the card the buffer is complete before it is returned
    (the building stream is synchronized once), and a use from another
    stream is recorded for the allocator."""
    key = tuple((w.device, w.data_ptr(), w._version, w.shape)
                for w in params)
    cuda = params[0].is_cuda
    stream = (torch._C._cuda_getCurrentRawStream(params[0].get_device())
              if cuda else None)
    with _PACKED_LOCK:
        hit = _PACKED.get(key)
        if hit is not None:
            _PACKED.move_to_end(key)
    if hit is not None:
        packed, built_on = hit[0], hit[1]
        if stream != built_on:
            packed.record_stream(torch.cuda.current_stream(packed.device))
        return packed
    with torch.no_grad():
        packed = pack_weights(params)
    if cuda:
        torch.cuda.current_stream(packed.device).synchronize()
    with _PACKED_LOCK:
        _PACKED[key] = (packed, stream, list(params))
        while len(_PACKED) > _PACKED_MAX:
            _PACKED.popitem(last=False)
    return packed


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


_KERNEL_PACK_SIZES: dict = {}


def _kernel_pack_size(lib, c_dim: int, out_dim: int) -> int:
    key = (c_dim, out_dim)
    if key not in _KERNEL_PACK_SIZES:
        _KERNEL_PACK_SIZES[key] = lib.nst_fused_mlp_pack_size(c_dim, out_dim)
    return _KERNEL_PACK_SIZES[key]


def kernel_config(c_dim: int, out_dim: int) -> dict:
    """Warps per block and dynamic shared memory of the kernel's
    instantiation for (c_dim, out_dim), from the library."""
    lib = _library()
    return {'warps': lib.nst_fused_mlp_warps(c_dim, out_dim),
            'smem_bytes': lib.nst_fused_mlp_smem_bytes(c_dim, out_dim),
            'pack_floats': lib.nst_fused_mlp_pack_size(c_dim, out_dim)}


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
    packed = packed_weights(params)
    if packed.numel() != _kernel_pack_size(lib, c_dim, out_dim):
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
