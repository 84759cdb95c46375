"""Fused decoder-MLP forward; port of `nice_slam_tpu/ops/pallas/fused_mlp.py`.

The decoders (models/decoders.MLP with the Fourier embedding and grid
features) are evaluated over very large point batches on the eval-only
paths: the mesher's lattice and vertex-color queries and full-frame
renders.  Eager PyTorch writes every layer's [N, 32] activations to device
memory; `fused_mlp` runs the whole stack in one CUDA kernel
(`csrc/fused_mlp.cu`) on the tensor cores: 3xTF32 products of tiles of
points against weights kept in shared memory, the activations in
registers.  Its source note says what bounds it on an H100.

The kernel has a mode for each precision it computes (`MODES`; the
precision is the decoders' effective one, models/precision.py): 3xTF32
(FP32 accuracy) for the float32 names, and the TPU's one- and three-pass
bfloat16 rules on the bf16 tensor cores (mma.sync m16n8k16) for 'bfloat16'
/ 'default' / 'BF16_BF16_F32' and 'tensorfloat32' / 'high' /
'BF16_BF16_F32_X3'.  The six- and nine-pass presets have no mode: a caller
chooses the decoders' own forward for them before anything launches
(`has_mode`; render/renderer.with_fused_eval).

  * `fused_mlp_plain(p, c, params, color=, precision=)`: the plain PyTorch
    version, the same operations as `MLP.forward` at that precision
    (bit-identical to it on the CPU); the products through
    models/precision.py's `linear` / `mm`.
  * `fused_mlp_forward`: the wrapper, which launches the kernel's mode for
    CUDA tensors and uses the plain version for CPU tensors; it raises on
    any other device, on a precision without a mode, on a non-float32 or
    non-contiguous input and on a configuration the kernel does not take.
    There is no fallback.
  * `FusedMLP`: the autograd Function; its backward is autograd of the plain
    version at the same precision, recomputed (the JAX package's custom_vjp
    does the same: it has no backward kernel).
  * `fused_mlp(mlp, p, c)`: the entry point for an `MLP` module, at its
    `cfg.mm_precision`.
  * `split_tf32`, `pack_weights`, `unpack`: the weights split into TF32
    hi/lo halves (3xTF32) or bf16 hi[/lo] parts (the bf16 modes) and laid
    out in the kernel's fragment order, and back; `packed_weights` builds
    that buffer once per parameter set and mode.

`LAUNCHES` counts kernel launches per mode ('fused_mlp' the 3xTF32 mode,
'fused_mlp_bf16x1' / 'fused_mlp_bf16x3' the bf16 modes), one per launch and
nowhere else.  The library is built with nvcc into the checkout's `build/`
at first use.
"""

from __future__ import annotations

import ctypes
import os
import threading
from collections import OrderedDict

import torch
from torch.nn import functional as F

from nice_slam_tpu_torch.models import precision as prec
from nice_slam_tpu_torch.ops.build import (
    BUILD_DIR, CSRC, compile_cuda, is_stale, launch)

SOURCE = os.path.join(CSRC, 'fused_mlp.cu')
LIBRARY = os.path.join(BUILD_DIR, 'libnst_fused_mlp.so')

# the kernel's modes: bf16 passes of each product (0: 3xTF32) -> counter
MODES = {0: 'fused_mlp', 1: 'fused_mlp_bf16x1', 3: 'fused_mlp_bf16x3'}
LAUNCHES = {name: 0 for name in MODES.values()}

# the only configuration the kernel takes (configs/nice_slam.yaml: hidden
# 32, 5 blocks, skip after block 2, 93 Fourier features)
HIDDEN, N_BLOCKS, SKIPS, EMBED = 32, 5, (2,), 93
C_DIMS, OUT_DIMS = (32, 64), (1, 4)
# the kernel's padded widths: the embedding to k8 / k16 tiles, the head to
# an n8 tile
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
            ctypes.c_int, ctypes.c_void_p]
        lib.nst_fused_mlp.restype = ctypes.c_int
        for name in ('nst_fused_mlp_pack_size', 'nst_fused_mlp_smem_bytes',
                     'nst_fused_mlp_warps'):
            getattr(lib, name).argtypes = [ctypes.c_int] * 3
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


def has_mode(precision: str | None) -> bool:
    """Whether the kernel has a mode for `precision` (ValueError for a name
    without a rule)."""
    return prec.passes(precision) in MODES


def mode_of(precision: str | None) -> int:
    """The kernel's mode (bf16 passes, 0 for 3xTF32) for `precision`;
    ValueError when it has none."""
    n_passes = prec.passes(precision)
    if n_passes not in MODES:
        raise ValueError(f'fused_mlp: no kernel mode for {precision!r} '
                         f'({n_passes} bf16 passes); the modes are '
                         f'{sorted(MODES)}')
    return n_passes


def _fragments_bf16(w: torch.Tensor, n_passes: int) -> torch.Tensor:
    """A weight [N, K] (N a multiple of 8, K of 16) as the bf16 modes' B
    fragments, in 32-bit words: [K/16][N/8][lane 4g + t][part][j][bf16
    pair e] of w[8 nt + g, 16 kt + 8 j + 2 t + e], part hi (and lo at three
    passes, models/precision.split); a pair's first value is the word's low
    half."""
    n, k = w.shape

    def order(x):      # [kt, nt, g, t, j, e]
        return x.reshape(n // 8, 8, k // 16, 2, 4, 2).permute(2, 0, 1, 4, 3,
                                                              5)

    parts = torch.stack([order(x) for x in prec.split(w, n_passes)], dim=-3)
    return parts.contiguous().view(torch.float32).reshape(-1)


def _unfragments_bf16(flat: torch.Tensor, n: int, k: int, parts: int):
    """The parts ([N, K] float32 of bf16 values) of `_fragments_bf16`'s
    output."""
    x = flat.contiguous().view(torch.bfloat16).reshape(
        k // 16, n // 8, 8, 4, parts, 2, 2)      # kt, nt, g, t, part, j, e
    x = x.permute(4, 1, 2, 0, 5, 3, 6).reshape(parts, n, k)
    return tuple(x.float())


def _in_width(i: int) -> int:
    """Padded input width of dense layer i: the embedding (93 -> 96) at
    layer 0, [embedding, hidden] after the skip, hidden otherwise."""
    if i == 0:
        return EMBED_PAD
    return EMBED_PAD + HIDDEN if i - 1 in SKIPS else HIDDEN


def _parts(n_passes: int) -> int:
    """The parts of each product weight in mode `n_passes`: TF32 hi/lo,
    bf16 hi, bf16 hi/lo."""
    return {0: 2, 1: 1, 3: 2}[n_passes]


def _words(elements: int, n_passes: int) -> int:
    """32-bit words of the fragments of `elements` weights in mode
    `n_passes`: a TF32 part is one word an element, a bf16 part half."""
    return elements * _parts(n_passes) // (1 if n_passes == 0 else 2)


def pack_size(c_dim: int, n_passes: int = 0) -> int:
    """32-bit words of the packed buffer of mode `n_passes`
    (nst_fused_mlp_pack_size)."""
    fp32 = ((6 if n_passes == 3 else 3) * EMBED_PAD
            + 2 * N_BLOCKS * HIDDEN + HEAD_PAD)
    return fp32 + _words(sum(_in_width(i) for i in range(N_BLOCKS)) * HIDDEN
                         + N_BLOCKS * c_dim * HIDDEN + HIDDEN * HEAD_PAD,
                         n_passes)


def pack_weights(params, n_passes: int = 0) -> torch.Tensor:
    """All weights of one MLP in one contiguous float32 buffer, in the
    layout csrc/fused_mlp.cu reads in mode `n_passes`: B [3][96] | b_i
    [5][32] | bc_i [5][32] | b_o [8] in float32, then the fragments of W_i
    (layer 0's input padded 93 -> 96, layer 3's [e, h] as [e, 0, 0, 0,
    h]), of Wc_i and of W_o (rows padded to 8).  3xTF32: B as it is and
    the TF32 hi/lo fragments (`_fragments`); bf16 modes: B's bf16 value
    (three passes: its hi, then its lo, [3][96] each) and the bf16
    fragments (`_fragments_bf16`).  Pads are zero."""
    b_mat, pts, fcs, w_o, b_o = _split(params)
    pad = EMBED_PAD - EMBED

    def pad_embed(w):
        return torch.cat([w[:, :EMBED], w.new_zeros((w.shape[0], pad)),
                          w[:, EMBED:]], dim=1)

    if n_passes == 0:
        frag = _fragments
        b_parts = [b_mat]
    else:
        def frag(w):
            return _fragments_bf16(w, n_passes)
        b_parts = [x.float() for x in prec.split(b_mat, n_passes)]
    pieces = [F.pad(x, (0, pad)).reshape(-1) for x in b_parts]
    pieces += [b for _, b in pts] + [b for _, b in fcs]
    pieces.append(F.pad(b_o, (0, HEAD_PAD - b_o.shape[0])))
    pieces += [frag(pad_embed(w) if _in_width(i) != HIDDEN else w)
               for i, (w, _) in enumerate(pts)]
    pieces += [frag(w) for w, _ in fcs]
    pieces.append(frag(F.pad(w_o, (0, 0, 0, HEAD_PAD - w_o.shape[0]))))
    return torch.cat(pieces)


def unpack(packed: torch.Tensor, c_dim: int, out_dim: int,
           n_passes: int = 0) -> dict:
    """The weights of a packed buffer of mode `n_passes`: 'B' [3, 93]
    (three passes also 'B_lo'), 'b' and 'bc' (five [32] each), 'b_o' [out]
    in float32; 'W', 'Wc' (five tuples each) and 'W_o' in nn.Linear's [out,
    in] layout without the pads, each a tuple of its parts: TF32 (hi, lo),
    bf16 (hi,) or (hi, lo) as float32.  Raises if the length or a pad is
    wrong."""
    if packed.numel() != pack_size(c_dim, n_passes):
        raise ValueError(f'{packed.numel()} floats, the layout has '
                         f'{pack_size(c_dim, n_passes)}')
    def unfrag(flat, n, k):
        if n_passes == 0:
            return _unfragments(flat, n, k)
        return _unfragments_bf16(flat, n, k, _parts(n_passes))

    def words(n, k):
        return _words(n * k, n_passes)
    pos = 0

    def take(m):
        nonlocal pos
        pos += m
        return packed[pos - m:pos]

    b_mat = take(3 * EMBED_PAD).reshape(3, EMBED_PAD)
    b_lo = (take(3 * EMBED_PAD).reshape(3, EMBED_PAD) if n_passes == 3
            else None)
    b = take(N_BLOCKS * HIDDEN).reshape(N_BLOCKS, HIDDEN)
    bc = take(N_BLOCKS * HIDDEN).reshape(N_BLOCKS, HIDDEN)
    b_o = take(HEAD_PAD)
    ws = [unfrag(take(words(HIDDEN, _in_width(i))), HIDDEN, _in_width(i))
          for i in range(N_BLOCKS)]
    wcs = [unfrag(take(words(HIDDEN, c_dim)), HIDDEN, c_dim)
           for _ in range(N_BLOCKS)]
    w_o = unfrag(take(words(HEAD_PAD, HIDDEN)), HEAD_PAD, HIDDEN)
    pads = [b_mat[:, EMBED:], b_o[out_dim:], *(x[out_dim:] for x in w_o)]
    if b_lo is not None:
        pads.append(b_lo[:, EMBED:])
    pads += [x[:, EMBED:EMBED_PAD] for i, pair in enumerate(ws)
             if _in_width(i) != HIDDEN for x in pair]
    if any(bool(x.any()) for x in pads):
        raise ValueError('nonzero padding in the packed weights')

    def strip(x, i):
        if _in_width(i) == HIDDEN:
            return x
        return torch.cat([x[:, :EMBED], x[:, EMBED_PAD:]], dim=1)

    out = {'B': b_mat[:, :EMBED], 'b': list(b), 'bc': list(bc),
           'b_o': b_o[:out_dim],
           'W': [tuple(strip(x, i) for x in pair)
                 for i, pair in enumerate(ws)],
           'Wc': wcs, 'W_o': tuple(x[:out_dim] for x in w_o)}
    if b_lo is not None:
        out['B_lo'] = b_lo[:, :EMBED]
    return out


# the packed buffers of the parameter sets seen last, newest at the end
_PACKED: OrderedDict = OrderedDict()
_PACKED_MAX = 8
_PACKED_LOCK = threading.Lock()


def packed_weights(params, n_passes: int = 0) -> torch.Tensor:
    """`pack_weights(params, n_passes)`, built once per parameter set and
    mode.

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
    key = (n_passes,) + tuple((w.device, w.data_ptr(), w._version, w.shape)
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
        packed = pack_weights(params, n_passes)
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
                    color: bool, precision: str | None = None
                    ) -> torch.Tensor:
    """The decoder MLP in plain PyTorch: the operations of `MLP.forward`
    (Fourier embedding) with every product at `precision`
    (models/precision.py), on any device.  [N, 4] if color else [N]."""
    b_mat, pts, fcs, w_o, b_o = _split(params)
    if prec.passes(precision) == 0:
        embedded = torch.sin(p @ b_mat)

        def linear(x, w, b):
            return F.linear(x, w, b)
    else:
        embedded = torch.sin(prec.mm(p, b_mat, precision))

        def linear(x, w, b):
            return prec.linear(x, w, b, precision)
    w_all = torch.cat([w for w, _ in fcs], dim=0)
    b_all = torch.cat([b for _, b in fcs])
    fc_all = linear(c, w_all, b_all)
    hidden = fcs[0][0].shape[0]
    h = embedded
    for i, (w, b) in enumerate(pts):
        h = F.relu(linear(h, w, b))
        h = h + fc_all[:, i * hidden:(i + 1) * hidden]
        if i in SKIPS:
            h = torch.cat([embedded, h], dim=-1)
    out = linear(h, w_o, b_o)
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


def _kernel_pack_size(lib, c_dim: int, out_dim: int, n_passes: int) -> int:
    key = (c_dim, out_dim, n_passes)
    if key not in _KERNEL_PACK_SIZES:
        _KERNEL_PACK_SIZES[key] = lib.nst_fused_mlp_pack_size(
            c_dim, out_dim, n_passes)
    return _KERNEL_PACK_SIZES[key]


def kernel_config(c_dim: int, out_dim: int, n_passes: int = 0) -> dict:
    """Warps per block and dynamic shared memory of the kernel's
    instantiation for (c_dim, out_dim) in mode `n_passes`, from the
    library."""
    lib = _library()
    return {'warps': lib.nst_fused_mlp_warps(c_dim, out_dim, n_passes),
            'smem_bytes': lib.nst_fused_mlp_smem_bytes(c_dim, out_dim,
                                                       n_passes),
            'pack_floats': lib.nst_fused_mlp_pack_size(c_dim, out_dim,
                                                       n_passes)}


def fused_mlp_forward(p: torch.Tensor, c: torch.Tensor, params, *,
                      color: bool, precision: str | None = None
                      ) -> torch.Tensor:
    """The kernel's mode for `precision` on CUDA tensors, the plain version
    at `precision` on CPU tensors (both only for the configuration the
    kernel takes; ValueError for a precision without a mode)."""
    n_passes = mode_of(precision)
    c_dim, out_dim = _check_config(params, c)
    if out_dim != (4 if color else 1):
        raise ValueError(f'fused_mlp: out_dim {out_dim} with color={color}')
    if p.device.type == 'cpu':
        return fused_mlp_plain(p, c, params, color=color,
                               precision=precision)
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
    packed = packed_weights(params, n_passes)
    if packed.numel() != _kernel_pack_size(lib, c_dim, out_dim, n_passes):
        raise RuntimeError('fused_mlp: packed weights do not match the '
                           "kernel's layout")
    out = torch.empty((n, out_dim) if color else (n,), dtype=torch.float32,
                      device=p.device)
    launch(lib.nst_fused_mlp, p.data_ptr(), c.data_ptr(), packed.data_ptr(),
           out.data_ptr(), n, c_dim, out_dim, n_passes,
           device=p.get_device())
    LAUNCHES[MODES[n_passes]] += 1
    return out


class FusedMLP(torch.autograd.Function):
    """Forward `fused_mlp_forward`; backward autograd of `fused_mlp_plain`
    at the same precision, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, p, c, color, precision, *params):
        ctx.color, ctx.precision = color, precision
        ctx.save_for_backward(p, c, *params)
        return fused_mlp_forward(p, c, params, color=color,
                                 precision=precision)

    @staticmethod
    def backward(ctx, grad_out):
        p, c, *params = ctx.saved_tensors
        needs = (ctx.needs_input_grad[:2] + ctx.needs_input_grad[4:])
        inputs = [x.detach().requires_grad_(n)
                  for x, n in zip([p, c] + params, needs)]
        with torch.enable_grad():
            out = fused_mlp_plain(inputs[0], inputs[1], inputs[2:],
                                  color=ctx.color, precision=ctx.precision)
            wanted = [x for x, n in zip(inputs, needs) if n]
            got = iter(torch.autograd.grad(out, wanted, grad_out))
        grads = [next(got) if n else None for n in needs]
        return (grads[0], grads[1], None, None, *grads[2:])


def fused_mlp(mlp, p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """`mlp(p, c)` of a Fourier-embedding `MLP` through the fused kernel
    (on CUDA tensors) at the MLP's `cfg.mm_precision`, with autograd of the
    plain version as its backward."""
    return FusedMLP.apply(p, c, mlp.color, mlp.cfg.mm_precision,
                          *mlp_params(mlp))
