"""Matrix products at the precision a config asks for; port of the
precision that the JAX package stamps on every product it traces: the
session-wide `matmul_precision` (`jax_default_matmul_precision`, set by
its SlamSystem) and, inside the decoders, `model.decoder_matmul_precision`
(the scope `nice_slam_tpu/models/decoders._prec_ctx` puts around every
product of the decoders, backward included).

The rules are those of the TPU's matrix unit, for exactly the names the
JAX config accepts and the TPU gives a rule; bfloat16 products on the
H100 follow them up to the order of the float32 sums:

  * `None`, 'float32', 'highest', 'F32_F32_F32': true float32, `F.linear`
    / `@` as before (TF32 stays off, `SlamSystem` sets it).
  * 'bfloat16', 'default', 'BF16_BF16_F32': one pass.  Each operand is
    rounded to bfloat16 (to nearest, ties to even), the products are
    summed in float32 and the output is float32; a bias is added in
    float32 afterwards.
  * 'tensorfloat32', 'high', 'BF16_BF16_F32_X3': three passes (not
    TF32).  Each operand splits as hi = bf16(a), lo = bf16(a - hi), and
    a.b ~ hi.lo' + lo.hi' + hi.hi': three one-pass products summed in
    float32.
  * 'BF16_BF16_F32_X6', 'BF16_BF16_F32_X9': a hi / mid / lo split (mid =
    bf16(a - hi), lo = bf16(a - hi - mid)) and six (hi.hi', hi.mid',
    mid.hi', hi.lo', lo.hi', mid.mid') or all nine of its products, as
    XLA defines those presets; the small terms are summed first.
Any other name raises a ValueError that names it ('fastest' among them:
the JAX config rejects it).

The gradients follow the same rule, as the JAX VJP replays the precision:
dX = G.W^T and dW = X^T.G as products of the same kind (the bias
gradient, the sum of G over the rows, and the activations stay float32).
Parameters and optimizer state stay float32; only the operands of each
product are rounded, and the forward keeps its rounded copy of X for the
backward.

Two forms:

  * `mm` / `linear`, the decoders' [M, K] @ [K, N] products.  A pass on a
    CUDA tensor is `torch.mm(a_bf16, b_bf16, out_dtype=float32)`
    (`aten::mm.dtype`: cuBLAS bfloat16 with a float32 output, never
    rounded to bfloat16).  The weight gradient X^T.G sums over the rows,
    and they are padded with zero rows to a multiple of 8 when their count
    is not one: cuBLAS (torch 2.11, CUDA 12.8, H100) summed 4,097 and
    8,193 rows 1.0-1.6% (rms) off the float32 sum, about one product left
    out, and every one of 487 counts tried right once padded
    (scripts/port_precision_probe.py).  On a CPU tensor a pass is the
    plain version `pass_plain`: the operands' bfloat16 values in float32,
    whose products are exact, so only the sum rounds.  Any other device
    raises; there is no fallback.
  * `matmul`, the batched [..., M, K] @ [..., K, N] of the session's
    small products (ray directions, poses, projections, the blocked
    interpolation's corner weights: K <= 8 in the forward, the gradients'
    sums over rays or points).  A pass is the plain rule on every device:
    the operands' bfloat16 values in float32 through a float32 `matmul`,
    each product exact, so only the sums round; no cuBLAS bfloat16 call
    is needed there.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

KEY = 'model.decoder_matmul_precision'
SESSION_KEY = 'matmul_precision'
FLOAT32 = (None, 'float32', 'highest', 'F32_F32_F32')
ONE_PASS = ('bfloat16', 'default', 'BF16_BF16_F32')
THREE_PASS = ('tensorfloat32', 'high', 'BF16_BF16_F32_X3')
SIX_PASS = ('BF16_BF16_F32_X6',)
NINE_PASS = ('BF16_BF16_F32_X9',)
_PASSES = {**{n: 0 for n in FLOAT32}, **{n: 1 for n in ONE_PASS},
           **{n: 3 for n in THREE_PASS}, **{n: 6 for n in SIX_PASS},
           **{n: 9 for n in NINE_PASS}}
# the products of each rule, as (part of a, part of b) of the split
# [hi, mid, lo], summed in this order (the small terms first)
PAIRS = {
    1: ((0, 0),),
    3: ((0, 1), (1, 0), (0, 0)),
    6: ((1, 1), (0, 2), (2, 0), (0, 1), (1, 0), (0, 0)),
    9: ((2, 2), (1, 2), (2, 1), (1, 1), (0, 2), (2, 0), (0, 1), (1, 0),
        (0, 0)),
}


def passes(precision: str | None, key: str = KEY) -> int:
    """0 for true float32, else the bfloat16 passes of each product;
    ValueError, naming `key` and the value, for a name the TPU's rules do
    not define."""
    try:
        return _PASSES[precision]
    except (KeyError, TypeError):
        raise ValueError(f'{key}: {precision!r} is not one of '
                         f'{[n for n in _PASSES if n]} (or absent)') from None


def pass_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One pass in plain PyTorch: bf16 operands a [M, K], b [K, N] as
    float32, multiplied in float32 (each product exact), [M, N] float32."""
    return a.float() @ b.float()


def one_pass(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] @ b [K, N] of bfloat16 operands, summed and returned in
    float32: cuBLAS on the card, `pass_plain` on the CPU."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    if a.device.type == 'cpu':
        return pass_plain(a, b)
    raise RuntimeError(f'no bfloat16 product on {a.device}')


def split(a: torch.Tensor, n_passes: int) -> tuple[torch.Tensor, ...]:
    """(bf16(a),) for one pass, (hi, lo) for three, (hi, mid, lo) for six
    and nine."""
    hi = a.to(torch.bfloat16)
    if n_passes == 1:
        return (hi,)
    rest = a - hi.float()
    mid = rest.to(torch.bfloat16)
    if n_passes == 3:
        return hi, mid
    return hi, mid, (rest - mid.float()).to(torch.bfloat16)


def products(a: tuple, b: tuple, n_passes: int, one=None
             ) -> torch.Tensor:
    """The sum of the passes (`PAIRS`) of split operands, each pass
    `one(a_i, b_j)` (`one_pass`, looked up at the call, by default): a0.b0,
    or a0.b1 + a1.b0 + a0.b0 (the small terms first), and so on."""
    one = one_pass if one is None else one
    out = None
    for i, j in PAIRS[n_passes]:
        term = one(a[i], b[j])
        out = term if out is None else out + term
    return out


def _wanted(ctx, i: int) -> bool:
    """Whether the backward pass that runs now uses input i's gradient.
    `needs_input_grad` says only that the input requires one; the engine
    knows whether this pass reaches it (tracking's `autograd.grad` over the
    pose does not reach the decoder weights, which autograd's own matmul
    backward then skips too).  For an input of `autograd.grad` itself the
    query raises, and its gradient is wanted."""
    if not ctx.needs_input_grad[i]:
        return False
    try:
        return torch._C._will_engine_execute_node(ctx.next_functions[i][0])
    except RuntimeError:
        return True


class _Product(torch.autograd.Function):
    """x [M, K] @ w [K, N] with its gradients at `n_passes` bf16 passes."""

    @staticmethod
    def forward(ctx, x, w, n_passes):
        xs, ws = split(x, n_passes), split(w, n_passes)
        ctx.n, ctx.parts = n_passes, len(xs)
        ctx.save_for_backward(*xs, *ws)
        return products(xs, ws, n_passes)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        xs, ws = saved[:ctx.parts], saved[ctx.parts:]
        gs = split(g, ctx.n)
        dx = dw = None
        if _wanted(ctx, 0):
            dx = products(gs, tuple(t.t() for t in ws), ctx.n)
        if _wanted(ctx, 1):
            pad = -xs[0].shape[0] % 8        # zero rows (the module's note)
            if pad:
                xs = tuple(F.pad(t, (0, 0, 0, pad)) for t in xs)
                gs = tuple(F.pad(t, (0, 0, 0, pad)) for t in gs)
            dw = products(tuple(t.t() for t in xs), gs, ctx.n)
        return dx, dw, None


def mm(x: torch.Tensor, w: torch.Tensor, precision: str | None
       ) -> torch.Tensor:
    """x [..., K] @ w [K, N] under `precision`."""
    n_passes = passes(precision)
    if n_passes == 0:
        return x @ w
    flat = x.reshape(-1, x.shape[-1])
    return _Product.apply(flat, w, n_passes).reshape(*x.shape[:-1],
                                                     w.shape[-1])


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
           precision: str | None) -> torch.Tensor:
    """`F.linear(x, w, b)` (w in `nn.Linear`'s [out, in] layout) under
    `precision`; the bias is added in float32 after the product."""
    if passes(precision) == 0:
        return F.linear(x, w, b)
    out = mm(x, w.t(), precision)
    return out if b is None else out + b


def _plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One batched pass on any device: bf16 operands as float32 through a
    float32 `matmul` (each product exact)."""
    return torch.matmul(a.float(), b.float())


def _transposed(parts: tuple) -> tuple:
    return tuple(t.transpose(-1, -2) for t in parts)


class _Batched(torch.autograd.Function):
    """a [..., M, K] @ b [..., K, N] (batch dimensions broadcast) with its
    gradients at `n_passes` bf16 passes, each the plain rule."""

    @staticmethod
    def forward(ctx, a, b, n_passes):
        sa, sb = split(a, n_passes), split(b, n_passes)
        ctx.n, ctx.parts = n_passes, len(sa)
        ctx.shapes = (a.shape, b.shape)
        ctx.save_for_backward(*sa, *sb)
        return products(sa, sb, n_passes, _plain)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        sa, sb = saved[:ctx.parts], saved[ctx.parts:]
        gs = split(g, ctx.n)
        da = db = None
        if _wanted(ctx, 0):
            da = products(gs, _transposed(sb), ctx.n,
                          _plain).sum_to_size(ctx.shapes[0])
        if _wanted(ctx, 1):
            db = products(_transposed(sa), gs, ctx.n,
                          _plain).sum_to_size(ctx.shapes[1])
        return da, db, None


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str | None
           ) -> torch.Tensor:
    """`torch.matmul(a, b)` of a [..., M, K] and b [..., K, N] under
    `precision` (`a @ b` itself at float32), forward and both gradients."""
    n_passes = passes(precision, SESSION_KEY)
    if n_passes == 0:
        return a @ b
    return _Batched.apply(a, b, n_passes)
