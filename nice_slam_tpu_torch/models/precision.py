"""Matrix products of the decoder stack at the precision the config asks
for (`model.decoder_matmul_precision`); port of the scope that
`nice_slam_tpu/models/decoders._prec_ctx` puts around every product of the
decoders, backward included.

The rules are those of the TPU's matrix unit; bfloat16 products on the
H100's tensor cores follow them up to the order of the float32 sums:

  * `None`, 'float32', 'highest': true float32, `F.linear` / `@` as
    before (TF32 stays off, `SlamSystem` sets it).
  * 'bfloat16', 'default', 'fastest', 'BF16_BF16_F32': one pass.  Each
    operand is rounded to bfloat16 (to nearest, ties to even), the products
    are summed in float32 and the output is float32; a bias is added in
    float32 afterwards.
  * 'BF16_BF16_F32_X3', 'high', 'tensorfloat32': three passes.  Each
    operand splits as hi = bf16(a), lo = bf16(a - hi), and
    a.b ~ hi.lo' + lo.hi' + hi.hi': three one-pass products summed in
    float32.

The gradients follow the same rule, as the JAX VJP replays the scope:
dX = G.W^T and dW = X^T.G as products of the same kind (the bias
gradient, the sum of G over the rows, and the activations stay float32).
Parameters and optimizer state stay float32; only the operands of each
product are rounded, and the forward keeps its rounded copy of X for the
backward.

A pass on a CUDA tensor is `torch.mm(a_bf16, b_bf16, out_dtype=float32)`
(`aten::mm.dtype`: cuBLAS bfloat16 with a float32 output, never rounded to
bfloat16).  The weight gradient X^T.G sums over the rows, and they are
padded with zero rows to a multiple of 8 when their count is not one:
cuBLAS (torch 2.11, CUDA 12.8, H100) summed 4,097 and 8,193 rows 1.0-1.6%
(rms) off the float32 sum, about one product left out, and every one of
487 counts tried right once padded (scripts/port_precision_probe.py).  On
a CPU tensor a pass is the plain version `pass_plain`: the operands'
bfloat16 values in float32, whose products are exact, so only the sum
rounds.  Any other device raises; there is no fallback.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

KEY = 'model.decoder_matmul_precision'
FLOAT32 = (None, 'float32', 'highest')
ONE_PASS = ('bfloat16', 'default', 'fastest', 'BF16_BF16_F32')
THREE_PASS = ('BF16_BF16_F32_X3', 'high', 'tensorfloat32')


def passes(precision: str | None) -> int:
    """0 for true float32, else the bfloat16 passes of each product;
    ValueError for a name the TPU's rules do not define."""
    if precision in FLOAT32:
        return 0
    if precision in ONE_PASS:
        return 1
    if precision in THREE_PASS:
        return 3
    raise ValueError(
        f'{KEY}: {precision!r} is not one of '
        f'{[*FLOAT32[1:], *ONE_PASS, *THREE_PASS]} (or absent)')


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
    """(bf16(a),) for one pass, (hi, lo) for three."""
    hi = a.to(torch.bfloat16)
    if n_passes == 1:
        return (hi,)
    return hi, (a - hi.float()).to(torch.bfloat16)


def products(a: tuple, b: tuple) -> torch.Tensor:
    """The sum of the passes of split operands: a0.b0, or
    a0.b1 + a1.b0 + a0.b0 (the small terms first)."""
    if len(a) == 1:
        return one_pass(a[0], b[0])
    return one_pass(a[0], b[1]) + one_pass(a[1], b[0]) + one_pass(a[0], b[0])


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
        ctx.n = len(xs)
        ctx.save_for_backward(*xs, *ws)
        return products(xs, ws)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        xs, ws = saved[:ctx.n], saved[ctx.n:]
        gs = split(g, 1 if ctx.n == 1 else 3)
        dx = dw = None
        if _wanted(ctx, 0):
            dx = products(gs, tuple(t.t() for t in ws))
        if _wanted(ctx, 1):
            pad = -xs[0].shape[0] % 8        # zero rows (the module's note)
            if pad:
                xs = tuple(F.pad(t, (0, 0, 0, pad)) for t in xs)
                gs = tuple(F.pad(t, (0, 0, 0, pad)) for t in gs)
            dw = products(tuple(t.t() for t in xs), gs)
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
