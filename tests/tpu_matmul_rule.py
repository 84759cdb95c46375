"""The TPU's matrix-unit precision rule on XLA:CPU, for tests and scripts.

XLA:CPU computes every float32 `dot_general` in float32 whatever precision
it carries, so a JAX function run on the CPU under
`jax.default_matmul_precision('bfloat16')` gives the float32 answer, not
the TPU's.  `tpu_matmul_rule()` re-registers the CPU lowering of
`dot_general_p` for the time of a `with` block, so that a product of two
float32 operands computes what the TPU's matrix unit does at the
precision the product was traced with:

  * HIGHEST ('float32', 'highest') and F32_F32_F32: float32, unchanged;
  * DEFAULT ('bfloat16', 'default'), BF16_BF16_F32, and no precision at
    all (the TPU's default): one pass -- both operands rounded to bfloat16
    (to nearest, ties to even), products and sums in float32;
  * HIGH ('tensorfloat32', 'high') and BF16_BF16_F32_X3: three passes --
    each operand split as hi = bf16(a), lo = bf16(a - hi), and
    a.b ~ hi.lo' + lo.hi' + hi.hi', the small terms first;
  * BF16_BF16_F32_X6 / _X9: a hi / mid / lo split (mid = bf16(a - hi),
    lo = bf16(a - hi - mid)) and six / nine of its products.

Each pass is a float32 dot of bfloat16 values, whose products are exact,
so only the float32 sums round.  The rule reaches every dot that is
lowered while the block is open: `@`, `jnp.einsum`, the transposes of a
VJP, dots inside `jit` and a Pallas kernel run in interpret mode.
Products of operands that are not float32 are left alone.
`jax.clear_caches()` runs on entry and on exit, so no executable compiled
under one rule is reused under the other.

    with tpu_matmul_rule(), jax.default_matmul_precision('bfloat16'):
        out = f(x)
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax._src.interpreters import mlir
from jax._src.lax import lax as lax_internal

_DOT = lax_internal.dot_general_p
_HIGHEST = (lax.Precision.HIGHEST, lax.Precision.HIGHEST)
_PRESETS = {
    lax.DotAlgorithmPreset.F32_F32_F32: 0,
    lax.DotAlgorithmPreset.BF16_BF16_F32: 1,
    lax.DotAlgorithmPreset.BF16_BF16_F32_X3: 3,
    lax.DotAlgorithmPreset.BF16_BF16_F32_X6: 6,
    lax.DotAlgorithmPreset.BF16_BF16_F32_X9: 9,
}
_BY_PRECISION = {lax.Precision.DEFAULT: 1, lax.Precision.HIGH: 3,
                 lax.Precision.HIGHEST: 0}
# the products of each rule, as (lhs part, rhs part) of the split
# [hi, mid, lo], summed in this order (the small terms first)
PAIRS = {
    1: ((0, 0),),
    3: ((0, 1), (1, 0), (0, 0)),
    6: ((1, 1), (0, 2), (2, 0), (0, 1), (1, 0), (0, 0)),
    9: ((2, 2), (1, 2), (2, 1), (1, 1), (0, 2), (2, 0), (0, 1), (1, 0),
        (0, 0)),
}


def passes(precision) -> int:
    """The bfloat16 passes of a dot traced with `precision` (0: float32)."""
    if precision is None:
        return 1
    if isinstance(precision, lax.DotAlgorithmPreset):
        if precision not in _PRESETS:
            raise NotImplementedError(f'no TPU rule for {precision}')
        return _PRESETS[precision]
    if isinstance(precision, lax.Precision):
        return _BY_PRECISION[precision]
    return max(passes(p) for p in precision)


def split(a, n_passes: int) -> list:
    """[hi], [hi, lo] or [hi, mid, lo] of float32 `a`, each a bfloat16
    value held in float32."""
    def bf16(x):
        return x.astype(jnp.bfloat16).astype(jnp.float32)

    parts, rest = [], a
    for _ in range({1: 1, 3: 2}.get(n_passes, 3)):
        parts.append(bf16(rest))
        rest = rest - parts[-1]
    return parts


@contextlib.contextmanager
def tpu_matmul_rule():
    """Lower every float32 dot on the CPU by the TPU's rule (module
    note) while the block is open."""
    table = mlir._platform_specific_lowerings['cpu']
    saved = table[_DOT]

    def rule(ctx, lhs, rhs, *, precision, **params):
        f32 = all(a.dtype == np.float32 for a in ctx.avals_in)
        n = passes(precision) if f32 else 0
        if n == 0:
            return saved.rule(ctx, lhs, rhs,
                              precision=_HIGHEST if f32 else None, **params)

        def emulated(a, b):
            sa, sb = split(a, n), split(b, n)
            out = None
            for i, j in PAIRS[n]:
                d = _DOT.bind(sa[i], sb[j], precision=_HIGHEST, **params)
                out = d if out is None else out + d
            return out

        return mlir.lower_fun(emulated, multiple_results=False)(
            ctx, lhs, rhs)

    jax.clear_caches()
    mlir.register_lowering(_DOT, rule, platform='cpu')
    try:
        yield
    finally:
        table[_DOT] = saved
        jax.clear_caches()


@contextlib.contextmanager
def session_precision(name: str | None):
    """`jax.default_matmul_precision(name)` under `tpu_matmul_rule()`,
    with the global default (which the JAX SlamSystem sets from its
    config) restored afterwards."""
    before = jax.config.jax_default_matmul_precision
    try:
        with tpu_matmul_rule(), jax.default_matmul_precision(name):
            yield
    finally:
        jax.config.update('jax_default_matmul_precision', before)
