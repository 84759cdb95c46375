"""The decoder stack's matmul precision (`model.decoder_matmul_precision`,
nice_slam_tpu_torch/models/precision.py) against the TPU's rules.

XLA:CPU drops the matmul precision: every JAX product on the CPU is
float32 whatever `jax.default_matmul_precision` says.  So these tests
state the rule and hold the port to it:

(a) One product, forward and its X and W gradients, for every accepted
    name (the six- and nine-pass presets among them), at a hidden-layer
    shape and the Fourier embedding's, against a float64 numpy reference
    of the rule with bfloat16 rounding from ml_dtypes.  Per element the
    tolerance is the float32 summation bound (K + 2) 2^-24 (|A_bf16|.|B_bf16|
    + |bias|) (K products and the bias added in float32; three passes add
    two sums), (K + n - 1) 2^-24 for n = 6 or 9 passes (n - 1 sums of the
    passes).  The float32 names give `F.linear`'s bits and autograd's.
(b) The iMAP* decoder at full width (hidden 256, 4 blocks, Fourier) at
    bfloat16 against the JAX package's own `mlp_apply` with `_dense` and
    `fourier_embed` patched to the one-pass rule (`jnp.dot` of bfloat16
    operands summed in float32), its parameters carried across.  The two
    sum in other orders, so a float32 sum that lands on the other side of
    a bfloat16 rounding boundary feeds the next layer an input one
    bfloat16 ulp (2^-8 relative) apart: at 4096 points 0.3-0.4% of the
    outputs move by more than 1e-4 of the largest output and the largest
    move is 1.2e-3-2.3e-3 of it (seeds 0-5).  Held: at least half the
    outputs bit-equal, at most 1% beyond 1e-4 and none beyond 5e-3 of the
    largest output.  The unpatched float32 `mlp_apply` differs from it at
    the bfloat16 level: its median change is 0.5-0.7% of the largest
    output, held at >= 0.1%.
(c) The NICE decoders at bfloat16, forward, against the same patched
    `mlp_apply` / `mlp_no_xyz_apply`.  The JAX package's `fc_c` product is
    a bare `@`, which the patch does not reach, so its operands (the grid
    feature and the `fc_c` weights) go to the JAX side rounded to bfloat16:
    a float32 product of bfloat16 values is the one-pass product.  The
    port gets them unrounded and rounds them itself.  Held as (b).
(d) `mlp_dispatch(fused=True)` follows the key: the fused path stands in
    for the JAX package's default eval path, whose decoders run under the
    scope (on the CPU it is the plain version at the key, bit for bit).
(e) A name outside the rules ('fastest' among them, which the JAX config
    rejects) raises when the config is read; a pass on a device other than
    the CPU and CUDA raises.
About 12 s of test time in one process (the NICE decoders through the
JAX package op by op 6 s, the iMAP* decoder 3 s).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from nice_slam_tpu.models import decoders as jd
from nice_slam_tpu_torch.models import decoders as td
from nice_slam_tpu_torch.models import precision as P
from nice_slam_tpu_torch.models.convert import decoders_from_numpy
from tests.test_torch_util import np_of, tree_np
from tests.util import make_test_cfg

torch.set_num_threads(2)

NAMES = [*P.FLOAT32, *P.ONE_PASS, *P.THREE_PASS, *P.SIX_PASS,
         *P.NINE_PASS]
# the products of each rule over the split [hi, mid, lo], as
# models/precision.PAIRS
PAIRS = {1: [(0, 0)], 3: [(0, 1), (1, 0), (0, 0)],
         6: [(1, 1), (0, 2), (2, 0), (0, 1), (1, 0), (0, 0)],
         9: [(i, j) for i in range(3) for j in range(3)]}


def _bf16(a: np.ndarray) -> np.ndarray:
    """Round float32 to bfloat16 (to nearest, ties to even), as float64."""
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(
        np.float64)


def _split(a: np.ndarray, n_passes: int) -> list:
    """[hi], [hi, lo] or [hi, mid, lo]: each part the bfloat16 value of
    what the parts before it leave of `a` (in float32)."""
    parts, rest = [], np.asarray(a, np.float32).astype(np.float64)
    for _ in range({1: 1, 3: 2}.get(n_passes, 3)):
        parts.append(_bf16(rest))
        rest = rest - parts[-1]
    return parts


def _rule(a: np.ndarray, b: np.ndarray, n_passes: int):
    """a @ b under the rule in float64, and sum |a_i||b_i| of its terms."""
    sa, sb = _split(a, n_passes), _split(b, n_passes)
    out = sum(sa[i] @ sb[j] for i, j in PAIRS[n_passes])
    mag = sum(np.abs(sa[i]) @ np.abs(sb[j]) for i, j in PAIRS[n_passes])
    return out, mag


def _within(got, want, mag, k, extra=0.0, n_passes=1):
    tol = (k + max(2, n_passes - 1)) * 2.0 ** -24 * (mag + extra)
    err = np.abs(np.asarray(got, np.float64) - want)
    assert (err <= tol).all(), float((err - tol).max())


@pytest.mark.parametrize('shape', [(96, 256, 64), (96, 3, 93)],
                         ids=['hidden', 'embedding'])
@pytest.mark.parametrize('name', NAMES)
def test_product_follows_the_rule(name, shape):
    m, k, n = shape
    rng = np.random.default_rng(k)
    x = (rng.normal(size=(m, k)) * rng.uniform(0.1, 30, (m, 1))).astype(
        np.float32)
    w = rng.normal(size=(n, k)).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    g = rng.normal(size=(m, n)).astype(np.float32)
    tx, tw, tb = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    out = P.linear(tx, tw, tb, name)
    out.backward(torch.from_numpy(g))
    n_passes = P.passes(name)
    if n_passes == 0:
        rx, rw, rb = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
        ref = F.linear(rx, rw, rb)
        ref.backward(torch.from_numpy(g))
        assert torch.equal(out, ref)
        for a, r in ((tx, rx), (tw, rw), (tb, rb)):
            assert torch.equal(a.grad, r.grad)
        return
    want, mag = _rule(x, w.T, n_passes)
    _within(np_of(out), want + b, mag, k, np.abs(b), n_passes)
    want, mag = _rule(g, w, n_passes)                     # dX = G W
    _within(np_of(tx.grad), want, mag, n, n_passes=n_passes)
    want, mag = _rule(g.T, x, n_passes)                   # dW = G^T X
    _within(np_of(tw.grad), want, mag, m, n_passes=n_passes)
    np.testing.assert_allclose(np_of(tb.grad), g.sum(0), rtol=1e-5,
                               atol=1e-5)
    if n_passes == 1:      # the forward's rounded copy is the rule's bits
        assert torch.equal(
            out.detach(),
            P.pass_plain(tx.detach().bfloat16(), tw.detach().t().bfloat16())
            + tb.detach())


def _bf16_dense(layer, x):
    return jnp.dot(x.astype(jnp.bfloat16), layer['w'].astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32) + layer['b']


def _bf16_fourier(b_matrix, p):
    return jnp.sin(jnp.dot(p.astype(jnp.bfloat16),
                           b_matrix.astype(jnp.bfloat16),
                           preferred_element_type=jnp.float32))


@pytest.fixture
def one_pass_jax(monkeypatch):
    """The JAX decoders as the TPU computes them under 'bfloat16'."""
    monkeypatch.setattr(jd, '_dense', _bf16_dense)
    monkeypatch.setattr(jd, 'fourier_embed', _bf16_fourier)


def _held(got, want):
    d = np.abs(got - want)
    top = np.abs(want).max()
    assert np.median(d) == 0.0
    assert (d > 1e-4 * top).mean() <= 0.01
    assert d.max() <= 5e-3 * top, d.max() / top


def test_imap_decoder_at_full_width(one_pass_jax):
    cfg = jd.DecoderConfig()
    params = jd.init_mlp(jax.random.PRNGKey(0), cfg, c_dim=0, color=True,
                         hidden=256, n_blocks=4, skips=())
    p = np.random.default_rng(0).uniform(-0.8, 0.8, (4096, 3)).astype(
        np.float32)
    want = np.asarray(jd.mlp_apply(params, cfg, jnp.asarray(p), None,
                                   color=True, skips=()))
    decs = decoders_from_numpy({'imap': tree_np(params)},
                               td.DecoderConfig(mm_precision='bfloat16'))
    got = np_of(td.imap_eval(decs['imap'], torch.from_numpy(p)))
    _held(got, want)
    f32 = decoders_from_numpy({'imap': tree_np(params)}, td.DecoderConfig())
    moved = np.abs(np_of(td.imap_eval(f32['imap'], torch.from_numpy(p)))
                   - got)
    assert np.median(moved) >= 1e-3 * np.abs(want).max()


def test_nice_decoders_at_bfloat16(one_pass_jax):
    cfg = jd.DecoderConfig()
    params = jd.init_nice_decoders(jax.random.PRNGKey(1), cfg)
    rng = np.random.default_rng(1)
    p = rng.uniform(-1.1, 1.1, (1024, 3)).astype(np.float32)
    c = rng.normal(size=(1024, 2 * cfg.c_dim)).astype(np.float32)
    decs = decoders_from_numpy(tree_np(params),
                               td.DecoderConfig(mm_precision='bfloat16'))
    rounded = jax.tree_util.tree_map(lambda a: a, params)
    for name in ('middle', 'fine', 'color'):
        rounded[name]['fc_c'] = [
            {'w': jnp.asarray(_bf16(l['w']), jnp.float32), 'b': l['b']}
            for l in params[name]['fc_c']]
    c_jax = jnp.asarray(_bf16(c), jnp.float32)
    for name, width in (('middle', 32), ('fine', 64), ('color', 32)):
        color = name == 'color'
        want = np.asarray(jd.mlp_apply(rounded[name], cfg, jnp.asarray(p),
                                       c_jax[:, :width], color=color))
        got = np_of(decs[name](torch.from_numpy(p),
                               torch.from_numpy(c[:, :width])))
        _held(got, want)
    want = np.asarray(jd.mlp_no_xyz_apply(params['coarse'], cfg,
                                          c_jax[:, :32]))
    _held(np_of(decs['coarse'](torch.from_numpy(c[:, :32]))), want)


def test_fused_path_ignores_the_key():
    """Since the session precision was ported the fused path follows the
    key (the name is kept): on the CPU `mlp_dispatch(fused=True)` is the
    decoder's own forward at bfloat16, bit for bit, not the float32 one."""
    gen = torch.Generator().manual_seed(2)
    f32 = td.init_nice_decoders(td.DecoderConfig(), generator=gen,
                                device='cpu')
    bf = td.init_nice_decoders(td.DecoderConfig(mm_precision='bfloat16'),
                               generator=None, device='cpu')
    bf.load_state_dict(f32.state_dict())
    rng = np.random.default_rng(2)
    p = torch.from_numpy(rng.uniform(-1, 1, (300, 3)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(300, 32)).astype(np.float32))
    with torch.no_grad():
        want = bf['middle'](p, c)
        assert torch.equal(td.mlp_dispatch(bf['middle'], p, c, fused=True),
                           want)
        assert torch.equal(td.mlp_dispatch(bf['middle'], p, c), want)
        assert not torch.equal(f32['middle'](p, c), want)


@pytest.mark.parametrize('value', ['float16', 'fastest', 'tf32'])
def test_unknown_precision_raises(value):
    from nice_slam_tpu_torch.utils.config import decoder_config_from_cfg
    cfg = make_test_cfg()
    cfg['model']['decoder_matmul_precision'] = value
    with pytest.raises(ValueError, match='model.decoder_matmul_precision'):
        decoder_config_from_cfg(cfg)
    with pytest.raises(ValueError, match=value):
        P.linear(torch.ones(2, 3), torch.ones(4, 3), None, value)


def test_config_sets_the_precision_and_other_devices_raise():
    from nice_slam_tpu_torch.utils.config import decoder_config_from_cfg
    cfg = make_test_cfg()
    assert decoder_config_from_cfg(cfg).mm_precision is None
    cfg['model']['decoder_matmul_precision'] = 'bfloat16'
    assert decoder_config_from_cfg(cfg).mm_precision == 'bfloat16'
    a = torch.ones(2, 3, device='meta', dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match='meta'):
        P.one_pass(a, a.t())


def test_bench_budget_takes_the_environment(monkeypatch):
    """NSTPU_MM_PRECISION sets the decoders' precision of tools.bench_budget
    at every scene, the `tum` case (scripts/bench_tum.py) among them."""
    from nice_slam_tpu_torch.tools import bench_budget
    _, cfg = bench_budget.load('tum')
    monkeypatch.delenv('NSTPU_MM_PRECISION', raising=False)
    assert bench_budget.decoder_config(cfg).mm_precision is None
    monkeypatch.setenv('NSTPU_MM_PRECISION', 'bfloat16')
    assert bench_budget.decoder_config(cfg).mm_precision == 'bfloat16'
    monkeypatch.setenv('NSTPU_MM_PRECISION', 'bf16')
    with pytest.raises(ValueError, match='bf16'):
        bench_budget.decoder_config(cfg)


def test_backward_computes_only_the_gradients_the_pass_uses(monkeypatch):
    """Tracking differentiates the pose alone (`autograd.grad`), so the
    decoder weights' products are left out, as autograd's own matmul
    backward leaves them; mapping's `autograd.grad` over the weights and
    `backward()` compute both."""
    calls = []
    one_pass = P.one_pass
    monkeypatch.setattr(P, 'one_pass',
                        lambda a, b: calls.append(1) or one_pass(a, b))
    x0 = torch.randn(64, 16, requires_grad=True)
    w = torch.randn(8, 16, requires_grad=True)

    def count(run):
        calls.clear()
        out = P.linear(torch.relu(x0 * 2.0), w, None, 'bfloat16').sum()
        run(out)
        return len(calls)

    assert count(lambda o: torch.autograd.grad(o, [x0])) == 2
    assert count(lambda o: torch.autograd.grad(o, [w])) == 2
    assert count(lambda o: torch.autograd.grad(o, [x0, w])) == 3
    assert count(lambda o: o.backward()) == 3


@pytest.mark.parametrize('rows', [4097, 8192])
def test_weight_gradient_rows_padded_to_eight(monkeypatch, rows):
    """X^T.G runs on rows padded with zeros to a multiple of 8 (cuBLAS
    summed 4,097 rows wrong on the card), which leaves the sum exact."""
    shapes = []
    one_pass = P.one_pass
    monkeypatch.setattr(P, 'one_pass', lambda a, b: shapes.append(
        (tuple(a.shape), tuple(b.shape))) or one_pass(a, b))
    rng = np.random.default_rng(rows)
    x = torch.tensor(rng.normal(size=(rows, 16)).astype(np.float32),
                     requires_grad=True)
    w = torch.tensor(rng.normal(size=(8, 16)).astype(np.float32),
                     requires_grad=True)
    g = rng.normal(size=(rows, 8)).astype(np.float32)
    P.linear(x, w, None, 'bfloat16').backward(torch.from_numpy(g))
    assert shapes[-1] == ((16, 8192 if rows == 8192 else 4104),
                          (8192 if rows == 8192 else 4104, 8))
    want, mag = _rule(g.T, x.detach().numpy(), 1)
    _within(np_of(w.grad), want, mag, rows)
