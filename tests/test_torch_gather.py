"""Port parity, ops: the row gather and its scatter-add backward
(nice_slam_tpu_torch.ops.gather) against the JAX package's row gather, and
the expanded-row interpolation with its gradient through the gather, the
scatter, the expansion and the fold.

On the CPU the wrappers run their plain PyTorch versions; the CUDA kernels
are held against those same plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: the gather is a copy, so it is bit-identical.  The scatter-add
sums the gradient rows of repeated indices in another order than XLA's
scatter: 1e-5 x max(1, max|ref|) covers float32 rounding of the at most
few hundred terms per row these tests draw.  The interpolation and its
gradient differ by f32 summation order (1e-5 and 1e-4 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nice_slam_tpu.ops.trilinear import ExpandedGrid as JExpandedGrid
from nice_slam_tpu.ops.trilinear import (
    expand_grid_xla, trilinear_interp_expanded)
from nice_slam_tpu_torch.ops import gather as tg
from nice_slam_tpu_torch.ops import trilinear as ttri
from tests.test_torch_util import np_of, t_of

torch.set_num_threads(2)

SCATTER_TOL = 1e-5


def _table_idx(m, w, n, seed, repeats=False):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(m, w)).astype(np.float32)
    if repeats:
        # sorted runs of a few rows each, as a ray's samples walk voxels
        # (the row study of scripts/studies/proto_pallas_gather.py)
        base = rng.integers(0, max(m - 8, 1), size=(-(-n // 6),))
        walk = np.sort(rng.integers(0, min(8, m), size=(len(base), 6)),
                       axis=1)
        idx = (base[:, None] + walk).reshape(-1)[:n] % m
    else:
        idx = rng.integers(0, m, size=(n,))
    return table, idx.astype(np.int32)


# the last two: one row hit by 2,000 positions, and no positions at all
CASES = [(37, 256, 1, False), (37, 256, 1023, True), (500, 256, 4097, True),
         (64, 512, 257, False), (300, 512, 1025, True), (1, 512, 33, True),
         (1, 256, 2000, False), (37, 256, 0, False)]


@pytest.mark.parametrize('m,w,n,repeats', CASES)
def test_gather_plain_equals_jax_take(m, w, n, repeats):
    table, idx = _table_idx(m, w, n, 1, repeats)
    want = np.asarray(jnp.asarray(table)[jnp.asarray(idx)])
    got = np_of(tg.gather_rows_plain(t_of(table),
                                     torch.as_tensor(idx, dtype=torch.long)))
    np.testing.assert_array_equal(got, want)
    # the wrapper on a CPU tensor is the plain version, int32 index too
    np.testing.assert_array_equal(
        np_of(tg.gather_rows(t_of(table), torch.as_tensor(idx))), want)


@pytest.mark.parametrize('m,w,n,repeats', CASES)
def test_scatter_add_plain_equals_jax_transpose(m, w, n, repeats):
    table, idx = _table_idx(m, w, n, 2, repeats)
    grad = np.random.default_rng(3).normal(size=(n, w)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: t[jnp.asarray(idx)], jnp.asarray(table))
    want, = vjp(jnp.asarray(grad))
    want = np.asarray(want)
    tol = SCATTER_TOL * max(1.0, float(np.abs(want).max()))
    ti = torch.as_tensor(idx, dtype=torch.long)
    for got in (tg.scatter_add_rows_plain(t_of(grad), ti, m),
                tg.scatter_add_rows_ordered_plain(t_of(grad), ti, m),
                tg.scatter_add_rows(t_of(grad), ti, m)):
        np.testing.assert_allclose(np_of(got), want, rtol=0, atol=tol)
    # autograd of GatherRows reaches the same transpose
    tt = t_of(table).requires_grad_(True)
    out = tg.GatherRows.apply(tt, ti)
    g, = torch.autograd.grad(out, tt, t_of(grad))
    np.testing.assert_allclose(np_of(g), want, rtol=0, atol=tol)


@pytest.mark.parametrize('shape,c', [((5, 4, 3), 32), ((7, 5, 6), 64),
                                     ((1, 4, 3), 8), ((9, 7, 5), 32)])
def test_interp_and_grad_through_gather_match_jax(shape, c):
    """Forward and the gradient with respect to the flat grid (gather ->
    scatter -> fold) against jax.grad of the JAX expanded-row path."""
    m = shape[0] * shape[1] * shape[2]
    rng = np.random.default_rng(4)
    grid = rng.normal(size=(m, c)).astype(np.float32)
    # points inside and outside [-1, 1] (clamped) and on voxel borders
    p = rng.uniform(-1.1, 1.1, size=(700, 3)).astype(np.float32)
    p[:20] = np.round(p[:20] * 2) / 2
    cot = rng.normal(size=(700, c)).astype(np.float32)

    def jax_loss(g):
        eg = JExpandedGrid(expand_grid_xla(g, shape).e, shape)
        return jnp.vdot(trilinear_interp_expanded(eg, jnp.asarray(p)),
                        jnp.asarray(cot))

    j_out = trilinear_interp_expanded(
        JExpandedGrid(expand_grid_xla(jnp.asarray(grid), shape).e, shape),
        jnp.asarray(p))
    j_grad = jax.grad(jax_loss)(jnp.asarray(grid))

    tgrid = t_of(grid).requires_grad_(True)
    t_out = ttri.trilinear_interp_expanded(ttri.expand_grid(tgrid, shape),
                                           t_of(p))
    t_grad, = torch.autograd.grad(t_out, tgrid, t_of(cot))
    np.testing.assert_allclose(np_of(t_out), np_of(j_out), rtol=1e-5,
                               atol=1e-5)
    scale = max(1.0, float(np.abs(np_of(j_grad)).max()))
    np.testing.assert_allclose(np_of(t_grad), np_of(j_grad), rtol=0,
                               atol=1e-4 * scale)
    assert t_grad.shape == tgrid.shape


@pytest.mark.parametrize('m,w,n,repeats', CASES)
def test_ordered_scatter_plain_is_index_add_bit_for_bit(m, w, n, repeats):
    """The kernel's order (each target row summed from 0 over its positions
    in ascending order) gives index_add_'s bits on the CPU, int32 and int64
    indices alike."""
    _, idx = _table_idx(m, w, n, 5, repeats)
    grad = t_of(np.random.default_rng(6).normal(size=(n, w))
                .astype(np.float32))
    want = tg.scatter_add_rows_plain(
        grad, torch.as_tensor(idx, dtype=torch.long), m)
    for ti in (torch.as_tensor(idx), torch.as_tensor(idx, dtype=torch.long)):
        assert torch.equal(tg.scatter_add_rows_ordered_plain(grad, ti, m),
                           want)


def _graph_nodes(t):
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(nxt for nxt, _ in fn.next_functions)
    return {type(fn).__name__ for fn in seen}


def test_tracker_snapshot_path_launches_no_scatter(monkeypatch):
    """The tracker samples a no_grad snapshot of the expansion: its pose
    gradient reaches no GatherRows backward, while the mapper's does."""
    from nice_slam_tpu_torch.models.grids import prepare_grids
    calls = []
    plain = tg.scatter_add_rows

    def counting(grad, idx, m):
        calls.append(m)
        return plain(grad, idx, m)

    monkeypatch.setattr(tg, 'scatter_add_rows', counting)
    shape, c = (6, 5, 4), 8
    m = shape[0] * shape[1] * shape[2]
    grid = torch.randn((m, c), generator=torch.Generator().manual_seed(0),
                       requires_grad=True)
    grids = {'middle': grid}
    shapes = (('middle', shape),)
    p = torch.rand((64, 3), generator=torch.Generator().manual_seed(1)) - .5
    offset = torch.zeros(3, requires_grad=True)
    with torch.no_grad():
        snap = prepare_grids(grids, shapes, stage='middle')
    out = ttri.trilinear_interp_expanded(snap['middle'], p + offset)
    assert 'GatherRowsBackward' not in _graph_nodes(out.sum())
    torch.autograd.grad(out.sum(), offset)
    assert calls == []
    live = prepare_grids(grids, shapes, stage='middle')
    out = ttri.trilinear_interp_expanded(live['middle'], p + offset)
    assert 'GatherRowsBackward' in _graph_nodes(out.sum())
    torch.autograd.grad(out.sum(), grid)
    assert calls == [m]


def test_direct_gather_when_the_table_needs_no_gradient(monkeypatch):
    """A table that needs no gradient (a detached snapshot, or any table
    under no_grad) is gathered by gather_rows directly: same output and
    pose gradient as through GatherRows, and no GatherRowsBackward node."""
    direct = []
    plain = ttri.gather_rows

    def counting(table, idx):
        direct.append(idx.shape[0])
        return plain(table, idx)

    monkeypatch.setattr(ttri, 'gather_rows', counting)
    shape, c = (6, 5, 4), 8
    m = shape[0] * shape[1] * shape[2]
    grid = torch.randn((m, c), generator=torch.Generator().manual_seed(2),
                       requires_grad=True)
    p = torch.rand((64, 3), generator=torch.Generator().manual_seed(3)) - .5
    offset = torch.zeros(3, requires_grad=True)
    live = ttri.expand_grid(grid, shape)
    frozen = ttri.ExpandedGrid(live.e.detach(), shape)
    a = ttri.trilinear_interp_expanded(live, p + offset)
    assert direct == []
    b = ttri.trilinear_interp_expanded(frozen, p + offset)
    assert direct == [64]
    assert torch.equal(a, b)
    assert 'GatherRowsBackward' in _graph_nodes(a.sum())
    assert 'GatherRowsBackward' not in _graph_nodes(b.sum())
    ga, = torch.autograd.grad(a.sum(), offset)
    gb, = torch.autograd.grad(b.sum(), offset)
    assert torch.equal(ga, gb)
    with torch.no_grad():
        c_out = ttri.trilinear_interp_expanded(live, p)
    assert direct == [64, 64]
    assert torch.equal(c_out, a.detach())
