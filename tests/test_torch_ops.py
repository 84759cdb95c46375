"""Port parity, ops: trilinear interpolation and the corner-expand / fold
kernel module (nice_slam_tpu_torch.ops) against nice_slam_tpu.ops.

On the CPU the expand/fold wrappers run their plain PyTorch versions; the
CUDA kernels are held against those same plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerances: the expansion is pure data movement, so it must be
bit-identical.  The fold sums up to 27 float32 terms per entry in a
different order on each side, hence 1e-5 (as tests/test_pallas.py holds
the Pallas fold); interpolation differs only by f32 summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nice_slam_tpu.ops.pallas.expand import expand_grid_pallas
from nice_slam_tpu.ops.trilinear import (
    expand_grid_xla, normalize_coords, trilinear_interp,
    trilinear_interp_expanded)
from nice_slam_tpu_torch.ops import expand as texp
from nice_slam_tpu_torch.ops import trilinear as ttri
from tests.test_torch_util import np_of, t_of

torch.set_num_threads(2)

# the shapes of tests/test_pallas.py (ragged and chunked cases)
SHAPES = [(5, 4, 3), (1, 4, 3), (4, 1, 3), (4, 3, 1), (1, 1, 1), (2, 2, 2),
          (7, 5, 6), (5, 38, 38)]


def _grid(shape, c, seed):
    m = shape[0] * shape[1] * shape[2]
    return np.random.default_rng(seed).normal(size=(m, c)).astype(np.float32)


@pytest.mark.parametrize('shape', SHAPES)
def test_expand_plain_bit_equal_to_jax(shape):
    g = _grid(shape, 8, 1)
    got = np_of(texp.expand_plain(t_of(g), shape))
    np.testing.assert_array_equal(
        got, np_of(expand_grid_xla(jnp.asarray(g), shape).e))
    np.testing.assert_array_equal(
        got, np_of(expand_grid_pallas(jnp.asarray(g), shape, True)))


@pytest.mark.parametrize('shape', SHAPES)
def test_fold_plain_matches_jax_folds(shape):
    m = shape[0] * shape[1] * shape[2]
    rng = np.random.default_rng(2)
    g = rng.normal(size=(m, 8)).astype(np.float32)
    cot = rng.normal(size=(m, 64)).astype(np.float32)
    got = np_of(texp.fold_plain(t_of(cot), shape))

    vjp_xla = jax.grad(lambda x: jnp.vdot(expand_grid_xla(x, shape).e,
                                          jnp.asarray(cot)))(jnp.asarray(g))
    vjp_pal = jax.grad(lambda x: jnp.vdot(
        expand_grid_pallas(x, shape, True), jnp.asarray(cot)))(
            jnp.asarray(g))
    np.testing.assert_allclose(got, np_of(vjp_xla), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, np_of(vjp_pal), atol=1e-5, rtol=1e-5)

    # and against the port's own autograd of the plain expansion
    gt = t_of(g).requires_grad_()
    auto, = torch.autograd.grad(texp.expand_plain(gt, shape), gt, t_of(cot))
    np.testing.assert_allclose(got, np_of(auto), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('shape', [(5, 4, 3), (1, 1, 1), (7, 5, 6)])
def test_expand_autograd_function_on_cpu(shape):
    """ExpandCorners on a CPU tensor: forward = expand_plain, backward =
    fold_plain, and no kernel launch is counted."""
    texp.reset_launch_counts()
    g = t_of(_grid(shape, 8, 3)).requires_grad_()
    e = ttri.expand_grid(g, shape).e
    np.testing.assert_array_equal(np_of(e),
                                  np_of(texp.expand_plain(g, shape)))
    cot = torch.randn(e.shape, generator=torch.Generator().manual_seed(0))
    grad, = torch.autograd.grad(e, g, cot)
    np.testing.assert_array_equal(np_of(grad),
                                  np_of(texp.fold_plain(cot, shape)))
    assert texp.LAUNCHES == {'expand_corners': 0, 'fold_corners': 0}


def test_wrappers_refuse_other_devices():
    g = torch.zeros((8, 4), device='meta')
    with pytest.raises(ValueError):
        texp.expand_corners(g, (2, 2, 2))
    with pytest.raises(ValueError):
        texp.fold_corners(torch.zeros((8, 32), device='meta'), (2, 2, 2))


@pytest.mark.parametrize('shape', [(5, 7, 6), (2, 2, 2), (9, 3, 4)])
def test_trilinear_matches(shape):
    rng = np.random.default_rng(4)
    m = shape[0] * shape[1] * shape[2]
    grid = rng.normal(size=(m, 8)).astype(np.float32)
    p_nor = rng.uniform(-1.3, 1.3, size=(200, 3)).astype(np.float32)
    want = np_of(trilinear_interp(jnp.asarray(grid), jnp.asarray(p_nor),
                                  shape))
    got = np_of(ttri.trilinear_interp(t_of(grid), t_of(p_nor), shape))
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=1e-5)
    eg_j = expand_grid_xla(jnp.asarray(grid), shape)
    eg_t = ttri.expand_grid(t_of(grid), shape)
    got_e = np_of(ttri.trilinear_interp_expanded(eg_t, t_of(p_nor)))
    want_e = np_of(trilinear_interp_expanded(eg_j, jnp.asarray(p_nor)))
    np.testing.assert_allclose(got_e, want_e, atol=2e-6, rtol=1e-5)
    np.testing.assert_allclose(got_e, got, atol=2e-6, rtol=1e-5)


def test_sample_grid_feature_gradients_match():
    """Grid and point gradients through normalize + expanded interpolation
    (the mapper's path: gather backward, then the fold)."""
    shape = (6, 5, 4)
    rng = np.random.default_rng(5)
    grid = rng.normal(size=(120, 8)).astype(np.float32)
    bound = np.array([[-1, 1], [-0.5, 0.7], [0, 2]], np.float32)
    p = rng.uniform(-0.9, 0.9, size=(300, 3)).astype(np.float32) \
        + np.array([0, 0.1, 1.0], np.float32)
    w = rng.normal(size=(300, 8)).astype(np.float32)
    np.testing.assert_allclose(
        np_of(ttri.normalize_coords(t_of(p), t_of(bound))),
        np_of(normalize_coords(jnp.asarray(p), jnp.asarray(bound))),
        atol=1e-6)

    from nice_slam_tpu.ops.trilinear import sample_grid_feature as jsample

    def jloss(g, p):
        eg = expand_grid_xla(g, shape)
        return jnp.sum(jsample(eg, p, jnp.asarray(bound)) * w)

    gj = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(grid), jnp.asarray(p))
    gt_, pt = t_of(grid).requires_grad_(), t_of(p).requires_grad_()
    loss = torch.sum(ttri.sample_grid_feature(
        ttri.expand_grid(gt_, shape), pt, t_of(bound)) * t_of(w))
    gt = torch.autograd.grad(loss, [gt_, pt])
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(np_of(a), np_of(b), atol=2e-5, rtol=1e-4)
