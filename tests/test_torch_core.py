"""Port parity, L0: cameras, sampling and compositing of
nice_slam_tpu_torch.core against nice_slam_tpu.core on the same inputs.

Tolerances: both sides compute in float32 with the same formulas, so
results agree to float32 rounding (~1e-6 relative); the tolerances below
leave room for the different operation order of XLA's and torch's CPU
kernels (matmul/einsum accumulation, fused multiply-adds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nice_slam_tpu.core import cameras as jc
from nice_slam_tpu.core import composite as jcomp
from nice_slam_tpu.core import sampling as js
from nice_slam_tpu_torch.core import cameras as tc
from nice_slam_tpu_torch.core import composite as tcomp
from nice_slam_tpu_torch.core import sampling as ts
from tests.test_torch_util import np_of, t_of

torch.set_num_threads(2)

INTR = (60, 80, 40.0, 40.0, 39.5, 29.5)


def _quats(n, seed):
    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    return q


def test_quat_to_rotmat_matches():
    q = _quats(64, 0) * 1.7   # non-unit on purpose
    np.testing.assert_allclose(np_of(tc.quat_to_rotmat(t_of(q))),
                               np_of(jc.quat_to_rotmat(jnp.asarray(q))),
                               atol=2e-6)


def test_rotmat_to_quat_matches():
    q = _quats(64, 1)
    rot = np_of(jc.quat_to_rotmat(jnp.asarray(q)))
    np.testing.assert_allclose(np_of(tc.rotmat_to_quat(t_of(rot))),
                               np_of(jc.rotmat_to_quat(jnp.asarray(rot))),
                               atol=2e-6)


def test_c2w_tensor_roundtrip_matches():
    rng = np.random.default_rng(2)
    cam7 = np.concatenate([_quats(16, 2), rng.normal(size=(16, 3))],
                          -1).astype(np.float32)
    for jf, tf in ((jc.c2w_from_tensor, tc.c2w_from_tensor),
                   (jc.c2w_from_tensor_4x4, tc.c2w_from_tensor_4x4)):
        np.testing.assert_allclose(np_of(tf(t_of(cam7))),
                                   np_of(jf(jnp.asarray(cam7))), atol=2e-6)
    c2w = np_of(jc.c2w_from_tensor_4x4(jnp.asarray(cam7)))
    np.testing.assert_allclose(np_of(tc.tensor_from_c2w(t_of(c2w))),
                               np_of(jc.tensor_from_c2w(jnp.asarray(c2w))),
                               atol=2e-6)


def test_rays_match():
    rng = np.random.default_rng(3)
    intr_j, intr_t = jc.Intrinsics(*INTR), tc.Intrinsics(*INTR)
    i = rng.integers(0, 80, 50).astype(np.float32)
    j = rng.integers(0, 60, 50).astype(np.float32)
    cam7 = np.concatenate([_quats(1, 3)[0], [0.1, -0.2, 0.3]]).astype(
        np.float32)
    c2w = np_of(jc.c2w_from_tensor(jnp.asarray(cam7)))
    for a, b in zip(tc.rays_from_uv(t_of(i), t_of(j), t_of(c2w), intr_t),
                    jc.rays_from_uv(jnp.asarray(i), jnp.asarray(j),
                                    jnp.asarray(c2w), intr_j)):
        np.testing.assert_allclose(np_of(a), np_of(b), atol=1e-5)
    for a, b in zip(tc.rays_full_image(t_of(c2w), intr_t),
                    jc.rays_full_image(jnp.asarray(c2w), intr_j)):
        np.testing.assert_allclose(np_of(a), np_of(b), atol=1e-5)
    assert intr_t.scaled_to(30, 40) == tuple(intr_j.scaled_to(30, 40))
    assert intr_t.cropped_by(5) == tuple(intr_j.cropped_by(5))


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    depth = rng.uniform(0.2, 2.0, n).astype(np.float32)
    depth[::7] = 0.0
    return o, d, depth


BOUND = np.array([[-1.0, 1.0], [-0.8, 0.8], [-1.2, 1.1]], np.float32)


def test_sampling_matches():
    o, d, depth = _rays(64, 4)
    np.testing.assert_allclose(
        np_of(ts.ray_bound_exit(t_of(o), t_of(d), t_of(BOUND))),
        np_of(js.ray_bound_exit(jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(BOUND))), rtol=1e-6, atol=1e-6)
    for d_max in (None, 1.7):
        nf_t = ts.near_far_from_depth(
            t_of(o), t_of(d), t_of(BOUND), t_of(depth),
            d_max=None if d_max is None else torch.tensor(d_max))
        nf_j = js.near_far_from_depth(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(BOUND),
            jnp.asarray(depth),
            d_max=None if d_max is None else jnp.float32(d_max))
        for a, b in zip(nf_t, nf_j):
            np.testing.assert_allclose(np_of(a), np_of(b), rtol=1e-6,
                                       atol=1e-6)
        np.testing.assert_allclose(
            np_of(ts.surface_z_vals(
                8, t_of(depth),
                None if d_max is None else torch.tensor(d_max))),
            np_of(js.surface_z_vals(
                8, jnp.asarray(depth),
                None if d_max is None else jnp.float32(d_max))),
            rtol=1e-6, atol=1e-6)
    near, far = nf_j
    for lindisp in (False, True):
        np.testing.assert_allclose(
            np_of(ts.stratified_z_vals(16, t_of(near), t_of(far),
                                       lindisp=lindisp)),
            np_of(js.stratified_z_vals(16, near, far, lindisp=lindisp)),
            rtol=1e-6, atol=1e-6)
    # no sensor depth (the coarse stage)
    for a, b in zip(ts.near_far_from_depth(t_of(o), t_of(d), t_of(BOUND),
                                           None),
                    js.near_far_from_depth(jnp.asarray(o), jnp.asarray(d),
                                           jnp.asarray(BOUND), None)):
        np.testing.assert_allclose(np_of(a), np_of(b), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('grad_z', [False, True])
def test_near_far_pose_gradient_matches(grad_z):
    """grad_z decides whether the bbox-exit far bound carries a gradient
    to the rays; both sides must agree in both settings."""
    o, d, depth = _rays(32, 5)
    depth = np.full_like(depth, 50.0)   # far bound set by the bbox exit

    def jloss(o, d):
        near, far = js.near_far_from_depth(o, d, jnp.asarray(BOUND),
                                           jnp.asarray(depth), grad_z=grad_z)
        return jnp.sum(far * 1.3 + near)

    gj = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(o), jnp.asarray(d))
    ot, dt = t_of(o).requires_grad_(), t_of(d).requires_grad_()
    near, far = ts.near_far_from_depth(ot, dt, t_of(BOUND), t_of(depth),
                                       grad_z=grad_z)
    loss = torch.sum(far * 1.3 + near)
    if not grad_z:
        assert not loss.requires_grad
        assert all(float(np.abs(np_of(g)).max()) == 0.0 for g in gj)
        return
    gt = torch.autograd.grad(loss, [ot, dt])
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(np_of(a), np_of(b), rtol=1e-5, atol=1e-5)


def test_sample_pixels_range():
    g = torch.Generator().manual_seed(0)
    i, j = ts.sample_pixels(500, 5, 55, 7, 73, generator=g, device='cpu')
    assert i.dtype == torch.float32 and j.dtype == torch.float32
    assert int(j.min()) >= 5 and int(j.max()) < 55
    assert int(i.min()) >= 7 and int(i.max()) < 73


def test_gather_and_masked_median_match():
    rng = np.random.default_rng(6)
    img = rng.normal(size=(60, 80, 3)).astype(np.float32)
    i = rng.integers(0, 80, 40).astype(np.float32)
    j = rng.integers(0, 60, 40).astype(np.float32)
    np.testing.assert_array_equal(
        np_of(ts.gather_pixels(t_of(img), t_of(i), t_of(j))),
        np_of(js.gather_pixels(jnp.asarray(img), jnp.asarray(i),
                               jnp.asarray(j))))
    x = rng.normal(size=101).astype(np.float32)
    for mask in (rng.uniform(size=101) > 0.3, np.zeros(101, bool),
                 np.ones(101, bool)):
        got = ts.masked_median(t_of(x), torch.tensor(mask))
        want = js.masked_median(jnp.asarray(x), jnp.asarray(mask))
        np.testing.assert_array_equal(np_of(got), np_of(want))


def test_composite_matches_values_and_gradients():
    rng = np.random.default_rng(7)
    raw = rng.normal(size=(16, 24, 4)).astype(np.float32) * 2.0
    raw[0, :, 3] = 8.0    # saturated ray: the +1e-10 keeps grads finite
    raw[1, :, 3] = -40.0
    z = np.sort(rng.uniform(0.1, 5.0, size=(16, 24)), -1).astype(np.float32)
    d = rng.normal(size=(16, 3)).astype(np.float32)
    want = jcomp.composite_rays(jnp.asarray(raw), jnp.asarray(z),
                                jnp.asarray(d), occupancy=True)
    rt = t_of(raw).requires_grad_()
    got = tcomp.composite_rays(rt, t_of(z))
    for a, b in zip(got, want):
        np.testing.assert_allclose(np_of(a), np_of(b), rtol=1e-5, atol=1e-6)

    def jloss(r):
        dep, var, rgb, _ = jcomp.composite_rays(
            r, jnp.asarray(z), jnp.asarray(d), occupancy=True)
        return jnp.sum(dep) + jnp.sum(var) + jnp.sum(rgb ** 2)

    gj = jax.grad(jloss)(jnp.asarray(raw))
    dep, var, rgb, _ = got
    gt, = torch.autograd.grad(dep.sum() + var.sum() + (rgb ** 2).sum(), rt)
    assert torch.isfinite(gt).all()
    np.testing.assert_allclose(np_of(gt), np_of(gj), rtol=1e-4, atol=1e-5)
