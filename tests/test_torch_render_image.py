"""Port parity of `render_image` (render/renderer.py): a whole 30x40 frame
in ray chunks that do not divide H*W (the tail chunk padded), with and
without sensor depth, on the plain and the fused decoder path, against the
JAX package's `render_image` on the same model.

Tolerance: 1e-4 absolute and relative, as for render_rays in
tests/test_torch_models.py (float32 decoders, then a 24-sample composite).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nice_slam_tpu.core.cameras import Intrinsics as JIntrinsics
from nice_slam_tpu.render import renderer as jr
from nice_slam_tpu_torch.core.cameras import Intrinsics
from nice_slam_tpu_torch.render import renderer as tr
from tests.test_torch_util import jax_nice_setup, np_of, t_of

torch.set_num_threads(2)

H, W = 30, 40


@pytest.fixture(scope='module')
def setup():
    return jax_nice_setup(0)


def _frame():
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.1, -0.05, 0.2]
    ang = 0.3
    c2w[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                   [-np.sin(ang), 0, np.cos(ang)]]
    depth = np.random.default_rng(1).uniform(0.4, 1.2, (H, W)).astype(
        np.float32)
    depth[::7, ::5] = 0.0
    return c2w, depth


@pytest.mark.parametrize('with_depth', [True, False])
@pytest.mark.parametrize('fused', [False, True])
def test_render_image_matches_jax(setup, with_depth, fused):
    jmodel, params, grids, tmodel, decs, tgrids = setup
    c2w, depth = _frame()
    fx = 0.5 * W
    jintr = JIntrinsics(H, W, fx, fx, W / 2 - 0.5, H / 2 - 0.5)
    tintr = Intrinsics(H, W, fx, fx, W / 2 - 0.5, H / 2 - 0.5)
    # 500 rays per chunk: two full chunks and a padded tail of 200
    jrcfg = jr.RenderConfig(n_samples=16, n_surface=8, ray_chunk=500)
    trcfg = tr.RenderConfig(n_samples=16, n_surface=8, ray_chunk=500)
    want = jr.render_image(params, grids, jnp.asarray(c2w), jintr,
                           stage='color', model=jmodel, rcfg=jrcfg,
                           gt_depth=jnp.asarray(depth) if with_depth
                           else None)
    got = tr.render_image(decs, tgrids, t_of(c2w), tintr, stage='color',
                          model=tmodel._replace(fused_eval=fused),
                          rcfg=trcfg,
                          gt_depth=t_of(depth) if with_depth else None)
    for a, b, shape in zip(got, want, [(H, W), (H, W), (H, W, 3)]):
        assert tuple(a.shape) == shape
        np.testing.assert_allclose(np_of(a), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)
