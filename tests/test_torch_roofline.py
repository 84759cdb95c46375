"""Port parity, ops: the streaming-roofline probes
(nice_slam_tpu_torch.ops.roofline) against the bodies of the JAX roofline
study (scripts/studies/proto_expand_roofline.py: `pallas_copy` and the
`concat8`, `shifts_only` and `full` bodies of `variants`), run here as
plain jnp functions on x-planes with the JAX package's `_plane_masks` and
`_shift_up`.

On the CPU the wrapper runs the plain versions; the CUDA kernel is held
against them on the card (tests/test_torch_cuda.py, chip_smoke.py).  Every
probe is data movement plus, in `shifts`, one float add per output, done
in the same order on both sides: all are bit-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nice_slam_tpu.ops.pallas.expand import _plane_masks, _shift_up
from nice_slam_tpu_torch.ops import expand as texp
from nice_slam_tpu_torch.ops import roofline as rf
from tests.test_torch_util import np_of, t_of

torch.set_num_threads(2)

SHAPES = [(5, 4, 3), (1, 4, 3), (4, 1, 3), (4, 3, 1), (1, 1, 1), (3, 6, 5)]


def _jax_bodies(nz, masks):
    """The study's kernel bodies, one x-plane `cur` [P, C] each."""
    zlast = masks[:, 0:1]
    ylast = masks[:, 1:2]

    def sz(v):
        return jnp.where(zlast > 0, v, _shift_up(v, 1))

    def sy(v):
        return jnp.where(ylast > 0, v, _shift_up(v, nz))

    def concat8(cur):
        return jnp.concatenate([cur] * 8, axis=-1)

    def shifts_only(cur):
        return sz(cur) + sy(cur)

    def full(cur):
        blocks = []
        for base in (cur, cur):
            for by in (base, sy(base)):
                blocks.append(by)
                blocks.append(sz(by))
        return jnp.concatenate(blocks, axis=-1)

    return {'widen8': concat8, 'shifts': shifts_only, 'expand_same_x': full}


def _jax_probe(mode, x, shape):
    nx, ny, nz = shape
    if mode == 'copy':
        return np.asarray(jnp.asarray(x) * 1.0)
    body = _jax_bodies(nz, jnp.asarray(_plane_masks(ny, nz)))[mode]
    planes = jnp.asarray(x).reshape(nx, ny * nz, x.shape[-1])
    out = jnp.stack([body(planes[i]) for i in range(nx)])
    return np.asarray(out).reshape(x.shape[0], -1)


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('mode', rf.MODES)
def test_probe_plain_equals_jax_body(mode, shape):
    m = shape[0] * shape[1] * shape[2]
    c = 8
    x = np.random.default_rng(0).normal(
        size=(m, 8 * c if mode == 'copy' else c)).astype(np.float32)
    want = _jax_probe(mode, x, shape)
    got = np_of(rf.probe_plain(mode, t_of(x), shape))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np_of(rf.probe(mode, t_of(x), shape)),
                                  want)


def test_plane_helpers_equal_jax():
    for ny, nz in ((1, 1), (4, 3), (5, 1), (1, 6)):
        np.testing.assert_array_equal(np_of(rf.plane_masks(ny, nz)),
                                      _plane_masks(ny, nz))
        v = np.arange(ny * nz * 2, dtype=np.float32).reshape(ny * nz, 2)
        for k in (0, 1, nz):
            np.testing.assert_array_equal(
                np_of(rf.shift_up(t_of(v), k)),
                np.asarray(_shift_up(jnp.asarray(v), k)))


@pytest.mark.parametrize('shape', [(1, 4, 3), (3, 6, 5), (2, 1, 1)])
def test_expand_same_x_is_the_expansion_on_one_plane(shape):
    """With one x-plane the dx = 1 corners clamp onto the same plane, so
    the probe equals the expansion itself."""
    shape = (1,) + shape[1:]
    x = np.random.default_rng(1).normal(
        size=(shape[1] * shape[2], 4)).astype(np.float32)
    np.testing.assert_array_equal(
        np_of(rf.expand_same_x_plain(t_of(x), shape)),
        np_of(texp.expand_plain(t_of(x), shape)))


def test_probe_bytes_and_bad_mode():
    x = torch.zeros((10, 8))
    assert rf.probe_bytes('copy', x) == 2 * 320
    assert rf.probe_bytes('widen8', x) == 9 * 320
    with pytest.raises(ValueError):
        rf.probe('nope', x)
