"""The port's driver entry points (nice_slam_tpu_torch/graft_entry.py)
against the JAX package's `__graft_entry__.py`: `entry()`'s forward step
on the JAX entry's inputs carried across (models/convert.py) within
tests/test_torch_render_image.py's 1e-4, and `dryrun_multichip` on two
gloo ranks on the CPU."""

import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from nice_slam_tpu_torch import graft_entry
from nice_slam_tpu_torch.models.convert import (
    decoders_from_numpy, grids_from_numpy)
from nice_slam_tpu_torch.models.decoders import DecoderConfig
from tests.test_torch_util import np_of, t_of, tree_np

torch.set_num_threads(2)


def test_entry_matches_the_jax_entry():
    jfn, jargs = jentry.entry()
    want = jfn(*jargs)
    fn, args = graft_entry.entry(device='cpu')
    params, grids, rays_o, rays_d, gt_depth = jargs
    # the same rays and sensor depth as the JAX entry's
    for a, b in zip(args[2:], (rays_o, rays_d, gt_depth)):
        np.testing.assert_allclose(np_of(a), np_of(b), atol=1e-6)
    got = fn(decoders_from_numpy(tree_np(params), DecoderConfig()),
             grids_from_numpy(tree_np(grids)), t_of(rays_o), t_of(rays_d),
             t_of(gt_depth))
    for a, b, shape in zip(got, want, [(256,), (256,), (256, 3)]):
        assert tuple(a.shape) == shape
        np.testing.assert_allclose(np_of(a), np_of(b), atol=1e-4, rtol=1e-4)
    # the port's own draw renders finite values
    assert all(torch.isfinite(x).all() for x in fn(*args))


def test_dryrun_multichip_on_cpu_ranks(capfd):
    assert graft_entry.dryrun_multichip(2, device='cpu') == 'gloo'
    out = capfd.readouterr().out
    for step in ('ray-sharded ok', 'ray-sharded tracking ok',
                 'kf-sharded (window of 2 frames over 2 devices) ok',
                 'blocked-TP (block=2 x rays=1) ok'):
        assert f'dryrun_multichip(2): {step}' in out, out


def test_dryrun_multichip_needs_a_card_a_rank():
    """No quiet move to the CPU: with fewer cards than ranks (here, none)
    CUDA ranks raise before any starts."""
    with pytest.raises(RuntimeError):
        graft_entry.dryrun_multichip(torch.cuda.device_count() + 1)
