"""Shared helpers for the parity tests of the PyTorch port
(tests/test_torch_*.py): inputs are made with numpy from a seed, handed to
the JAX function and to its port counterpart, and compared as numpy.  The
tests here check models/convert.py, which carries the JAX parameters
across for all the others."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch


def np_of(x) -> np.ndarray:
    """numpy copy of a JAX array, a torch tensor or anything array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def t_of(x, dtype=torch.float32) -> torch.Tensor:
    """CPU torch tensor from a numpy / JAX array."""
    return torch.tensor(np.asarray(x), dtype=dtype)


def tree_np(tree):
    """A JAX parameter pytree as nested dicts/lists of numpy arrays."""
    return jax.tree.map(np.asarray, tree)


def jax_nice_setup(seed: int = 0, bound=((-1.0, 1.0), (-0.8, 0.8),
                                          (-1.0, 1.0))):
    """Random NICE decoders and grids from the JAX package plus the same
    model in the port: (jax_model, jax_params, jax_grids, port_model,
    port_decoders, port_grids)."""
    import jax.numpy as jnp

    from nice_slam_tpu.models.decoders import (
        DecoderConfig, init_nice_decoders)
    from nice_slam_tpu.models.grids import (
        GridConfig, init_grids, static_grid_shapes)
    from nice_slam_tpu.render.renderer import SceneModel
    from nice_slam_tpu_torch.models.convert import (
        decoders_from_numpy, grids_from_numpy)
    from nice_slam_tpu_torch.models.decoders import (
        DecoderConfig as TDecoderConfig)
    from nice_slam_tpu_torch.render.renderer import SceneModel as TSceneModel

    gcfg = GridConfig(bound=bound, coarse_grid_len=1.0, middle_grid_len=0.4,
                      fine_grid_len=0.2, color_grid_len=0.2)
    dcfg = DecoderConfig()
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    params = init_nice_decoders(k1, dcfg)
    grids = init_grids(k2, gcfg)
    # larger grid values than the init's, so the features matter
    rng = np.random.default_rng(seed)
    grids = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32)
                            * 0.3) for k, v in grids.items()}
    shapes = static_grid_shapes(gcfg)
    jmodel = SceneModel(kind='nice', decoder=dcfg,
                        bound=jnp.asarray(gcfg.bound_np),
                        coarse_bound=jnp.asarray(gcfg.coarse_bound_np),
                        grid_shapes=shapes)
    tdcfg = TDecoderConfig()
    tmodel = TSceneModel(decoder=tdcfg,
                         bound=torch.tensor(gcfg.bound_np),
                         coarse_bound=torch.tensor(gcfg.coarse_bound_np),
                         grid_shapes=shapes)
    decs = decoders_from_numpy(tree_np(params), tdcfg)
    tgrids = grids_from_numpy(tree_np(grids))
    return jmodel, params, grids, tmodel, decs, tgrids


def test_convert_carries_every_parameter():
    """Every JAX decoder leaf lands in the port module (Linear weights
    transposed) and every grid keeps its values."""
    _, params, grids, _, decs, tgrids = jax_nice_setup(1)
    for name, p in params.items():
        sd = decs[name].state_dict()
        for i, layer in enumerate(p['pts_linears']):
            np.testing.assert_array_equal(
                np_of(sd[f'pts_linears.{i}.weight']), np.asarray(layer['w']).T)
            np.testing.assert_array_equal(
                np_of(sd[f'pts_linears.{i}.bias']), np.asarray(layer['b']))
        for i, layer in enumerate(p.get('fc_c', [])):
            np.testing.assert_array_equal(
                np_of(sd[f'fc_c.{i}.weight']), np.asarray(layer['w']).T)
        np.testing.assert_array_equal(np_of(sd['output_linear.weight']),
                                      np.asarray(p['out']['w']).T)
        if 'embed_b' in p:
            np.testing.assert_array_equal(np_of(sd['embedder._B']),
                                          np.asarray(p['embed_b']))
    for name, g in grids.items():
        np.testing.assert_array_equal(np_of(tgrids[name]), np.asarray(g))


def test_convert_rejects_a_foreign_layout():
    from nice_slam_tpu_torch.models.convert import decoders_from_numpy
    from nice_slam_tpu_torch.models.decoders import DecoderConfig
    _, params, _, _, _, _ = jax_nice_setup(2)
    bad = tree_np(params['middle'])
    bad['pts_linears'] = bad['pts_linears'][:4]
    with pytest.raises(KeyError):
        decoders_from_numpy({'middle': bad}, DecoderConfig())
