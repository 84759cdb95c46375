"""Carry the JAX package's parameters across: its decoder pytrees and flat
grids, given as nested dicts of numpy arrays, become the port's decoder
modules and tensors, so both packages compute the same function.

The JAX decoders store dense layers as {'w': [in, out], 'b': [out]} and the
Fourier matrix as 'embed_b'; `nn.Linear` holds weight [out, in].
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from nice_slam_tpu_torch.models.decoders import (
    DecoderConfig, init_imap_decoder, init_nice_decoders)


def _mlp_state(p: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
    state = {}
    for i, layer in enumerate(p['pts_linears']):
        state[f'pts_linears.{i}.weight'] = t(layer['w']).T
        state[f'pts_linears.{i}.bias'] = t(layer['b'])
    for i, layer in enumerate(p.get('fc_c', [])):
        state[f'fc_c.{i}.weight'] = t(layer['w']).T
        state[f'fc_c.{i}.bias'] = t(layer['b'])
    state['output_linear.weight'] = t(p['out']['w']).T
    state['output_linear.bias'] = t(p['out']['b'])
    if 'embed_b' in p:
        state['embedder._B'] = t(p['embed_b'])
    return state


def decoders_from_numpy(params_np: Mapping[str, Any], cfg: DecoderConfig
                        ) -> nn.ModuleDict:
    """{'middle'|'fine'|'color'|'coarse': JAX MLP pytree as numpy} (NICE),
    or {'imap': the JAX iMAP* decoder pytree} -> the port's decoder
    ModuleDict holding the same weights (the Fourier matrix included)."""
    if 'imap' in params_np:
        decs = nn.ModuleDict({'imap': init_imap_decoder(
            cfg, generator=None, device='cpu')})
    else:
        decs = init_nice_decoders(cfg, generator=None, device='cpu')
    for name, p in params_np.items():
        state = _mlp_state(p)
        own = dict(decs[name].named_parameters())
        if set(state) != set(own):
            raise KeyError(f'{name}: parameter names differ: '
                           f'{sorted(set(state) ^ set(own))}')
        with torch.no_grad():
            for key, val in state.items():
                own[key].copy_(val)
    return decs


def grids_from_numpy(grids_np: Mapping[str, Any]
                     ) -> dict[str, torch.Tensor]:
    """{name: flat [M, C] numpy grid} -> {name: float32 CPU tensor}."""
    return {name: torch.tensor(np.asarray(g, dtype=np.float32))
            for name, g in grids_np.items()}
