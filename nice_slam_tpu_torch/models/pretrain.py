"""Load the ConvONet-pretrained decoder checkpoints into the decoder
modules, and write decoders in the same layout; port of
`nice_slam_tpu/models/pretrain.py`.

  * `pretrained_decoders.coarse` holds the coarse `MLP_no_xyz` under
    'decoder.*' keys;
  * `pretrained_decoders.middle_fine` holds both the middle and the fine
    decoders: middle's weights sit under the 'decoder.coarse.*' prefix (the
    reference's quirk) and fine's under 'decoder.fine.*'.

The modules use the reference's parameter names, so loading is a prefix
strip and saving a prefix add; torch Linear weights are [out, in] on both
sides.
"""

from __future__ import annotations

import os

import torch
from torch import nn


def _strip(state: dict, prefix: str) -> dict:
    return {key[len(prefix):]: val for key, val in state.items()
            if 'decoder' in key and 'encoder' not in key
            and key.startswith(prefix)}


def _load_into(module: nn.Module, state: dict) -> None:
    """Copy the checkpoint tensors into the module's parameters of the same
    name; every checkpoint key must name a parameter of the module."""
    params = dict(module.named_parameters())
    unknown = sorted(set(state) - set(params))
    if unknown:
        raise KeyError(f'checkpoint keys without a parameter: {unknown}')
    with torch.no_grad():
        for key, val in state.items():
            if params[key].shape != val.shape:
                raise ValueError(f'{key}: checkpoint shape {tuple(val.shape)}'
                                 f' != parameter {tuple(params[key].shape)}')
            params[key].copy_(val)


def load_torch_pretrain(decoders: nn.ModuleDict, pre_cfg: dict, *,
                        coarse: bool) -> None:
    """Fill `decoders` in place from the checkpoints named in `pre_cfg`
    ({'middle_fine': path, 'coarse': path})."""
    ckpt = torch.load(pre_cfg['middle_fine'], map_location='cpu',
                      weights_only=True)
    _load_into(decoders['middle'], _strip(ckpt['model'], 'decoder.coarse.'))
    _load_into(decoders['fine'], _strip(ckpt['model'], 'decoder.fine.'))
    path = pre_cfg.get('coarse')
    if coarse and path and os.path.exists(path):
        ckpt_c = torch.load(path, map_location='cpu', weights_only=True)
        _load_into(decoders['coarse'], _strip(ckpt_c['model'], 'decoder.'))


def _prefixed(module: nn.Module, prefix: str) -> dict:
    return {prefix + key: val.detach().cpu().clone()
            for key, val in module.state_dict().items()}


def save_torch_pretrain(decoders: nn.ModuleDict, coarse_path: str | None,
                        middle_fine_path: str) -> None:
    """Write `decoders` as reference-layout blobs, the inverse of
    `load_torch_pretrain`: `middle_fine_path` holds middle under
    'decoder.coarse.*' (the reference's quirk) and fine under
    'decoder.fine.*'; `coarse_path`, when given and the decoders have a
    coarse MLP, holds it under 'decoder.*'.  Each file is
    `torch.save({'model': state_dict})`."""
    torch.save({'model': {**_prefixed(decoders['middle'], 'decoder.coarse.'),
                          **_prefixed(decoders['fine'], 'decoder.fine.')}},
               middle_fine_path)
    if coarse_path is not None and 'coarse' in decoders:
        torch.save({'model': _prefixed(decoders['coarse'], 'decoder.')},
                   coarse_path)
