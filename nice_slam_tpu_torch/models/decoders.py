"""Scene-representation decoders (L1); port of
`nice_slam_tpu/models/decoders.py`.

  * `MLP` (middle/fine/color): positional embedding -> n_blocks dense+ReLU
    layers, each followed by a grid-feature injection `h += fc_c[i](c)`,
    the embedding concatenated back in after each block in `skips`.
  * `MLP_no_xyz` (coarse): the grid feature alone is the input.
  * `nice_eval`: coarse -> occ; middle -> occ; fine -> fine + middle occ
    (the middle feature enters the fine decoder with its gradient stopped);
    color -> rgb from the color decoder with occ from fine + middle.
  * iMAP*: one `MLP` with no grid features (c_dim 0, no `fc_c`), hidden
    `imap_hidden` (256), `imap_blocks` (4) blocks, no skips, 4 outputs
    (r, g, b, density): `init_imap_decoder`, `imap_eval`.
  * `mlp_dispatch`: `MLP.forward`, or with `fused=True` the fused CUDA
    kernel of ops/fused_mlp.py (Fourier embedding with grid features only;
    other configurations, iMAP's among them, take `MLP.forward`).

Module and parameter names follow the reference's torch decoders
(`pts_linears.i`, `fc_c.i`, `output_linear`, `embedder._B`), so a pretrained
checkpoint loads by a key remap (models/pretrain.py).  Init matches
`xavier_uniform_(gain=calculate_gain(act))` with zero bias.
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

from nice_slam_tpu_torch.models.embeddings import (
    GaussianFourierFeatures, nerf_embed, nerf_embed_dim)
from nice_slam_tpu_torch.ops.fused_mlp import fused_mlp
from nice_slam_tpu_torch.ops.trilinear import sample_grid_feature


class DecoderConfig(NamedTuple):
    """Static decoder hyperparameters (config keys `model.*`)."""

    c_dim: int = 32
    hidden_size: int = 32
    n_blocks: int = 5
    skips: tuple[int, ...] = (2,)
    pos_embedding_method: str = 'fourier'  # 'fourier' | 'nerf' | 'same'
    coarse: bool = True
    # the iMAP* decoder
    imap_hidden: int = 256
    imap_blocks: int = 4

    def embed_dim(self, color: bool) -> int:
        if self.pos_embedding_method == 'fourier':
            return 93
        if self.pos_embedding_method == 'same':
            return 3
        if self.pos_embedding_method == 'nerf':
            return nerf_embed_dim(10 if color else 5)
        raise ValueError(self.pos_embedding_method)


_RELU_GAIN = math.sqrt(2.0)


def _linear(in_dim: int, out_dim: int, gain: float,
            generator: torch.Generator | None, device) -> nn.Linear:
    layer = nn.Linear(in_dim, out_dim, device=device)
    a = gain * math.sqrt(6.0 / (in_dim + out_dim))
    with torch.no_grad():
        layer.weight.uniform_(-a, a, generator=generator)
        layer.bias.zero_()
    return layer


class MLP(nn.Module):
    """Decoder with positional embedding: the grid-feature MLPs of NICE
    (middle/fine/color) and, with c_dim 0 (no `fc_c`), iMAP's.  `hidden`,
    `n_blocks` and `skips` default to the config's NICE sizes."""

    def __init__(self, cfg: DecoderConfig, *, c_dim: int, color: bool,
                 hidden: int | None = None, n_blocks: int | None = None,
                 skips: tuple[int, ...] | None = None,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.cfg = cfg
        self.color = color
        self.skips = tuple(cfg.skips if skips is None else skips)
        hidden = cfg.hidden_size if hidden is None else hidden
        n_blocks = cfg.n_blocks if n_blocks is None else n_blocks
        embed_dim = cfg.embed_dim(color)
        if cfg.pos_embedding_method == 'fourier':
            self.embedder = GaussianFourierFeatures(
                generator=generator, device=device)
        layers, in_dim = [], embed_dim
        for i in range(n_blocks):
            layers.append(_linear(in_dim, hidden, _RELU_GAIN, generator,
                                  device))
            in_dim = hidden + embed_dim if i in self.skips else hidden
        self.pts_linears = nn.ModuleList(layers)
        if c_dim > 0:
            self.fc_c = nn.ModuleList(
                [_linear(c_dim, hidden, 1.0, generator, device)
                 for _ in range(n_blocks)])
        self.output_linear = _linear(in_dim, 4 if color else 1, 1.0,
                                     generator, device)

    def embed(self, p: torch.Tensor) -> torch.Tensor:
        method = self.cfg.pos_embedding_method
        if method == 'fourier':
            return self.embedder(p)
        if method == 'same':
            return p
        if method == 'nerf':
            return (nerf_embed(p, 10, log_sampling=True) if self.color
                    else nerf_embed(p, 5, log_sampling=False))
        raise ValueError(method)

    def forward(self, p: torch.Tensor, c_feat: torch.Tensor | None
                ) -> torch.Tensor:
        """p [N, 3] world points, c_feat [N, c_dim] (None for c_dim 0) ->
        [N, 4] if color else [N]."""
        embedded = self.embed(p)
        fc_all = None
        if c_feat is not None:
            # c_feat is the same for every block, so the per-block
            # injections fc_c[i](c) are one wide matmul, sliced per block
            w_all = torch.cat([l.weight for l in self.fc_c], dim=0)
            b_all = torch.cat([l.bias for l in self.fc_c])
            fc_all = F.linear(c_feat, w_all, b_all)
            hidden = self.fc_c[0].out_features
        h = embedded
        for i, layer in enumerate(self.pts_linears):
            h = F.relu(layer(h))
            if fc_all is not None:
                h = h + fc_all[:, i * hidden:(i + 1) * hidden]
            if i in self.skips:
                h = torch.cat([embedded, h], dim=-1)
        out = self.output_linear(h)
        return out if self.color else out[..., 0]


class MLP_no_xyz(nn.Module):
    """Coarse decoder: the grid feature alone is the input."""

    def __init__(self, cfg: DecoderConfig, *,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.skips = tuple(cfg.skips)
        hidden = cfg.hidden_size
        layers, in_dim = [], hidden  # the first layer takes c (c_dim == hidden)
        for i in range(cfg.n_blocks):
            layers.append(_linear(in_dim, hidden, _RELU_GAIN, generator,
                                  device))
            in_dim = hidden + cfg.c_dim if i in self.skips else hidden
        self.pts_linears = nn.ModuleList(layers)
        self.output_linear = _linear(in_dim, 1, 1.0, generator, device)

    def forward(self, c_feat: torch.Tensor) -> torch.Tensor:
        h = c_feat
        for i, layer in enumerate(self.pts_linears):
            h = F.relu(layer(h))
            if i in self.skips:
                h = torch.cat([c_feat, h], dim=-1)
        return self.output_linear(h)[..., 0]


def init_nice_decoders(cfg: DecoderConfig, *, generator: torch.Generator,
                       device) -> nn.ModuleDict:
    """The NICE decoder set: middle, fine (c_dim 2x: own + middle feature),
    color, and coarse when enabled."""
    decs = {
        'middle': MLP(cfg, c_dim=cfg.c_dim, color=False,
                      generator=generator, device=device),
        'fine': MLP(cfg, c_dim=cfg.c_dim * 2, color=False,
                    generator=generator, device=device),
        'color': MLP(cfg, c_dim=cfg.c_dim, color=True,
                     generator=generator, device=device),
    }
    if cfg.coarse:
        decs['coarse'] = MLP_no_xyz(cfg, generator=generator, device=device)
    return nn.ModuleDict(decs)


def init_imap_decoder(cfg: DecoderConfig, *, generator: torch.Generator,
                      device) -> MLP:
    """The iMAP* decoder: one MLP over the positional embedding, no grid
    features, hidden `imap_hidden`, `imap_blocks` blocks, no skips, 4
    outputs."""
    return MLP(cfg, c_dim=0, color=True, hidden=cfg.imap_hidden,
               n_blocks=cfg.imap_blocks, skips=(), generator=generator,
               device=device)


def imap_eval(decoder: MLP, p: torch.Tensor) -> torch.Tensor:
    """The iMAP* decoder at world points [N, 3] -> [N, 4] (r, g, b,
    density); always the plain path (the fused kernel needs grid
    features)."""
    return mlp_dispatch(decoder, p, None)


def mlp_dispatch(mlp: MLP, p: torch.Tensor, c_feat: torch.Tensor | None,
                 *, fused: bool = False) -> torch.Tensor:
    """`mlp(p, c_feat)`, or the fused kernel when asked for and applicable
    (the Fourier-embedding MLP with grid features; the kernel takes
    contiguous inputs, so the feature slices are made contiguous).  With no
    grid features (iMAP*) it is always `mlp(p, None)`."""
    if (fused and mlp.cfg.pos_embedding_method == 'fourier'
            and c_feat is not None):
        return fused_mlp(mlp, p.contiguous(), c_feat.contiguous())
    return mlp(p, c_feat)


def nice_eval(decoders: Mapping[str, nn.Module], grids: Mapping, p:
              torch.Tensor, stage: str, cfg: DecoderConfig,
              bound: torch.Tensor, coarse_bound: torch.Tensor | None = None,
              grid_shapes: tuple = (), fused: bool = False) -> torch.Tensor:
    """Evaluate the NICE model at world points [N, 3] for `stage`.

    `grids` maps volume names to flat [M, C] tensors (shapes from
    `grid_shapes`, ((name, (nx, ny, nz)), ...)) or `ExpandedGrid`s; a
    'finecolor' entry is the channel-fused fine+color buffer of
    `models.grids.prepare_grids`, split after one gathered row.  `fused`
    routes the middle, fine and color MLPs through `mlp_dispatch`'s kernel.
    Returns raw [N, 4] (r, g, b, occ logit); rgb is zero except in 'color'.
    """
    shapes = dict(grid_shapes)
    finecolor = []   # the one gathered fine+color row, once sampled

    def feat_of(name, bnd):
        if name in ('fine', 'color') and 'finecolor' in grids:
            if not finecolor:
                finecolor.append(sample_grid_feature(
                    grids['finecolor'], p, bnd, shapes.get('fine')))
            both = finecolor[0]
            return (both[..., :cfg.c_dim] if name == 'fine'
                    else both[..., cfg.c_dim:])
        return sample_grid_feature(grids[name], p, bnd, shapes.get(name))

    zeros3 = p.new_zeros(p.shape[:-1] + (3,))
    if stage == 'coarse':
        occ = decoders['coarse'](feat_of('coarse', coarse_bound))
        return torch.cat([zeros3, occ[..., None]], dim=-1)

    c_mid = feat_of('middle', bound)
    middle_occ = mlp_dispatch(decoders['middle'], p, c_mid, fused=fused)
    if stage == 'middle':
        return torch.cat([zeros3, middle_occ[..., None]], dim=-1)

    c_fine = feat_of('fine', bound)
    fine_occ = mlp_dispatch(decoders['fine'], p,
                            torch.cat([c_fine, c_mid.detach()], -1),
                            fused=fused)
    occ = fine_occ + middle_occ
    if stage == 'fine':
        return torch.cat([zeros3, occ[..., None]], dim=-1)

    if stage != 'color':
        raise ValueError(f'unknown stage {stage!r}')
    rgb_raw = mlp_dispatch(decoders['color'], p, feat_of('color', bound),
                           fused=fused)
    return torch.cat([rgb_raw[..., :3], occ[..., None]], dim=-1)
