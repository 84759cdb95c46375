"""Positional embeddings for the decoder MLPs; port of
`nice_slam_tpu/models/embeddings.py`.  The Fourier embedding's product
takes the decoder stack's matmul precision (models/precision.py)."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from nice_slam_tpu_torch.models.precision import mm


class GaussianFourierFeatures(nn.Module):
    """sin(p @ B) with a learnable B [3, 93] ~ N(0, 25^2); the parameter is
    named `_B` as in the reference checkpoints (`embedder._B`)."""

    def __init__(self, in_dim: int = 3, mapping_size: int = 93,
                 scale: float = 25.0, *, generator: torch.Generator | None = None,
                 device=None):
        super().__init__()
        self._B = nn.Parameter(torch.randn(
            (in_dim, mapping_size), generator=generator, device=device)
            * scale)

    def forward(self, p: torch.Tensor, precision: str | None = None
                ) -> torch.Tensor:
        return fourier_embed(self._B, p, precision)


def fourier_embed(b_matrix: torch.Tensor, p: torch.Tensor,
                  precision: str | None = None) -> torch.Tensor:
    """sin(p @ B): [N, 3] -> [N, mapping_size], the product at
    `precision`."""
    return torch.sin(mm(p, b_matrix, precision))


def nerf_embed_dim(multires: int) -> int:
    return multires * 6 + 3


def nerf_embed(p: torch.Tensor, multires: int, log_sampling: bool
               ) -> torch.Tensor:
    """NeRF frequency encoding [N, 3] -> [N, multires*6+3], ordered
    [p, sin(p f0), cos(p f0), sin(p f1), ...]."""
    if log_sampling:
        freqs = 2.0 ** np.linspace(0.0, multires - 1, multires)
    else:
        freqs = np.linspace(2.0 ** 0.0, 2.0 ** (multires - 1), multires)
    outs = [p]
    for f in freqs:
        outs.append(torch.sin(p * float(f)))
        outs.append(torch.cos(p * float(f)))
    return torch.cat(outs, dim=-1)
