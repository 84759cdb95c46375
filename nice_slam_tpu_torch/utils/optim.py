"""Adam with per-tensor learning rates that change every iteration and 0/1
gradient masks; port of `nice_slam_tpu/utils/optim.py`.

The reference drives torch.optim.Adam with placeholder groups whose lr it
rewrites every iteration from the mapping stage schedule; moments keep
accumulating while a group's lr is 0.  A mask multiplies the gradient, so a
masked entry gets zero moments and zero update, as if it were not in the
optimizer.  A tensor with no gradient in an iteration (a volume the stage
does not sample) counts as a zero gradient, as in the JAX package.
Defaults are torch's: betas (0.9, 0.999), eps 1e-8, bias correction on.
Parameters are updated in place.
"""

from __future__ import annotations

from typing import Sequence

import torch


class MaskedAdam:
    """Adam state over a fixed list of tensors."""

    def __init__(self, params: Sequence[torch.Tensor], *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor | None],
             lrs: Sequence[float],
             masks: Sequence[torch.Tensor | None] | None = None) -> None:
        """One step; grads/lrs/masks align with `params` (a None grad is
        zero, a None mask is all ones)."""
        b1, b2 = self.b1, self.b2
        self.count += 1
        c1 = 1.0 - b1 ** self.count
        c2 = 1.0 - b2 ** self.count
        masks = masks if masks is not None else [None] * len(self.params)
        for p, m, v, g, lr, mask in zip(self.params, self.mu, self.nu,
                                        grads, lrs, masks):
            m.mul_(b1)
            v.mul_(b2)
            if g is not None:
                if mask is not None:
                    g = g * mask
                m.add_(g, alpha=1.0 - b1)
                v.addcmul_(g, g, value=1.0 - b2)
            if lr != 0.0:
                denom = (v / c2).sqrt_().add_(self.eps)
                p.addcdiv_(m, denom, value=-lr / c1)
