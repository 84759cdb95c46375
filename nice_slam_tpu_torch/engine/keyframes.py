"""Keyframe store and selection policies (L3); port of
`nice_slam_tpu/engine/keyframes.py` (host-side numpy, as there).

  * 'global': a random permutation of all but the newest keyframe.
  * 'overlap': sample 100 pixels x 16 depths in [0.8 d, d + 0.5] from the
    current frame, project into each candidate keyframe, rank by the
    fraction landing inside its (20 px margined) image in front of the
    camera, then pick k at random among those with nonzero overlap.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from nice_slam_tpu_torch.core.cameras import Intrinsics


@dataclass
class Keyframe:
    idx: int
    color: np.ndarray      # [H, W, 3] float32
    depth: np.ndarray      # [H, W] float32
    est_c2w: np.ndarray    # [4, 4]
    gt_c2w: np.ndarray     # [4, 4]


@dataclass
class KeyframeStore:
    frames: list[Keyframe] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.frames)

    def append(self, kf: Keyframe) -> None:
        self.frames.append(kf)

    @property
    def indices(self) -> list[int]:
        return [kf.idx for kf in self.frames]

    def select_global(self, rng: np.random.Generator, k: int) -> list[int]:
        """Random keyframes among all but the newest."""
        n = len(self.frames) - 1
        if n <= 0:
            return []
        return list(rng.permutation(n)[:min(n, k)])

    def select_overlap(self, rng: np.random.Generator, k: int,
                       gt_depth: np.ndarray, c2w: np.ndarray,
                       intr: Intrinsics, *, n_pixels: int = 100,
                       n_samples: int = 16) -> list[int]:
        """Co-visibility ranked selection among all but the newest."""
        candidates = self.frames[:-1]
        if not candidates:
            return []
        h, w = gt_depth.shape
        flat = rng.integers(0, h * w, size=n_pixels)
        jj = (flat // w).astype(np.float64)
        ii = (flat % w).astype(np.float64)
        d = gt_depth[jj.astype(int), ii.astype(int)].astype(np.float64)

        dirs = np.stack([(ii - intr.cx) / intr.fx, -(jj - intr.cy) / intr.fy,
                         -np.ones_like(ii)], axis=-1)
        rays_d = dirs @ c2w[:3, :3].T
        rays_o = c2w[:3, 3]

        t_vals = np.linspace(0.0, 1.0, n_samples)
        near = (d * 0.8)[:, None]
        far = (d + 0.5)[:, None]
        z = near * (1 - t_vals) + far * t_vals
        pts = (rays_o + rays_d[:, None, :] * z[..., None]).reshape(-1, 3)
        pts_h = np.concatenate([pts, np.ones_like(pts[:, :1])], axis=1)

        percents = []
        for kf in candidates:
            cam = (pts_h @ np.linalg.inv(kf.est_c2w).T)[:, :3]
            zc = cam[:, 2] + 1e-5
            u = (intr.fx * (-cam[:, 0]) + intr.cx * zc) / zc
            v = (intr.fy * cam[:, 1] + intr.cy * zc) / zc
            edge = 20
            inside = ((u < w - edge) & (u > edge)
                      & (v < h - edge) & (v > edge) & (zc < 0))
            percents.append(inside.mean())

        order = np.argsort(-np.asarray(percents), kind='stable')
        nonzero = [int(i) for i in order if percents[i] > 0.0]
        return list(rng.permutation(nonzero)[:k])
