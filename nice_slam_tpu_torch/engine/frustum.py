"""Frustum feature selection: which grid nodes does the current camera see?
Port of `nice_slam_tpu/engine/frustum.py`.

Project every grid node into the current depth image, bilinearly sample the
depth there (zero outside, cv2.remap INTER_LINEAR semantics; zero samples
replaced by the largest sample), and keep the nodes in front of the camera
inside the image and no more than 0.5 m behind the sensed surface, plus
every node within 0.5 m of the camera centre.  The projection's product
takes the session's matmul precision (models/precision.py); the inverse
pose stays float32.
"""

from __future__ import annotations

import torch

from nice_slam_tpu_torch.core.cameras import Intrinsics
from nice_slam_tpu_torch.models.precision import matmul


def bilinear_sample_zero_border(img: torch.Tensor, u: torch.Tensor,
                                v: torch.Tensor) -> torch.Tensor:
    """img [H, W] at float (u=x, v=y), zero outside the image."""
    h, w = img.shape
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = u - u0
    fv = v - v0

    def tap(ui, vi):
        inb = (ui >= 0) & (ui <= w - 1) & (vi >= 0) & (vi <= h - 1)
        uc = torch.clamp(ui, 0, w - 1).long()
        vc = torch.clamp(vi, 0, h - 1).long()
        return torch.where(inb, img[vc, uc], torch.zeros_like(ui))

    top = tap(u0, v0) * (1 - fu) + tap(u0 + 1, v0) * fu
    bot = tap(u0, v0 + 1) * (1 - fu) + tap(u0 + 1, v0 + 1) * fu
    return top * (1 - fv) + bot * fv


def frustum_mask(points: torch.Tensor, c2w: torch.Tensor,
                 depth: torch.Tensor, intr: Intrinsics,
                 precision: str | None = None) -> torch.Tensor:
    """[M] float32 0/1 mask over grid nodes `points` [M, 3] seen by the
    camera `c2w` [4, 4] with sensor depth [H, W]; the projection at the
    session's `precision`."""
    w2c = torch.linalg.inv(c2w)
    ones = torch.ones_like(points[:, :1])
    cam = matmul(torch.cat([points, ones], dim=1), w2c.T, precision)[:, :3]
    # u = fx * (-x)/z + cx with z < 0 in front (OpenGL-style camera)
    x = -cam[:, 0]
    y = cam[:, 1]
    z = cam[:, 2] + 1e-5
    u = (intr.fx * x + intr.cx * z) / z
    v = (intr.fy * y + intr.cy * z) / z

    sampled = bilinear_sample_zero_border(depth, u, v)
    sampled = torch.where(sampled == 0.0, torch.amax(sampled), sampled)

    in_image = (u > 0) & (u < intr.W) & (v > 0) & (v < intr.H)
    cam_depth = -z
    seen = in_image & (cam_depth >= 0) & (cam_depth <= sampled + 0.5)
    near_cam = torch.sum((points - c2w[:3, 3]) ** 2, dim=1) < 0.25
    return (seen | near_cam).float()
