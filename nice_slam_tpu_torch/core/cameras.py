"""Camera and pose math (L0); port of `nice_slam_tpu/core/cameras.py`.

Differentiable, batched float32 camera primitives: the 7-vector
[quat(wxyz), t] pose parameterization the tracker and BA optimize, its
inverse (Shepperd's method), and OpenGL-style rays
(dirs = [(i-cx)/fx, -(j-cy)/fy, -1]).  The rays' product R.dirs is taken
at the session's matmul precision (models/precision.py), as the JAX
package's einsum takes `jax_default_matmul_precision`, in the forward and
in the pose gradient it carries.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nice_slam_tpu_torch.models import precision as prec


class Intrinsics(NamedTuple):
    """Pinhole intrinsics after any crop/resize preprocessing."""

    H: int
    W: int
    fx: float
    fy: float
    cx: float
    cy: float

    def scaled_to(self, new_h: int, new_w: int) -> "Intrinsics":
        """Rescale for a resized image (`crop_size`)."""
        sx = new_w / self.W
        sy = new_h / self.H
        return Intrinsics(new_h, new_w, self.fx * sx, self.fy * sy,
                          self.cx * sx, self.cy * sy)

    def cropped_by(self, edge: int) -> "Intrinsics":
        """Shrink for an edge crop (`crop_edge`)."""
        if edge <= 0:
            return self
        return Intrinsics(self.H - 2 * edge, self.W - 2 * edge,
                          self.fx, self.fy, self.cx - edge, self.cy - edge)


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) [..., 4] -> rotation [..., 3, 3].

    Accepts non-unit quaternions (normalizes via 2/|q|^2) so an optimizer
    can move a raw 4-vector freely.
    """
    w, x, y, z = quat.unbind(-1)
    two_s = 2.0 / torch.sum(quat * quat, dim=-1)
    r00 = 1 - two_s * (y * y + z * z)
    r01 = two_s * (x * y - z * w)
    r02 = two_s * (x * z + y * w)
    r10 = two_s * (x * y + z * w)
    r11 = 1 - two_s * (x * x + z * z)
    r12 = two_s * (y * z - x * w)
    r20 = two_s * (x * z - y * w)
    r21 = two_s * (y * z + x * w)
    r22 = 1 - two_s * (x * x + y * y)
    return torch.stack([
        torch.stack([r00, r01, r02], dim=-1),
        torch.stack([r10, r11, r12], dim=-1),
        torch.stack([r20, r21, r22], dim=-1),
    ], dim=-2)


def rotmat_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """Rotation [..., 3, 3] -> unit quaternion (w, x, y, z) with w >= 0.

    Shepperd's branch-free form: build the four candidate quaternions and
    keep the one whose dominant term is largest.
    """
    m00, m01, m02 = rot[..., 0, 0], rot[..., 0, 1], rot[..., 0, 2]
    m10, m11, m12 = rot[..., 1, 0], rot[..., 1, 1], rot[..., 1, 2]
    m20, m21, m22 = rot[..., 2, 0], rot[..., 2, 1], rot[..., 2, 2]
    tr = m00 + m11 + m22

    cand_w = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    cand_x = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10,
                          m02 + m20], dim=-1)
    cand_y = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22,
                          m12 + m21], dim=-1)
    cand_z = torch.stack([m10 - m01, m02 + m20, m12 + m21,
                          1.0 - m00 - m11 + m22], dim=-1)
    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)

    dom = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                       1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    best = torch.argmax(dom, dim=-1)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def c2w_from_tensor(cam7: torch.Tensor) -> torch.Tensor:
    """[..., 7] [quat(wxyz), t] -> [..., 3, 4] camera-to-world."""
    rot = quat_to_rotmat(cam7[..., :4])
    return torch.cat([rot, cam7[..., 4:, None]], dim=-1)


def c2w_from_tensor_4x4(cam7: torch.Tensor) -> torch.Tensor:
    """Like `c2w_from_tensor` but homogeneous [..., 4, 4]."""
    rt = c2w_from_tensor(cam7)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rt.dtype,
                          device=rt.device).expand(*rt.shape[:-2], 1, 4)
    return torch.cat([rt, bottom], dim=-2)


def tensor_from_c2w(c2w: torch.Tensor) -> torch.Tensor:
    """[..., 3or4, 4] camera-to-world -> [..., 7] [quat(wxyz), t]."""
    quat = rotmat_to_quat(c2w[..., :3, :3])
    return torch.cat([quat, c2w[..., :3, 3]], dim=-1)


def rays_from_uv(i: torch.Tensor, j: torch.Tensor, c2w: torch.Tensor,
                 intr: Intrinsics, precision: str | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pixel columns `i` and rows `j` [N] -> world rays (origins, unnormalized
    directions), each [N, 3].  `c2w` is [3or4, 4] (or batched [..., 3or4,
    4] with i, j [..., N]); the directions' product at the session's
    `precision`."""
    dirs = torch.stack([(i - intr.cx) / intr.fx, -(j - intr.cy) / intr.fy,
                        -torch.ones_like(i)], dim=-1)
    if prec.passes(precision, prec.SESSION_KEY) == 0:
        rays_d = torch.einsum('...ij,...nj->...ni', c2w[..., :3, :3], dirs)
    else:
        rays_d = prec.matmul(dirs, c2w[..., :3, :3].transpose(-1, -2),
                             precision)
    rays_o = c2w[..., :3, 3][..., None, :].expand(rays_d.shape)
    return rays_o, rays_d


def rays_full_image(c2w: torch.Tensor, intr: Intrinsics,
                    precision: str | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rays for every pixel, row-major (j outer, i inner): [H*W, 3] each;
    the directions' product at `precision`."""
    j, i = torch.meshgrid(
        torch.arange(intr.H, dtype=torch.float32, device=c2w.device),
        torch.arange(intr.W, dtype=torch.float32, device=c2w.device),
        indexing='ij')
    return rays_from_uv(i.reshape(-1), j.reshape(-1), c2w, intr, precision)
