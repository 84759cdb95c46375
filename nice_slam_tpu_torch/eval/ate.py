"""Absolute trajectory error; port of `nice_slam_tpu/eval/ate.py`: Horn's
closed-form alignment of the estimated positions onto the ground truth,
then translational RMSE / mean / median / std / min / max, with poses whose
ground truth is not finite left out; and the timestamp association of two
stamped trajectories (TUM-format files)."""

from __future__ import annotations

import numpy as np


def align_horn(model: np.ndarray, data: np.ndarray):
    """Rigidly align positions `model` [3, N] onto `data` [3, N].
    Returns (rot [3, 3], trans [3, 1], per-pose translation error [N])."""
    model_mean = model.mean(axis=1, keepdims=True)
    data_mean = data.mean(axis=1, keepdims=True)
    w = (model - model_mean) @ (data - data_mean).T
    u, _, vt = np.linalg.svd(w.T)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1
    rot = u @ s @ vt
    trans = data_mean - rot @ model_mean
    err = rot @ model + trans - data
    return rot, trans, np.sqrt(np.sum(err * err, axis=0))


def evaluate_ate(est_c2w: np.ndarray, gt_c2w: np.ndarray,
                 *, scale: float = 1.0) -> dict:
    """ATE statistics over [N, 4, 4] estimated and ground-truth poses;
    translations divided by `scale`."""
    n = min(len(est_c2w), len(gt_c2w))
    est = est_c2w[:n].astype(np.float64)
    gt = gt_c2w[:n].astype(np.float64)
    valid = np.isfinite(gt.reshape(n, -1)).all(axis=1) \
        & (np.abs(gt.reshape(n, -1)) < 1e6).all(axis=1) \
        & np.isfinite(est.reshape(n, -1)).all(axis=1)
    est_t = est[valid][:, :3, 3].T / scale
    gt_t = gt[valid][:, :3, 3].T / scale
    _, _, trans_error = align_horn(est_t, gt_t)
    return {
        'compared_pose_pairs': int(valid.sum()),
        'absolute_translational_error.rmse':
            float(np.sqrt(np.mean(trans_error ** 2))),
        'absolute_translational_error.mean': float(np.mean(trans_error)),
        'absolute_translational_error.median': float(np.median(trans_error)),
        'absolute_translational_error.std': float(np.std(trans_error)),
        'absolute_translational_error.min': float(np.min(trans_error)),
        'absolute_translational_error.max': float(np.max(trans_error)),
    }


def associate(first: dict, second: dict, offset: float = 0.0,
              max_difference: float = 0.02) -> list:
    """Pairs (a, b) of timestamps of two stamped dicts, each used once,
    closest first, |a - (b + offset)| < max_difference; sorted."""
    potential = sorted((abs(a - (b + offset)), a, b)
                       for a in first for b in second
                       if abs(a - (b + offset)) < max_difference)
    matches = []
    used_a, used_b = set(), set()
    for _, a, b in potential:
        if a not in used_a and b not in used_b:
            used_a.add(a)
            used_b.add(b)
            matches.append((a, b))
    matches.sort()
    return matches
