"""Checkpoint save/restore; port of `nice_slam_tpu/utils/ckpt.py`.

A checkpoint is a pickle of numpy arrays and plain Python values: the
grids, every decoder's state dict, the pose lists, the keyframe store
(images in float16 unless `ckpt.compress_images: false`), the coarse
mapper's keyframe indices, `mapping_idx`, the device generator's state and
the numpy generator's bit-generator state (engine/slam.checkpoint_state).
Saving writes a temporary file and renames it over the target, so a
checkpoint on disk is always whole.

Resume contract: with `compress_images: false` a resumed run replays the
uninterrupted run's schedule and random draws exactly, and with PyTorch's
deterministic algorithms on (`torch.use_deterministic_algorithms(True)`)
its later poses, grids and decoders are bit-identical on the CPU.  Without
them the mapper's gather backward (index_put_ with accumulate) adds in a
thread-dependent order on the CPU and with atomics on CUDA, so two runs
already differ in their last bits.  The mapper builds a new Adam state for
every call, so there is no optimizer state to save.
"""

from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch


def to_numpy(tree: Any) -> Any:
    """Tensors anywhere in nested dicts, lists and tuples -> numpy."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree


def save_checkpoint(path: str, state: dict, *, compress_images: bool = True
                    ) -> None:
    """Serialize a SLAM state dict to `path`."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    out = to_numpy(dict(state))
    if compress_images and 'keyframes' in out:
        out['keyframes'] = [
            {**kf, 'color': kf['color'].astype(np.float16),
             'depth': kf['depth'].astype(np.float16)}
            for kf in out['keyframes']]
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> dict:
    with open(path, 'rb') as f:
        state = pickle.load(f)
    for kf in state.get('keyframes', []):
        kf['color'] = kf['color'].astype(np.float32)
        kf['depth'] = kf['depth'].astype(np.float32)
    return state


def latest_checkpoint(ckpt_dir: str) -> str | None:
    """The newest `*.ckpt` in `ckpt_dir` by name (frame-numbered), or
    None."""
    if not os.path.isdir(ckpt_dir):
        return None
    files = sorted(f for f in os.listdir(ckpt_dir) if f.endswith('.ckpt'))
    return os.path.join(ckpt_dir, files[-1]) if files else None
