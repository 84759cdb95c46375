"""Render panels; port of `nice_slam_tpu/utils/visualizer.py`.

Every `freq` frames (the caller decides which iterations), the frame is
rendered at a given pose and a 2x3 panel written: input / rendered /
residual depth over input / rendered / residual color, as
`{idx:05d}_{iter:04d}.jpg` under the panel directory.  The numbers
(`panel_tiles`) are the JAX package's: the color clipped to [0, 1], the
residuals absolute differences set to 0 where the sensor depth is 0, the
three depth tiles over [0, max(sensor depth) or 1].  The drawing is
utils/draw.py's (no matplotlib): each tile at the frame's own size.

The render reads the decoders and grids it is given and draws nothing
from any generator, so a run's poses are the same with panels and
without.  NICE renders through the fused decoder kernel, as the mesher
does (ops/fused_mlp.py).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from nice_slam_tpu_torch.core.cameras import Intrinsics
from nice_slam_tpu_torch.render.renderer import (
    RenderConfig, SceneModel, render_image, with_fused_eval)
from nice_slam_tpu_torch.utils import draw

TITLES = ('input depth', 'rendered depth', 'depth residual',
          'input rgb', 'rendered rgb', 'rgb residual')


def panel_tiles(decoders, grids, c2w, gt_depth: np.ndarray,
                gt_color: np.ndarray, *, model: SceneModel,
                rcfg: RenderConfig, intr: Intrinsics):
    """The six tiles of a panel as float arrays, in `TITLES` order
    (depths [H, W], colors [H, W, 3]), and the depth tiles' vmax."""
    dev = model.bound.device
    depth, _, color = render_image(
        decoders, grids,
        torch.as_tensor(np.asarray(c2w), dtype=torch.float32, device=dev),
        intr, stage='color', model=model, rcfg=rcfg,
        gt_depth=torch.as_tensor(gt_depth, dtype=torch.float32, device=dev))
    depth = depth.cpu().numpy()
    color = np.clip(color.cpu().numpy(), 0, 1)
    depth_res = np.abs(gt_depth - depth)
    depth_res[gt_depth == 0.0] = 0.0
    color_res = np.abs(gt_color - color)
    color_res[gt_depth == 0.0] = 0.0
    vmax = float(np.max(gt_depth)) or 1.0
    return [gt_depth, depth, depth_res, gt_color, color,
            np.clip(color_res, 0, 1)], vmax


def draw_panel(tiles, vmax: float) -> np.ndarray:
    """uint8 RGB panel of `panel_tiles`' output: 2x3 tiles under their
    titles."""
    images = [draw.colormap(t, 0, vmax) for t in tiles[:3]] \
        + [draw.rgb_bytes(t) for t in tiles[3:]]
    return draw.compose(images, TITLES, ncols=3)


def panel_size(h: int, w: int) -> tuple[int, int]:
    """(height, width) of the panel of an h x w frame."""
    return draw.grid_size([(h, w)] * 6, 3)


class Visualizer:
    def __init__(self, vis_dir: str, freq: int, *, model: SceneModel,
                 rcfg: RenderConfig, intr: Intrinsics,
                 verbose: bool = False):
        self.vis_dir = vis_dir
        self.freq = max(int(freq), 1)
        self.model = with_fused_eval(model)
        self.rcfg = rcfg
        self.intr = intr
        self.verbose = verbose
        # seconds of the last panel: render (device work and the copy to
        # the host included), drawing, encoding and writing
        self.timings: dict[str, float] = {}
        os.makedirs(vis_dir, exist_ok=True)

    def vis(self, idx: int, iter_i: int, gt_depth: np.ndarray,
            gt_color: np.ndarray, c2w: np.ndarray, decoders,
            grids) -> str | None:
        """Write the panel of frame idx at iteration iter_i rendered from
        `decoders` and `grids` (the stored volumes or an expanded
        snapshot; {} for iMAP*) at pose `c2w`; returns its path, or None
        when idx is not a multiple of the frequency."""
        if idx % self.freq != 0:
            return None
        t0 = time.perf_counter()
        tiles, vmax = panel_tiles(decoders, grids, c2w, gt_depth, gt_color,
                                  model=self.model, rcfg=self.rcfg,
                                  intr=self.intr)
        t1 = time.perf_counter()
        image = draw_panel(tiles, vmax)
        t2 = time.perf_counter()
        out = draw.save(os.path.join(self.vis_dir,
                                     f'{idx:05d}_{iter_i:04d}.jpg'), image)
        self.timings = {'render_s': t1 - t0, 'draw_s': t2 - t1,
                        'encode_s': time.perf_counter() - t2}
        if self.verbose:
            print(f'INFO: saved rendering visualization to {out}')
        return out
