"""Single-controller SLAM orchestrator (L4); port of the strict schedule of
`nice_slam_tpu/engine/slam.py`:

    map(0, iters_first) [+ coarse map]; then for every frame idx >= 1:
        track(idx); if idx % every_frame == 0 or idx is the last frame:
            [coarse map(idx)]; map(idx)   (the last one a color refine)

Tracking renders against a corner-expanded snapshot of the volumes that is
rebuilt after each mapping commit.  The mapper writes the volumes, the
trainable decoders and (with BA) the keyframe poses; the coarse mapper
owns the coarse volume and its own keyframe list.

Services after each mapped frame, as in the JAX package: a checkpoint
every `ckpt_freq` frames and at the last frame (`<output>/ckpts/`), a mesh
every `mesh_freq` frames (on a background thread when `meshing.async`), the
final mesh and, with `meshing.eval_rec`, the evaluation mesh
(`<output>/mesh/`); one line per frame in `<output>/metrics.jsonl`.
Visualization and the overlapped sync modes are not ported yet.
"""

from __future__ import annotations

import concurrent.futures
import copy
import json
import os
import time
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from nice_slam_tpu_torch.core.cameras import (
    c2w_from_tensor_4x4, tensor_from_c2w)
from nice_slam_tpu_torch.engine.frustum import frustum_mask
from nice_slam_tpu_torch.engine.keyframes import Keyframe, KeyframeStore
from nice_slam_tpu_torch.engine.mapper import (
    MapperConfig, lr_table, map_step, stage_schedule)
from nice_slam_tpu_torch.engine.tracker import const_speed_init, track_frame
from nice_slam_tpu_torch.io.datasets import get_dataset
from nice_slam_tpu_torch.mesh.mesher import Mesher
from nice_slam_tpu_torch.models.decoders import init_nice_decoders
from nice_slam_tpu_torch.models.grids import (
    grid_world_coords, init_grids, prepare_grids, static_grid_shapes)
from nice_slam_tpu_torch.render.renderer import SceneModel
from nice_slam_tpu_torch.utils import config as cfgutil
from nice_slam_tpu_torch.utils.ckpt import save_checkpoint


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is asked for (or defaulted to) and absent."""
    device = torch.device('cuda' if device is None else device)
    if device.type not in ('cuda', 'cpu'):
        raise ValueError(f'unsupported device {device}')
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           'run on the CPU')
    return device


@dataclass
class PhaseTimers:
    """Per-call wall-clock records (device work included: each call ends
    with a host read or a synchronize).  `track` holds (frame, seconds);
    `maps` holds (frame, kind, iterations, seconds) with kind one of
    'first', 'coarse', 'normal', 'refine'; `meshes` holds (file name,
    seconds, the mesher's seconds per piece) per extraction and `mesh_s`
    their sum."""
    track: list = field(default_factory=list)
    maps: list = field(default_factory=list)
    meshes: list = field(default_factory=list)
    mesh_s: float = 0.0

    def summary(self) -> dict:
        map_s = sum(s for _, kind, _, s in self.maps if kind != 'coarse')
        map_iters = sum(n for _, kind, n, _ in self.maps if kind != 'coarse')
        track_s = sum(s for _, s in self.track)
        out = {'track_s': track_s, 'map_s': map_s,
               'coarse_map_s': sum(s for _, kind, _, s in self.maps
                                   if kind == 'coarse'),
               'mesh_s': self.mesh_s,
               'frames_tracked': len(self.track),
               'frames_mapped': sum(kind != 'coarse'
                                    for _, kind, _, _ in self.maps),
               'map_iters': map_iters}
        if track_s > 0:
            out['tracked_fps'] = len(self.track) / track_s
        if map_s > 0:
            out['map_iters_per_s'] = map_iters / map_s
        return out


class SlamSystem:
    """Owns all SLAM state and drives the strict schedule (NICE mode)."""

    def __init__(self, cfg: dict, *, device=None, seed: int = 0,
                 verbose: bool | None = None, output: str | None = None):
        self.device = resolve_device(device)
        # true f32 matmuls: reduced-precision passes destabilize the pose
        # optimization over long sequences (the JAX package pins the same)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision('highest')

        self.cfg = cfg
        self.verbose = (cfg.get('verbose', False) if verbose is None
                        else verbose)
        self.output = output or cfg['data'].get('output', 'output/run')
        for sub in ('ckpts', 'mesh'):
            os.makedirs(os.path.join(self.output, sub), exist_ok=True)
        self.metrics_path = os.path.join(self.output, 'metrics.jsonl')
        self.intr = cfgutil.intrinsics_from_cfg(cfg)
        self.rcfg = cfgutil.render_config_from_cfg(cfg)
        self.dcfg = cfgutil.decoder_config_from_cfg(cfg)
        self.gcfg = cfgutil.grid_config_from_cfg(cfg)
        self.tcfg = cfgutil.tracker_config_from_cfg(cfg)
        self.mcfg = cfgutil.mapper_config_from_cfg(cfg)
        self.coarse_enabled = bool(cfg['coarse'])
        if self.coarse_enabled:
            self.coarse_mcfg = cfgutil.mapper_config_from_cfg(
                cfg, coarse_mapper=True)
        self.gt_camera = bool(cfg['tracking'].get('gt_camera', False))
        # service cadences (mapping.*, meshing.*)
        m = cfg['mapping']
        self.ckpt_freq = int(m.get('ckpt_freq', 500))
        # ckpt.compress_images: false -> bit-faithful resume (utils/ckpt.py)
        self.ckpt_compress = bool(
            cfg.get('ckpt', {}).get('compress_images', True))
        self.mesh_freq = int(m.get('mesh_freq', 50))
        self.no_mesh_first = bool(m.get('no_mesh_on_first_frame', True))
        self.no_log_first = bool(m.get('no_log_on_first_frame', True))
        self.eval_rec = bool(cfg.get('meshing', {}).get('eval_rec', False))
        self.mesh_async = bool(cfg.get('meshing', {}).get('async', True))
        self.check_invariants = bool(
            cfg.get('debug', {}).get('check_invariants', False))
        self._mesh_pool = None
        self._mesh_future = None

        dev = self.device
        self.model = SceneModel(
            decoder=self.dcfg,
            bound=torch.tensor(self.gcfg.bound_np, device=dev),
            coarse_bound=torch.tensor(self.gcfg.coarse_bound_np, device=dev),
            grid_shapes=static_grid_shapes(self.gcfg))
        # the initial grids and decoders are drawn on the CPU, so a seed
        # gives the same initial model on every device; pixel draws come
        # from a generator on the run's device
        init_gen = torch.Generator().manual_seed(seed)
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self.np_rng = np.random.default_rng(seed)

        self.grids = {
            name: g.to(dev).requires_grad_(True)
            for name, g in init_grids(self.gcfg, generator=init_gen,
                                      device='cpu').items()}
        self.decoders = init_nice_decoders(
            self.dcfg, generator=init_gen, device='cpu').to(dev)
        pre = cfg.get('pretrained_decoders') or {}
        # as in the JAX package, a config whose checkpoint files are absent
        # trains from the random init
        if pre.get('middle_fine') and os.path.exists(pre['middle_fine']):
            from nice_slam_tpu_torch.models.pretrain import \
                load_torch_pretrain
            load_torch_pretrain(self.decoders, pre, coarse=self.dcfg.coarse)
            if self.verbose:
                print('INFO: loaded pretrained decoders')
        self.trainable = set()
        if not self.mcfg.fix_fine:
            self.trainable.add('fine')
        if not self.mcfg.fix_color:
            self.trainable.add('color')
        if self.mcfg.train_middle:
            if pre.get('middle_fine'):
                warnings.warn(
                    'mapping.train_middle=True with pretrained decoders '
                    'loaded: the pretrained middle MLP will be perturbed '
                    'during mapping (the reference never trains it)',
                    UserWarning, stacklevel=2)
            self.trainable.add('middle')

        self.frame_reader = get_dataset(cfg)
        self.n_img = len(self.frame_reader)
        self.estimate_c2w = np.zeros((self.n_img, 4, 4), dtype=np.float32)
        self.gt_c2w = np.zeros((self.n_img, 4, 4), dtype=np.float32)
        self.keyframes = KeyframeStore()
        self.coarse_keyframes = KeyframeStore()
        self._frames: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self._grid_points = {
            name: torch.tensor(
                grid_world_coords(self.gcfg, name).reshape(-1, 3),
                device=dev)
            for name in self.grids}
        # color-stage expansion of the volumes for tracking, kept until the
        # next mapping commit
        self._tracking_grids = None
        self.timers = PhaseTimers()
        self.mapping_idx = -1
        self.mesher = Mesher(cfgutil.mesher_config_from_cfg(cfg), self.model,
                             self.intr, rcfg=self.rcfg)

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _device_frame(self, idx: int, color_np, depth_np):
        if idx not in self._frames:
            self._frames[idx] = (
                torch.as_tensor(color_np, dtype=torch.float32,
                                device=self.device),
                torch.as_tensor(depth_np, dtype=torch.float32,
                                device=self.device))
        return self._frames[idx]

    def _cam7(self, c2w_np: np.ndarray) -> torch.Tensor:
        return tensor_from_c2w(torch.as_tensor(
            np.asarray(c2w_np[:3, :4], dtype=np.float32),
            device=self.device))

    def _sync(self) -> None:
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def _tracking_snapshot(self):
        if self._tracking_grids is None:
            with torch.no_grad():
                self._tracking_grids = prepare_grids(
                    self.grids, self.model.grid_shapes, stage='color')
        return self._tracking_grids

    # ------------------------------------------------------------------
    # tracking
    # ------------------------------------------------------------------

    def track(self, idx: int, color_np, depth_np, gt_c2w_np) -> np.ndarray:
        """Track one frame; returns the estimated 4x4 c2w."""
        t0 = time.perf_counter()
        color, depth = self._device_frame(idx, color_np, depth_np)
        if idx == 0 or self.gt_camera:
            c2w = np.asarray(gt_c2w_np, dtype=np.float32)
        else:
            pre = self.estimate_c2w[idx - 1]
            guess = (const_speed_init(pre, self.estimate_c2w[idx - 2])
                     if self.tcfg.const_speed and idx >= 2 else pre)
            best_cam7, _, losses = track_frame(
                self.decoders, self._tracking_snapshot(), color, depth,
                self._cam7(guess), model=self.model, rcfg=self.rcfg,
                tcfg=self.tcfg, intr=self.intr, generator=self.generator)
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3, :4] = c2w_from_tensor_4x4(
                best_cam7).detach().cpu().numpy()[:3, :4]
            if self.verbose:
                print(f'Tracking frame {idx}: loss {float(losses[0]):.2f} '
                      f'-> {float(losses[-1]):.2f}')
        self.estimate_c2w[idx] = c2w
        self.gt_c2w[idx] = gt_c2w_np
        self._sync()
        self.timers.track.append((idx, time.perf_counter() - t0))
        return c2w

    # ------------------------------------------------------------------
    # mapping
    # ------------------------------------------------------------------

    def _select_window(self, store: KeyframeStore, mcfg: MapperConfig,
                       window_size: int, depth_np, cur_c2w):
        """Window = selected keyframes + the newest keyframe (the current
        frame is added by the caller).  Returns (positions, oldest)."""
        if len(store) == 0:
            return [], None
        k = window_size - 2
        if mcfg.keyframe_selection == 'global':
            sel = store.select_global(self.np_rng, k)
        else:
            sel = store.select_overlap(self.np_rng, k, depth_np, cur_c2w,
                                       self.intr)
        sel = sel + [len(store) - 1]
        return sel, min(sel)

    def _frustum_masks(self, cur_c2w: np.ndarray, depth: torch.Tensor):
        c2w = torch.as_tensor(cur_c2w, dtype=torch.float32,
                              device=self.device)
        masks = {}
        for name, g in self.grids.items():
            if name == 'coarse':
                masks[name] = torch.ones((g.shape[0], 1), device=self.device)
            else:
                masks[name] = frustum_mask(self._grid_points[name], c2w,
                                           depth, self.intr)[:, None]
        return masks

    def map_frame(self, idx: int, color_np, depth_np, gt_c2w_np, *,
                  coarse: bool = False, first: bool = False) -> None:
        """One mapping invocation (first-frame, coarse, normal, or the
        last frame's color refine)."""
        t0 = time.perf_counter()
        mcfg = self.coarse_mcfg if coarse else self.mcfg
        store = self.coarse_keyframes if coarse else self.keyframes
        color, depth = self._device_frame(idx, color_np, depth_np)
        cur_c2w = self.estimate_c2w[idx].copy()

        refine = (idx == self.n_img - 1 and mcfg.color_refine
                  and not coarse and not first)
        window_size = mcfg.window_size
        fix_color = mcfg.fix_color
        frustum_on = mcfg.frustum_selection
        middle_ratio, fine_ratio = mcfg.middle_iter_ratio, mcfg.fine_iter_ratio
        lr_factor = mcfg.lr_factor
        outer_iters, n_iters = 1, mcfg.iters
        if refine:
            outer_iters = 5
            window_size = mcfg.window_size * 2
            middle_ratio = fine_ratio = 0.0
            n_iters = mcfg.iters * 5 // outer_iters
            fix_color = True
            frustum_on = False
        elif first:
            n_iters = mcfg.iters_first
            lr_factor = mcfg.lr_first_factor
        mcfg_eff = mcfg._replace(middle_iter_ratio=middle_ratio,
                                 fine_iter_ratio=fine_ratio,
                                 fix_color=fix_color)
        trainable = sorted(self.trainable - ({'color'} if fix_color
                                             else set()))

        for outer in range(outer_iters):
            ba = len(store) > 4 and mcfg.ba and not coarse
            sel, oldest = self._select_window(store, mcfg_eff, window_size,
                                              depth_np, cur_c2w)
            colors, depths, cam7s, cam_mask = [], [], [], []
            for pos in sel:
                kf = store.frames[pos]
                c, d = self._device_frame(kf.idx, kf.color, kf.depth)
                colors.append(c)
                depths.append(d)
                cam7s.append(self._cam7(kf.est_c2w))
                cam_mask.append(0.0 if pos == oldest else 1.0)
            colors.append(color)
            depths.append(depth)
            cam7s.append(self._cam7(cur_c2w))
            cam_mask.append(1.0)
            real_n = len(colors)
            # pad the window to its full size by cycling the real frames,
            # newest first; the padding slots' poses are frozen
            n_frames = max(window_size, real_n)
            for k in range(n_frames - real_n):
                src = real_n - 1 - (k % real_n)
                colors.append(colors[src])
                depths.append(depths[src])
                cam7s.append(cam7s[src])
                cam_mask.append(0.0)

            cams, losses = map_step(
                self.decoders, self.grids, torch.stack(cam7s),
                trainable=trainable,
                masks=(self._frustum_masks(cur_c2w, depth)
                       if frustum_on else None),
                cam_mask=(torch.tensor(cam_mask, device=self.device)
                          if ba else None),
                lr_tab=lr_table(mcfg_eff, n_iters, lr_factor, ba),
                stage_idx=stage_schedule(mcfg_eff, n_iters),
                colors=torch.stack(colors), depths=torch.stack(depths),
                model=self.model, rcfg=self.rcfg, mcfg=mcfg_eff,
                intr=self.intr,
                pix_per_frame=max(mcfg.pixels // n_frames, 1),
                generator=self.generator)
            if not coarse:
                self._tracking_grids = None   # the snapshot is stale
            if ba:
                new_cams = c2w_from_tensor_4x4(cams).cpu().numpy()
                for slot, pos in enumerate(sel):
                    if pos != oldest:
                        store.frames[pos].est_c2w = new_cams[slot]
                cur_c2w = new_cams[real_n - 1]
                self.estimate_c2w[idx] = cur_c2w
            if self.verbose:
                tag = 'Coarse mapping' if coarse else 'Mapping'
                print(f'{tag} frame {idx}: loss {float(losses[0]):.2f} -> '
                      f'{float(losses[-1]):.2f} ({n_iters} iters, '
                      f'window {n_frames})')
            if outer == outer_iters - 1 and (
                    idx % mcfg.keyframe_every == 0
                    or idx == self.n_img - 2) and idx not in store.indices:
                store.append(Keyframe(
                    idx=idx, color=color_np, depth=depth_np,
                    est_c2w=cur_c2w.copy(), gt_c2w=np.asarray(gt_c2w_np)))

        self._sync()
        if not coarse:
            self.mapping_idx = idx
        kind = ('coarse' if coarse else 'first' if first
                else 'refine' if refine else 'normal')
        self.timers.maps.append((idx, kind, n_iters * outer_iters,
                                 time.perf_counter() - t0))

    # ------------------------------------------------------------------
    # services: checkpoint / mesh
    # ------------------------------------------------------------------

    def checkpoint_state(self) -> dict:
        """Everything a resumed run needs (utils/ckpt.py): the map, the
        poses, both keyframe stores, the schedule position and both
        random streams."""
        return {
            'grids': {k: g.detach() for k, g in self.grids.items()},
            'decoders': {name: dec.state_dict()
                         for name, dec in self.decoders.items()},
            'estimate_c2w': self.estimate_c2w,
            'gt_c2w': self.gt_c2w,
            'keyframes': [vars(kf) for kf in self.keyframes.frames],
            # the coarse store shares the images; its poses are its own
            'coarse_keyframes': [{'idx': kf.idx, 'est_c2w': kf.est_c2w}
                                 for kf in self.coarse_keyframes.frames],
            'mapping_idx': self.mapping_idx,
            'generator_state': self.generator.get_state(),
            'np_rng_state': self.np_rng.bit_generator.state,
        }

    def save_ckpt(self, idx: int) -> str:
        path = os.path.join(self.output, 'ckpts', f'{idx:05d}.ckpt')
        save_checkpoint(path, self.checkpoint_state(),
                        compress_images=self.ckpt_compress)
        if self.verbose:
            print(f'INFO: checkpoint saved to {path}')
        return path

    def restore(self, state: dict) -> int:
        """Resume from `checkpoint_state()` output (as loaded by
        utils/ckpt.load_checkpoint); returns the next frame to process."""
        with torch.no_grad():
            for name, g in self.grids.items():
                g.copy_(torch.as_tensor(state['grids'][name]).reshape(
                    g.shape))
        for name, sd in state['decoders'].items():
            self.decoders[name].load_state_dict(
                {k: torch.as_tensor(v) for k, v in sd.items()})
        self._tracking_grids = None
        self._frames.clear()
        self.estimate_c2w = np.asarray(state['estimate_c2w'])
        self.gt_c2w = np.asarray(state['gt_c2w'])
        self.keyframes = KeyframeStore(
            [Keyframe(idx=int(kf['idx']), color=np.asarray(kf['color']),
                      depth=np.asarray(kf['depth']),
                      est_c2w=np.asarray(kf['est_c2w']),
                      gt_c2w=np.asarray(kf['gt_c2w']))
             for kf in state['keyframes']])
        by_idx = {kf.idx: kf for kf in self.keyframes.frames}
        self.coarse_keyframes = KeyframeStore(
            [Keyframe(idx=int(kf['idx']), color=by_idx[kf['idx']].color,
                      depth=by_idx[kf['idx']].depth,
                      est_c2w=np.asarray(kf['est_c2w']),
                      gt_c2w=by_idx[kf['idx']].gt_c2w)
             for kf in state.get('coarse_keyframes', [])])
        self.mapping_idx = int(state['mapping_idx'])
        self.generator.set_state(torch.as_tensor(state['generator_state']))
        self.np_rng = np.random.default_rng()
        self.np_rng.bit_generator.state = state['np_rng_state']
        return self.mapping_idx + 1

    def mesh_now(self, idx: int, final: bool = False) -> str | None:
        """Extract a mesh.  Periodic meshes run on a background thread
        while the SLAM loop goes on; final meshes block.  One mesh in
        flight at a time.  The mapper updates the grids, the decoders and
        the keyframe poses in place, so an async mesh works on copies made
        here, on the current stream, before it starts."""
        if self.mesher is None:
            return None
        self.join_mesh()
        name = 'final_mesh.ply' if final else f'{idx:05d}_mesh.ply'
        path = os.path.join(self.output, 'mesh', name)
        kfs = KeyframeStore([Keyframe(kf.idx, kf.color, kf.depth,
                                      kf.est_c2w.copy(), kf.gt_c2w)
                             for kf in self.keyframes.frames])
        est = self.estimate_c2w.copy()
        if final or not self.mesh_async:
            self._extract(path, self.decoders, self.grids, kfs, est, idx)
            return path
        with torch.no_grad():
            decoders = copy.deepcopy(self.decoders)
            grids = {k: g.detach().clone() for k, g in self.grids.items()}
        if self._mesh_pool is None:
            self._mesh_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1)
        self._mesh_future = self._mesh_pool.submit(
            self._extract, path, decoders, grids, kfs, est, idx)
        return path

    def _extract(self, path: str, decoders, grids, keyframes, est, idx: int,
                 **kwargs) -> None:
        t0 = time.perf_counter()
        self.mesher.extract(path, decoders, grids, keyframes, est, idx,
                            **kwargs)
        seconds = time.perf_counter() - t0
        self.timers.meshes.append((os.path.basename(path), seconds,
                                   dict(self.mesher.timings)))
        self.timers.mesh_s += seconds

    def join_mesh(self) -> None:
        """Wait for the background mesh, if any (its error is raised
        here)."""
        if self._mesh_future is not None:
            future, self._mesh_future = self._mesh_future, None
            future.result()

    def _log_metrics(self, idx: int) -> None:
        gt_err = float(np.linalg.norm(
            self.estimate_c2w[idx][:3, 3] - self.gt_c2w[idx][:3, 3]))
        rec = {'frame': idx, 'pose_err_vs_gt': round(gt_err, 5),
               'mapped': self.mapping_idx == idx,
               'n_keyframes': len(self.keyframes),
               **self.timers.summary()}
        with open(self.metrics_path, 'a') as f:
            f.write(json.dumps(rec) + '\n')

    def _assert_invariants(self, idx: int) -> None:
        """Finite map state and a valid pose."""
        for name, g in self.grids.items():
            assert bool(torch.isfinite(g).all()), f'grid {name} non-finite'
        for name, p in self.decoders.named_parameters():
            assert bool(torch.isfinite(p).all()), f'decoder {name} non-finite'
        c2w = self.estimate_c2w[idx]
        assert np.isfinite(c2w).all(), f'pose {idx} non-finite'
        rot = c2w[:3, :3]
        err = np.abs(rot @ rot.T - np.eye(3)).max()
        assert err < 1e-2, f'pose {idx} rotation not orthonormal ({err})'

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------

    def step(self, idx: int) -> None:
        """Process one frame under the strict schedule, then the services
        of a mapped frame."""
        _, color_np, depth_np, gt_c2w_np = self.frame_reader[idx]
        every = self.mcfg.every_frame
        last = idx == self.n_img - 1
        if idx == 0:
            self.estimate_c2w[0] = gt_c2w_np
            self.gt_c2w[0] = gt_c2w_np
            self.track(0, color_np, depth_np, gt_c2w_np)
            self.map_frame(0, color_np, depth_np, gt_c2w_np, first=True)
            if self.coarse_enabled:
                self.map_frame(0, color_np, depth_np, gt_c2w_np,
                               coarse=True, first=True)
        else:
            self.track(idx, color_np, depth_np, gt_c2w_np)
            if idx % every == 0 or last:
                if self.coarse_enabled:
                    self.map_frame(idx, color_np, depth_np, gt_c2w_np,
                                   coarse=True)
                self.map_frame(idx, color_np, depth_np, gt_c2w_np)

        if idx == 0 or idx % every == 0 or last:
            if ((idx % self.ckpt_freq == 0
                 and not (idx == 0 and self.no_log_first)) or last):
                self.save_ckpt(idx)
            if (idx % self.mesh_freq == 0
                    and not (idx == 0 and self.no_mesh_first)):
                self.mesh_now(idx)
            if last:
                self.mesh_now(idx, final=True)
                if self.eval_rec and self.mesher is not None:
                    self._extract(
                        os.path.join(self.output, 'mesh',
                                     'final_mesh_eval_rec.ply'),
                        self.decoders, self.grids, self.keyframes,
                        self.estimate_c2w, idx, show_forecast=False,
                        clean_mesh=True, get_mask_use_all_frames=True)
        if self.check_invariants:
            self._assert_invariants(idx)
        self._log_metrics(idx)
        # keep device copies of keyframes only
        if idx not in self.keyframes.indices \
                and idx not in self.coarse_keyframes.indices:
            self._frames.pop(idx, None)

    def run(self, start: int = 0) -> None:
        """Frames `start` .. the last; the background mesh is joined and
        its thread stopped however the loop ends."""
        try:
            for idx in range(start, self.n_img):
                self.step(idx)
        finally:
            try:
                self.join_mesh()
            finally:
                if self._mesh_pool is not None:
                    self._mesh_pool.shutdown()
                    self._mesh_pool = None
        if self.verbose:
            print('INFO: run complete:', self.timers.summary())
