"""Single-controller SLAM orchestrator (L4); port of
`nice_slam_tpu/engine/slam.py` (NICE and iMAP* modes, one device):

    map(0, iters_first) [+ coarse map]; then for every frame idx >= 1:
        track(idx); if idx % map_cadence == 0 or idx is the last frame:
            [coarse map(idx)]; map(idx)   (the last one a color refine)

iMAP* (`SlamSystem(cfg, nice=False)`) has one decoder and no volumes, no
coarse mapper and no frustum masks; each normal mapping call is 3 outer
iterations of `iters // 3`, each on a window selected anew, the keyframe
appended on the last.

`sync_method: strict` (the default) maps every `every_frame` frames and
runs everything in that order.  `loose` and `free` are the overlapped
modes: they map every `every_frame // 2` frames, and each mapping round
without active BA is queued on a single mapping thread, on a CUDA stream of
its own, while the main thread goes on tracking against its snapshot of
the map.  Submitting a round never waits: it runs behind the rounds
already queued.  A round ends by building the next tracking snapshot (the
color-stage expansion of the volumes and a clone of the decoders: the
mapper updates both in place, where JAX arrays are immutable); at each
frame the tracker adopts the newest finished round's snapshot, and under
`loose` it waits for the oldest rounds while its snapshot is more than
every_frame + every_frame // 2 frames behind the frame it tracks (the
reference's loose gate).  `free` has no gate.  Rounds with BA active
commit on the main thread in every mode, after the queued rounds.  `free`
runs `loose` on one device unless `sync_force_free: true`; the JAX
package's two-device pipeline (mapping on a second device) is not ported.
Everything that reads the map (checkpoints, meshes, the invariant checks,
the end of the run) waits for the queued rounds first, and an error raised
inside a round is raised there or where the tracker adopts the round.

Tracking renders against a corner-expanded snapshot of the volumes that is
rebuilt after each mapping commit.  The mapper writes the volumes, the
trainable decoders and (with BA) the keyframe poses; the coarse mapper
owns the coarse volume and its own keyframe list.  Frames come through a
Prefetcher (io/prefetch.py) during `run()`.

Services after each mapped frame, as in the JAX package: a checkpoint
every `ckpt_freq` frames and at the last frame (`<output>/ckpts/`), a mesh
every `mesh_freq` frames (on a background thread when `meshing.async`), the
final mesh and, with `meshing.eval_rec`, the evaluation mesh
(`<output>/mesh/`); one line per frame in `<output>/metrics.jsonl`; with
`mapping.save_selected_keyframes_info`, the window of every mapping call
(`selected_keyframes`, checkpointed).  Visualization is not ported yet:
`utils/config.check_options` warns about its keys, and refuses the
options of modules that are not ported.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import copy
import json
import os
import threading
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
from nice_slam_tpu_torch.io.prefetch import Prefetcher
from nice_slam_tpu_torch.mesh.mesher import Mesher
from nice_slam_tpu_torch.models.decoders import (
    init_imap_decoder, init_nice_decoders)
from nice_slam_tpu_torch.models.grids import (
    grid_world_coords, init_grids, prepare_grids, static_grid_shapes)
from nice_slam_tpu_torch.ops.trilinear import ExpandedGrid
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
    their sum.  `read_s` and `prefetch_wait_s` are the Prefetcher's of the
    last `run()`: the seconds its threads spent reading (decoding) frames
    and the seconds the main thread waited for one.  The tracker, the
    mapping thread and the mesh thread add records, so every access goes
    through the lock."""
    track: list = field(default_factory=list)
    maps: list = field(default_factory=list)
    meshes: list = field(default_factory=list)
    mesh_s: float = 0.0
    read_s: float = 0.0
    prefetch_wait_s: float = 0.0
    lock: threading.Lock = field(default_factory=threading.Lock,
                                 repr=False, compare=False)

    def add_track(self, idx: int, seconds: float) -> None:
        with self.lock:
            self.track.append((idx, seconds))

    def add_map(self, idx: int, kind: str, iters: int, seconds: float
                ) -> None:
        with self.lock:
            self.maps.append((idx, kind, iters, seconds))

    def add_mesh(self, name: str, seconds: float, pieces: dict) -> None:
        with self.lock:
            self.meshes.append((name, seconds, pieces))
            self.mesh_s += seconds

    def summary(self) -> dict:
        with self.lock:
            return self._summary()

    def _summary(self) -> dict:
        map_s = sum(s for _, kind, _, s in self.maps if kind != 'coarse')
        map_iters = sum(n for _, kind, n, _ in self.maps if kind != 'coarse')
        track_s = sum(s for _, s in self.track)
        out = {'track_s': track_s, 'map_s': map_s,
               'coarse_map_s': sum(s for _, kind, _, s in self.maps
                                   if kind == 'coarse'),
               'mesh_s': self.mesh_s, 'read_s': self.read_s,
               'prefetch_wait_s': self.prefetch_wait_s,
               'frames_tracked': len(self.track),
               'frames_mapped': sum(kind != 'coarse'
                                    for _, kind, _, _ in self.maps),
               'map_iters': map_iters}
        if track_s > 0:
            out['tracked_fps'] = len(self.track) / track_s
        if map_s > 0:
            out['map_iters_per_s'] = map_iters / map_s
        return out


# the mapping thread's pixel draws: a stream of their own, from the run seed
_MAP_SEED_OFFSET = 7919


class SlamSystem:
    """Owns all SLAM state and drives the schedule of `sync_method`, in NICE
    mode or (nice=False) iMAP* mode."""

    def __init__(self, cfg: dict, *, nice: bool = True, device=None,
                 seed: int = 0, verbose: bool | None = None,
                 output: str | None = None, input_folder: str | None = None,
                 frame_reader=None):
        """`input_folder` overrides the config's `data.input_folder` (the
        sequence's directory); `frame_reader` replaces the config's loader
        (an index-addressable reader of (index, color, depth, c2w))."""
        cfgutil.check_options(cfg)
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
        # the method lives in model.kind alone (`self.nice` reads it)
        self.model = SceneModel(
            decoder=self.dcfg,
            bound=torch.tensor(self.gcfg.bound_np, device=self.device),
            coarse_bound=(torch.tensor(self.gcfg.coarse_bound_np,
                                       device=self.device) if nice else None),
            grid_shapes=static_grid_shapes(self.gcfg) if nice else (),
            kind='nice' if nice else 'imap')
        self.coarse_enabled = bool(cfg['coarse']) and self.nice
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
        self.save_selected_keyframes = bool(
            m.get('save_selected_keyframes_info', False))
        # frame -> the window of its last mapping call: [{'idx', 'gt_c2w',
        # 'est_c2w'}, ...], selected keyframes then the current frame
        self.selected_keyframes: dict[int, list] = {}
        self._mesh_pool = None
        self._mesh_future = None
        self.sync_method = cfg.get('sync_method', 'strict')
        if self.sync_method not in ('strict', 'loose', 'free'):
            raise ValueError(f'sync_method {self.sync_method!r}')
        if self.sync_method == 'free' and not bool(
                cfg.get('sync_force_free', False)):
            # as in the JAX package on one local device: ungated back-to-
            # back mapping rounds replace the tracker's snapshot every frame
            # and contend with it for the one device
            warnings.warn(
                "sync_method: 'free' on a single device runs strictly "
                "slower than 'loose' at equal accuracy (measured on the "
                "JAX package, BASELINE.md round-4) -- using 'loose'; set "
                "sync_force_free: true to override", UserWarning,
                stacklevel=2)
            self.sync_method = 'loose'

        dev = self.device
        # the initial grids and decoders are drawn on the CPU, so a seed
        # gives the same initial model on every device; pixel draws come
        # from a generator on the run's device
        init_gen = torch.Generator().manual_seed(seed)
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self.np_rng = np.random.default_rng(seed)
        # the overlapped modes map on a thread of their own, on a stream of
        # their own, drawing pixels from a generator of their own
        self._overlap = self.sync_method != 'strict'
        self.map_generator = self.generator
        self._map_stream = None
        if self._overlap:
            self.map_generator = torch.Generator(device=dev).manual_seed(
                seed + _MAP_SEED_OFFSET)
            if dev.type == 'cuda':
                self._map_stream = torch.cuda.Stream(dev)
        self._map_pool = None
        # the queued mapping rounds, oldest first: (frame, future of the
        # round's tracking snapshot); and the frame of the round (or
        # commit) the tracker's snapshot comes from.  `refreshes` counts
        # the snapshots adopted when done and those the loose gate waited
        # for
        self._rounds = collections.deque()
        self._snapshot_idx = -1
        self.refreshes = {'consumed': 0, 'forced': 0}

        if not self.nice:
            # one decoder, no volumes
            self.grids = {}
            self.decoders = torch.nn.ModuleDict({'imap': init_imap_decoder(
                self.dcfg, generator=init_gen, device='cpu')}).to(dev)
            self.trainable = {'imap'}
        else:
            self._init_nice(cfg, init_gen)

        self.frame_reader = (get_dataset(cfg, input_folder)
                             if frame_reader is None else frame_reader)
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
        # what the tracker renders against, kept until the next mapping
        # commit: (decoders, color-stage expansion of the volumes)
        self._tracking_grids = None
        self.timers = PhaseTimers()
        self.mapping_idx = -1
        self.mesher = Mesher(cfgutil.mesher_config_from_cfg(cfg), self.model,
                             self.intr, rcfg=self.rcfg)

    @property
    def nice(self) -> bool:
        """NICE mode (else iMAP*), as the scene model's kind says."""
        return self.model.kind == 'nice'

    def _init_nice(self, cfg: dict, init_gen: torch.Generator) -> None:
        """The volumes, the NICE decoders (pretrained ones when their files
        exist) and the set of decoders the mapper trains."""
        dev = self.device
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
                    UserWarning, stacklevel=3)
            self.trainable.add('middle')

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
        """Wait for the calling thread's stream (the mapping thread's own
        under the overlapped modes)."""
        if self.device.type == 'cuda':
            torch.cuda.current_stream(self.device).synchronize()

    def _build_snapshot(self):
        """(decoders, color-stage expansion of the volumes) of the current
        map.  The overlapped modes clone the decoders: the next mapping
        round updates them in place while the tracker renders."""
        with torch.no_grad():
            grids = (prepare_grids(self.grids, self.model.grid_shapes,
                                   stage='color') if self.nice else {})
            decoders = (copy.deepcopy(self.decoders) if self._overlap
                        else self.decoders)
        return decoders, grids

    @property
    def _pending_refresh(self):
        """(frame, future) of the oldest queued mapping round, or None."""
        return self._rounds[0] if self._rounds else None

    def _tracking_snapshot(self):
        if self._tracking_grids is None:
            if self._rounds:
                # the queued rounds write the map: take the oldest's snapshot
                self._adopt(self._rounds.popleft(), forced=False)
            else:
                self._tracking_grids = self._build_snapshot()
                self._snapshot_idx = self.mapping_idx
        return self._tracking_grids

    def _adopt(self, entry, forced: bool) -> None:
        """Adopt the snapshot of a mapping round, waiting for it (and
        raising its error) if it is still running."""
        pidx, future = entry
        decoders, grids = future.result()
        tensors = [g.e if isinstance(g, ExpandedGrid) else g
                   for g in grids.values()] + list(decoders.parameters())
        if self.device.type == 'cuda':
            # made on the mapping stream, now read on this thread's stream
            stream = torch.cuda.current_stream(self.device)
            for t in tensors:
                t.record_stream(stream)
        self._tracking_grids = (decoders, grids)
        self._snapshot_idx = pidx
        self.refreshes['forced' if forced else 'consumed'] += 1

    def _adopt_rounds(self, idx: int) -> None:
        """Before tracking frame idx: adopt the newest finished round (the
        rounds finish in order; each finished one's error is raised), then,
        under loose, wait for the oldest rounds until the snapshot is at
        most every_frame + every_frame // 2 frames behind idx."""
        done = None
        while self._rounds and self._rounds[0][1].done():
            done = self._rounds.popleft()
            done[1].result()
        if done is not None:
            self._adopt(done, forced=False)
        every = self.mcfg.every_frame
        while (self.sync_method == 'loose' and self._rounds
               and idx - self._snapshot_idx > every + every // 2):
            self._adopt(self._rounds.popleft(), forced=True)

    # ------------------------------------------------------------------
    # tracking
    # ------------------------------------------------------------------

    def track(self, idx: int, color_np, depth_np, gt_c2w_np) -> np.ndarray:
        """Track one frame; returns the estimated 4x4 c2w."""
        t0 = time.perf_counter()
        color, depth = self._device_frame(idx, color_np, depth_np)
        # overlapped modes: adopt a finished (or, under loose, gate-forced)
        # mapping round; otherwise keep rendering against the snapshot
        if self._rounds:
            self._adopt_rounds(idx)
        if idx == 0 or self.gt_camera:
            c2w = np.asarray(gt_c2w_np, dtype=np.float32)
        else:
            pre = self.estimate_c2w[idx - 1]
            guess = (const_speed_init(pre, self.estimate_c2w[idx - 2])
                     if self.tcfg.const_speed and idx >= 2 else pre)
            decoders, grids = self._tracking_snapshot()
            best_cam7, _, losses = track_frame(
                decoders, grids, color, depth,
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
        self.timers.add_track(idx, time.perf_counter() - t0)
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
                  coarse: bool = False, first: bool = False,
                  frame=None, cur_c2w=None) -> None:
        """One mapping invocation (first-frame, coarse, normal, or the
        last frame's color refine).  The mapping thread passes the frame's
        device tensors and its pose by value (`frame`, `cur_c2w`)."""
        t0 = time.perf_counter()
        mcfg = self.coarse_mcfg if coarse else self.mcfg
        store = self.coarse_keyframes if coarse else self.keyframes
        color, depth = (frame if frame is not None
                        else self._device_frame(idx, color_np, depth_np))
        cur_c2w = (self.estimate_c2w[idx].copy() if cur_c2w is None
                   else cur_c2w.copy())

        refine = (idx == self.n_img - 1 and mcfg.color_refine
                  and not coarse and not first)
        window_size = mcfg.window_size
        fix_color = mcfg.fix_color
        frustum_on = mcfg.frustum_selection and self.nice
        middle_ratio, fine_ratio = mcfg.middle_iter_ratio, mcfg.fine_iter_ratio
        lr_factor = mcfg.lr_factor
        # iMAP*: a normal call is 3 outer iterations, each on a new window
        outer_iters = 1 if self.nice else 3
        n_iters = mcfg.iters // outer_iters
        if refine:
            outer_iters = 5
            window_size = mcfg.window_size * 2
            middle_ratio = fine_ratio = 0.0
            n_iters = mcfg.iters * 5 // outer_iters
            fix_color = True
            frustum_on = False
        elif first:
            outer_iters = 1
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
            if self.save_selected_keyframes and not coarse:
                self.selected_keyframes[idx] = [
                    {'idx': store.frames[p].idx,
                     'gt_c2w': store.frames[p].gt_c2w,
                     'est_c2w': store.frames[p].est_c2w.copy()}
                    for p in sel] + [{'idx': idx,
                                      'gt_c2w': np.asarray(gt_c2w_np),
                                      'est_c2w': cur_c2w.copy()}]
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
                lr_tab=lr_table(mcfg_eff, n_iters, lr_factor, ba,
                                nice=self.nice),
                stage_idx=stage_schedule(mcfg_eff, n_iters, nice=self.nice),
                colors=torch.stack(colors), depths=torch.stack(depths),
                model=self.model, rcfg=self.rcfg, mcfg=mcfg_eff,
                intr=self.intr,
                pix_per_frame=max(mcfg.pixels // n_frames, 1),
                generator=self.map_generator)
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
        self.timers.add_map(idx, kind, n_iters * outer_iters,
                            time.perf_counter() - t0)

    def _map_round(self, idx: int, color_np, depth_np, gt_c2w_np) -> None:
        """The mapping of frame idx: [coarse call] + the call (at frame 0
        the first-frame call, then the coarse one).  Under strict, and with
        BA active, it commits here, after the queued rounds; otherwise it
        is queued on the mapping thread."""
        calls = ([{'first': True}, {'coarse': True, 'first': True}]
                 if idx == 0 else [{'coarse': True}, {}])
        calls = [kw for kw in calls
                 if not kw.get('coarse') or self.coarse_enabled]
        ba = self.mcfg.ba and self._keyframes_after_rounds() > 4
        if not self._overlap or ba:
            self.join_map()
            self._rounds.clear()
            for kw in calls:
                self.map_frame(idx, color_np, depth_np, gt_c2w_np, **kw)
            self._tracking_grids = None   # the snapshot is stale
            return
        frame = self._device_frame(idx, color_np, depth_np)
        cur_c2w = self.estimate_c2w[idx].copy()
        if self._map_stream is not None:
            # the round reads what this stream uploaded; the frame tensors
            # are used on the mapping stream
            self._map_stream.wait_stream(
                torch.cuda.current_stream(self.device))
            for t in frame:
                t.record_stream(self._map_stream)
        if self._map_pool is None:
            self._map_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix='mapping')
        self._rounds.append((idx, self._map_pool.submit(
            self._map_async, idx, color_np, depth_np, gt_c2w_np, calls,
            frame, cur_c2w)))

    def _keyframes_after_rounds(self) -> int:
        """Keyframes in the store once the queued rounds are done (BA's
        activation counts them): a round appends its frame when map_frame's
        keyframe rule holds for it."""
        every = self.mcfg.keyframe_every
        queued = {p for p, _ in self._rounds
                  if p % every == 0 or p == self.n_img - 2}
        return len(set(self.keyframes.indices) | queued)

    def _map_async(self, idx, color_np, depth_np, gt_c2w_np, calls, frame,
                   cur_c2w):
        """Body of an overlapped mapping round, on the mapping thread:
        the calls, then the next tracking snapshot; returns it once the
        mapping stream has finished both."""
        stream = (torch.cuda.stream(self._map_stream)
                  if self._map_stream is not None
                  else contextlib.nullcontext())
        with stream:
            for kw in calls:
                self.map_frame(idx, color_np, depth_np, gt_c2w_np,
                               frame=frame, cur_c2w=cur_c2w, **kw)
            snapshot = self._build_snapshot()
            self._sync()
        return snapshot

    def join_map(self) -> None:
        """Wait for the queued mapping rounds, raising the first error.
        The tracker still adopts the newest snapshot at the next frame."""
        for _, future in list(self._rounds):
            future.result()

    # ------------------------------------------------------------------
    # services: checkpoint / mesh
    # ------------------------------------------------------------------

    def checkpoint_state(self) -> dict:
        """Everything a resumed run needs (utils/ckpt.py): the map, the
        poses, both keyframe stores, the schedule position and the random
        streams."""
        self.join_map()
        state = {
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
            'selected_keyframes': (self.selected_keyframes
                                   if self.save_selected_keyframes else None),
            'generator_state': self.generator.get_state(),
            'np_rng_state': self.np_rng.bit_generator.state,
        }
        if self.map_generator is not self.generator:
            state['map_generator_state'] = self.map_generator.get_state()
        return state

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
        self.join_map()
        self._rounds.clear()
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
        if state.get('selected_keyframes'):
            self.selected_keyframes = dict(state['selected_keyframes'])
        self.generator.set_state(torch.as_tensor(state['generator_state']))
        if 'map_generator_state' in state \
                and self.map_generator is not self.generator:
            self.map_generator.set_state(
                torch.as_tensor(state['map_generator_state']))
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
        self.join_map()
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
        self.timers.add_mesh(os.path.basename(path),
                             time.perf_counter() - t0,
                             dict(self.mesher.timings))

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
        self.join_map()
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

    @property
    def map_cadence(self) -> int:
        """Frames between mapping rounds: `every_frame` under strict; under
        loose and free every_frame // 2, the reference's effective loose
        cadence and the closest fixed cadence to its ungated free mapper
        (the JAX package's `map_cadence`)."""
        if self.sync_method == 'strict':
            return self.mcfg.every_frame
        return max(1, self.mcfg.every_frame // 2)

    def step(self, idx: int) -> None:
        """Process one frame under the schedule, then the services of a
        mapped frame."""
        _, color_np, depth_np, gt_c2w_np = self.frame_reader[idx]
        last = idx == self.n_img - 1
        mapped = idx == 0 or idx % self.map_cadence == 0 or last
        if idx == 0:
            self.estimate_c2w[0] = gt_c2w_np
            self.gt_c2w[0] = gt_c2w_np
        self.track(idx, color_np, depth_np, gt_c2w_np)
        if mapped:
            self._map_round(idx, color_np, depth_np, gt_c2w_np)

        if mapped:
            if ((idx % self.ckpt_freq == 0
                 and not (idx == 0 and self.no_log_first)) or last):
                self.save_ckpt(idx)
            if (idx % self.mesh_freq == 0
                    and not (idx == 0 and self.no_mesh_first)):
                self.mesh_now(idx)
            if last:
                self.mesh_now(idx, final=True)
                if self.eval_rec and self.mesher is not None:
                    self.join_map()
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
        """Frames `start` .. the last, read through a Prefetcher
        (`data.prefetch` frames ahead, `data.prefetch_workers` threads, by
        default the reader's own `prefetch_workers`).  The mapping round
        and the background mesh are joined (their errors raised here), and
        every thread stopped, however the loop ends."""
        data = self.cfg.get('data', {})
        reader, self.frame_reader = self.frame_reader, Prefetcher(
            self.frame_reader, start=start,
            ahead=int(data.get('prefetch', 2)),
            workers=int(data.get('prefetch_workers', getattr(
                self.frame_reader, 'prefetch_workers', 1))))
        try:
            for idx in range(start, self.n_img):
                self.step(idx)
            self.join_map()
            self.join_mesh()
        finally:
            for pool in (self._map_pool, self._mesh_pool):
                if pool is not None:
                    # after an error, the rounds not yet started are dropped
                    pool.shutdown(wait=True, cancel_futures=True)
            self._map_pool = self._mesh_pool = None
            self.frame_reader.close()
            with self.timers.lock:
                self.timers.read_s = self.frame_reader.read_s
                self.timers.prefetch_wait_s = self.frame_reader.wait_s
            self.frame_reader = reader
        if self.verbose:
            print('INFO: run complete:', self.timers.summary())
