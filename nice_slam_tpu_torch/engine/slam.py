"""Single-controller SLAM orchestrator (L4); port of
`nice_slam_tpu/engine/slam.py` (NICE and iMAP* modes):

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
runs `loose` on one card unless `sync_force_free: true`.  With two or more
cards (and one rank) the overlapped modes run the two-device pipeline: the
map, the mapping rounds, their stream and generator live on the second
card, and each round's tracking snapshot is copied to the tracker's.
Everything that reads the map (checkpoints, meshes, the invariant checks,
the end of the run) waits for the queued rounds first, and an error raised
inside a round is raised there or where the tracker adopts the round.

Tracking renders against a corner-expanded snapshot of the volumes that is
rebuilt after each mapping commit.  The mapper writes the volumes, the
trainable decoders and (with BA) the keyframe poses; the coarse mapper
owns the coarse volume and its own keyframe list.  Frames come through a
Prefetcher (io/prefetch.py) during `run()`.

The parallel backends (`parallel.*`; parallel/): a run's ranks
(`world`, one process each, parallel/distributed.py) each hold the whole
replicated state and track every frame.  `parallel.track: rays` shares each
tracking iteration's rays over the ranks; `parallel.map: rays` shares the
mapping rays (each rank draws its own), `parallel.map: kf` the window's
frames (the window padded by cycling frames to a multiple of the ranks;
each rank uploads only its frames); the sums over the ranks leave every
rank the same bits.  With more than one rank the mesher's lattice query is
split over them too, and meshes run on the main thread.  Under the
overlapped modes each rank maps on its own device (the two-device pipeline
is a world-of-one mechanism), and the ranks agree on the rounds to adopt:
before each frame every rank counts its leading finished rounds, and all
take the minimum over the world in one all-reduce on a gloo group of the
main thread's (`_control`), so every rank adopts the same round at the
same frame, which one JAX controller's `is_ready` decides for all its
devices.  `free` stays `free` on ranks with a card each (NCCL).  On NCCL
ranks whose mapper and tracker both run all-reduces, the tracker's go
through gloo (see `track_backend`).  In a world of one every backend runs
the single-device program bit for bit.

Services after each mapped frame, as in the JAX package: a checkpoint
every `ckpt_freq` frames and at the last frame (`<output>/ckpts/`), a mesh
every `mesh_freq` frames (on a background thread when `meshing.async`), the
final mesh and, with `meshing.eval_rec`, the evaluation mesh
(`<output>/mesh/`); one line per frame in `<output>/metrics.jsonl`; with
`mapping.save_selected_keyframes_info`, the window of every mapping call
(`selected_keyframes`, checkpointed).  Rank 0 alone writes them.

Render panels and the live dashboard, as in the JAX package (rank 0
alone): with `enable_vis` (on by default) a tracking panel every
`tracking.vis_freq` frames (`tracking_vis/`), and on mapped frames every
`mapping.vis_freq` frames panels every `mapping.vis_inside_freq`
iterations of the mapping call and one after it (`mapping_vis/`);
an output path containing 'Demo' gets the tracking panels in `vis/` and
no mapping panels (utils/visualizer.py).  A panel draws nothing from the
run's generators and changes no state: the tracking panel renders the map
the tracker rendered against (its snapshot), the mapping panels render on
the mapping thread, its device and stream.  `visualization.live` keeps
`<output>/live/` up to date (utils/live.py), and `debug.profile_dir`
traces `run()` with torch.profiler into that directory.
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
from nice_slam_tpu_torch.parallel import distributed as pdist
from nice_slam_tpu_torch.parallel.sharded import ray_sharded_map_step
from nice_slam_tpu_torch.render.renderer import SceneModel
from nice_slam_tpu_torch.utils import config as cfgutil
from nice_slam_tpu_torch.utils.ckpt import save_checkpoint
from nice_slam_tpu_torch.utils.live import LiveViewer
from nice_slam_tpu_torch.utils.visualizer import Visualizer


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


def map_device_for(device: torch.device, cards: int, world_size: int,
                   overlap: bool) -> torch.device:
    """The mapper's device: the tracker's, except under the overlapped
    modes in a world of one with two or more cards, where the mapper takes
    the next card (the two-device pipeline).  A rank always maps on its
    own device."""
    if overlap and world_size == 1 and cards >= 2:
        return torch.device('cuda', (device.index + 1) % cards)
    return device


def overlap_devices(cards: int, world_size: int, backend: str) -> int:
    """The devices the overlapped modes run on, of which `free` needs two:
    a world of one's visible cards (the two-device pipeline); ranks on
    NCCL, which `initialize` picks exactly when each rank has a card of
    its own, one a rank; ranks on gloo (sharing a card, or on the CPU)
    one."""
    if world_size == 1:
        return cards
    return world_size if backend == 'nccl' else 1


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
                 frame_reader=None, world=None):
        """`input_folder` overrides the config's `data.input_folder` (the
        sequence's directory); `frame_reader` replaces the config's loader
        (an index-addressable reader of (index, color, depth, c2w)).
        `world`: the ranks of the run (parallel/mesh.RankGroup); by default
        the world this process joined (parallel/distributed.initialize), or
        a world of one."""
        cfgutil.check_options(cfg)
        pcfg = cfg.get('parallel') or {}
        self.par_map = pcfg.get('map', 'none')
        self.par_track = pcfg.get('track', 'none')
        if self.par_map not in ('none', 'kf', 'rays'):
            raise ValueError(f'parallel.map: {self.par_map!r}')
        if self.par_track not in ('none', 'rays'):
            raise ValueError(f'parallel.track: {self.par_track!r}')
        self.world = (world if world is not None
                      else pdist.process_world(resolve_device(device)))
        if self.world.size > 1:
            # a rank runs on its own device
            if (device is not None and torch.device(device).type
                    != self.world.device.type):
                raise ValueError(f'device {device} on a rank of '
                                 f'{self.world.device.type}')
            self.device = self.world.device
        else:
            self.device = resolve_device(device)
        n_par = int(pcfg.get('devices', 0) or 0)
        if n_par and n_par != self.world.size:
            # one rank is one device; 0 means all of them
            raise ValueError(f'parallel.devices: {n_par} does not match '
                             f'the world of {self.world.size} rank(s)')
        # true f32 matmuls: reduced-precision passes destabilize the pose
        # optimization over long sequences (the JAX package pins the same
        # by default).  The config's `matmul_precision` (the session's) and
        # the decoders' effective precision (`self.dcfg.mm_precision`: their
        # own key, else the session's) reach the products as explicit
        # values, `self.model.matmul_precision` and the decoder config;
        # 'tensorfloat32' is three bfloat16 passes there, never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision('highest')

        self.cfg = cfg
        self.verbose = (cfg.get('verbose', False) if verbose is None
                        else verbose)
        self.output = output or cfg['data'].get('output', 'output/run')
        # every rank holds the same state: rank 0 alone writes the
        # checkpoints, meshes and metrics
        self.writes = self.world.rank == 0
        if self.writes:
            for sub in ('ckpts', 'mesh'):
                os.makedirs(os.path.join(self.output, sub), exist_ok=True)
        self.metrics_path = os.path.join(self.output, 'metrics.jsonl')
        self.intr = cfgutil.intrinsics_from_cfg(cfg)
        self.rcfg = cfgutil.render_config_from_cfg(cfg)
        self.dcfg = cfgutil.decoder_config_from_cfg(cfg)
        self.gcfg = cfgutil.grid_config_from_cfg(cfg)
        self.tcfg = cfgutil.tracker_config_from_cfg(cfg)
        self.mcfg = cfgutil.mapper_config_from_cfg(cfg)
        if self.par_track == 'rays' and self.tcfg.pixels % self.world.size:
            raise ValueError(
                f'parallel.track: rays needs tracking.pixels '
                f'({self.tcfg.pixels}) divisible by the number of ranks '
                f'({self.world.size})')
        # the method lives in model.kind alone (`self.nice` reads it)
        self.model = SceneModel(
            decoder=self.dcfg,
            bound=torch.tensor(self.gcfg.bound_np, device=self.device),
            coarse_bound=(torch.tensor(self.gcfg.coarse_bound_np,
                                       device=self.device) if nice else None),
            grid_shapes=static_grid_shapes(self.gcfg) if nice else (),
            kind='nice' if nice else 'imap',
            matmul_precision=cfgutil.session_precision(cfg))
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
        # the groups the parallel steps run on: one per thread that runs
        # collectives (the tracker, the mapper, the mesher), and under the
        # overlapped modes the main thread's group for host integers, on
        # which the ranks agree on the mapping rounds to adopt
        one = self.world.size == 1
        # when the mapping thread and the tracker both run all-reduces at
        # once on NCCL ranks, they would use two communicators of one card
        # in orders that differ over the ranks: an NCCL kernel waits on the
        # card for its peers, so a rank's device-wide synchronisation (a
        # cudaFree, NCCL's own calls) can wait for a kernel that waits for
        # a rank stuck behind the other communicator.  So the mapper keeps
        # the card's one communicator and the tracker's small all-reduces
        # go through gloo, the host
        track_backend = ('gloo' if self.world.backend == 'nccl'
                         and self.sync_method != 'strict'
                         and self.par_map != 'none' else None)
        self._track_group = (self.world if one or self.par_track == 'none'
                             else self.world.copy('track',
                                                  backend=track_backend))
        self._map_group = (self.world if one or self.par_map == 'none'
                           else self.world.copy('map'))
        self._mesh_group = None if one else self.world.copy('mesh')
        self._control = (None if one or self.sync_method == 'strict'
                         else self.world.copy('control', backend='gloo'))
        if self.device.type == 'cuda' and self.device.index is None:
            self.device = torch.device('cuda', torch.cuda.current_device())
        cards = (torch.cuda.device_count() if self.device.type == 'cuda'
                 else 1)
        if self.sync_method == 'free' and not bool(
                cfg.get('sync_force_free', False)) and overlap_devices(
                    cards, self.world.size, self.world.backend) < 2:
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
        # the overlapped modes map on a thread of their own, on a stream of
        # their own, drawing pixels from a generator of their own; with a
        # second card and a world of one the mapper owns it: the map, the
        # mapping operands and the mapper's generator and stream live
        # there, and each round's tracking snapshot is copied to the
        # tracker's card (the two-device pipeline)
        self._overlap = self.sync_method != 'strict'
        self.map_device = map_device_for(self.device, cards, self.world.size,
                                         self._overlap)
        self.map_model = self.model
        if self.map_device != self.device:
            self.map_model = self.model._replace(
                bound=self.model.bound.to(self.map_device),
                coarse_bound=(None if self.model.coarse_bound is None else
                              self.model.coarse_bound.to(self.map_device)))

        dev, map_dev = self.device, self.map_device
        # the initial grids and decoders are drawn on the CPU, so a seed
        # gives the same initial model on every device; pixel draws come
        # from a generator on the run's device
        init_gen = torch.Generator().manual_seed(seed)
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        self.np_rng = np.random.default_rng(seed)
        self.map_generator = self.generator
        self._map_stream = None
        rays = self.par_map == 'rays' and not one
        if self._overlap or rays:
            # under `parallel.map: rays` each rank draws its own mapping
            # rays; the tracking draws (and keyframe-sharded mapping's)
            # stay in step over the ranks
            self.map_generator = torch.Generator(
                device=map_dev).manual_seed(
                    seed + _MAP_SEED_OFFSET + (self.world.rank if rays
                                               else 0))
        if self._overlap and map_dev.type == 'cuda':
            self._map_stream = torch.cuda.Stream(map_dev)
        self._map_pool = None
        # the queued mapping rounds, oldest first: (frame, future of the
        # round's tracking snapshot); and the frame of the round (or
        # commit) the tracker's snapshot comes from.  `adoptions` records
        # each adoption as (frame tracked, the round's frame, whether the
        # loose gate waited for it), the same on every rank
        self._rounds = collections.deque()
        self._snapshot_idx = -1
        self.adoptions: list[tuple[int, int, bool]] = []

        if not self.nice:
            # one decoder, no volumes
            self.grids = {}
            self.decoders = torch.nn.ModuleDict({'imap': init_imap_decoder(
                self.dcfg, generator=init_gen, device='cpu')}).to(map_dev)
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
        # (frame, device) -> the frame's color and depth on that device
        self._frames: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}
        # the frustum masks' node coordinates live with the mapper
        self._grid_points = {
            name: torch.tensor(
                grid_world_coords(self.gcfg, name).reshape(-1, 3),
                device=map_dev)
            for name in self.grids}
        # what the tracker renders against, kept until the next mapping
        # commit: (decoders, color-stage expansion of the volumes)
        self._tracking_grids = None
        self.timers = PhaseTimers()
        self.mapping_idx = -1
        # the mesher reads the map where it lives; with more than one rank
        # its lattice query is split over them (and runs on this thread)
        self.mesher = Mesher(cfgutil.mesher_config_from_cfg(cfg),
                             self.map_model, self.intr, rcfg=self.rcfg,
                             group=self._mesh_group)
        if not one:
            self.mesh_async = False
        self.profile_dir = (cfg.get('debug') or {}).get('profile_dir')
        self._init_services(cfg)

    def _init_services(self, cfg: dict) -> None:
        """The render panels and the live dashboard (the writing rank's
        alone), with the JAX package's directories and defaults."""
        self.vis_enabled = bool(cfg.get('enable_vis', True))
        self.track_vis = self.map_vis = self.live = None
        self._last_panel: str | None = None
        if not self.writes:
            return
        demo = 'Demo' in self.output
        self.track_vis = Visualizer(
            os.path.join(self.output, 'vis' if demo else 'tracking_vis'),
            cfg['tracking'].get('vis_freq', 50), model=self.model,
            rcfg=self.rcfg, intr=self.intr, verbose=self.verbose)
        if not demo:
            self.map_vis = Visualizer(
                os.path.join(self.output, 'mapping_vis'),
                cfg['mapping'].get('vis_freq', 50), model=self.map_model,
                rcfg=self.rcfg, intr=self.intr, verbose=self.verbose)
        vcfg = cfg.get('visualization') or {}
        if vcfg.get('live'):
            self.live = LiveViewer(
                os.path.join(self.output, 'live'), self.intr,
                freq=int(vcfg.get('live_freq', 5)),
                port=vcfg.get('live_port'))

    @property
    def nice(self) -> bool:
        """NICE mode (else iMAP*), as the scene model's kind says."""
        return self.model.kind == 'nice'

    def _init_nice(self, cfg: dict, init_gen: torch.Generator) -> None:
        """The volumes, the NICE decoders (pretrained ones when their files
        exist) and the set of decoders the mapper trains, on the mapper's
        device."""
        dev = self.map_device
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

    def _device_frame(self, idx: int, color_np, depth_np, device=None):
        """Frame idx's color and depth on `device` (the tracker's by
        default), uploaded once."""
        device = self.device if device is None else device
        key = (idx, device)
        # one lookup: the main thread drops frames while a mapping round
        # reads the cache
        frame = self._frames.get(key)
        if frame is None:
            frame = self._frames[key] = (
                torch.as_tensor(color_np, dtype=torch.float32,
                                device=device),
                torch.as_tensor(depth_np, dtype=torch.float32,
                                device=device))
        return frame

    def _cam7(self, c2w_np: np.ndarray, device=None) -> torch.Tensor:
        return tensor_from_c2w(torch.as_tensor(
            np.asarray(c2w_np[:3, :4], dtype=np.float32),
            device=self.device if device is None else device))

    def _sync(self, device=None) -> None:
        """Wait for the calling thread's stream on `device` (the tracker's
        by default; the mapping thread's own under the overlapped
        modes)."""
        device = self.device if device is None else device
        if device.type == 'cuda':
            torch.cuda.current_stream(device).synchronize()

    def _build_snapshot(self):
        """(decoders, color-stage expansion of the volumes) of the current
        map.  The overlapped modes clone the decoders: the next mapping
        round updates them in place while the tracker renders."""
        with torch.no_grad():
            grids, decoders = self.grids, self.decoders
            if self._overlap:
                decoders = copy.deepcopy(decoders)
            if self.map_device != self.device:
                # the two-device pipeline: the snapshot goes to the
                # tracker's card
                grids = {k: g.detach().to(self.device)
                         for k, g in grids.items()}
                decoders = decoders.to(self.device)
            grids = (prepare_grids(grids, self.model.grid_shapes,
                                   stage='color') if self.nice else {})
        return decoders, grids

    @property
    def refreshes(self) -> dict:
        """The snapshots adopted when done and those the loose gate waited
        for."""
        forced = sum(f for _, _, f in self.adoptions)
        return {'consumed': len(self.adoptions) - forced, 'forced': forced}

    @property
    def _pending_refresh(self):
        """(frame, future) of the oldest queued mapping round, or None."""
        return self._rounds[0] if self._rounds else None

    def _tracking_snapshot(self, idx: int):
        if self._tracking_grids is None:
            if self._rounds:
                # the queued rounds write the map: take the oldest's snapshot
                self._adopt(idx, self._rounds.popleft(), forced=False)
            else:
                self._tracking_grids = self._build_snapshot()
                self._snapshot_idx = self.mapping_idx
        return self._tracking_grids

    def _adopt(self, idx: int, entry, forced: bool) -> None:
        """Adopt the snapshot of a mapping round before tracking frame idx,
        waiting for it (and raising its error) if it is still running."""
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
        self.adoptions.append((idx, pidx, forced))

    def _adopt_rounds(self, idx: int) -> None:
        """Before tracking frame idx: adopt the newest finished round (the
        rounds finish in order; each finished one's error is raised), then,
        under loose, wait for the oldest rounds until the snapshot is at
        most every_frame + every_frame // 2 frames behind idx.  With more
        than one rank, "finished" is the least count of leading finished
        rounds over the ranks: every rank has those finished, so none
        waits, and every rank adopts the same round."""
        k = 0
        while k < len(self._rounds) and self._rounds[k][1].done():
            k += 1
        if self._control is not None:
            k = self._control.min(k)
        done = None
        for _ in range(k):
            done = self._rounds.popleft()
            done[1].result()
        if done is not None:
            self._adopt(idx, done, forced=False)
        every = self.mcfg.every_frame
        while (self.sync_method == 'loose' and self._rounds
               and idx - self._snapshot_idx > every + every // 2):
            self._adopt(idx, self._rounds.popleft(), forced=True)

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
            guess = (const_speed_init(pre, self.estimate_c2w[idx - 2],
                                      self.model.matmul_precision)
                     if self.tcfg.const_speed and idx >= 2 else pre)
            decoders, grids = self._tracking_snapshot(idx)
            best_cam7, _, losses = track_frame(
                decoders, grids, color, depth,
                self._cam7(guess), model=self.model, rcfg=self.rcfg,
                tcfg=self.tcfg, intr=self.intr, generator=self.generator,
                group=(self._track_group if self.par_track == 'rays'
                       else None))
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
        if (self.vis_enabled and self.track_vis is not None and idx > 0
                and idx % self.track_vis.freq == 0):
            decoders, grids = self._tracked_map()
            self._last_panel = self.track_vis.vis(
                idx, 0, depth_np, color_np, c2w, decoders, grids)
        return c2w

    def _tracked_map(self):
        """The map a tracking panel renders: the tracker's snapshot; with
        none (ground-truth poses), the snapshot of the oldest queued
        round, which the tracker would adopt next, else the map itself,
        which no round is writing then."""
        if self._tracking_grids is not None:
            return self._tracking_grids
        if self._rounds:
            return self._rounds[0][1].result()
        return self.decoders, self.grids

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
                              device=self.map_device)
        masks = {}
        for name, g in self.grids.items():
            if name == 'coarse':
                masks[name] = torch.ones((g.shape[0], 1),
                                         device=self.map_device)
            else:
                masks[name] = frustum_mask(self._grid_points[name], c2w,
                                           depth, self.intr,
                                           self.model.matmul_precision
                                           )[:, None]
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
        mdev = self.map_device
        color, depth = (frame if frame is not None else self._device_frame(
            idx, color_np, depth_np, device=mdev))
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
        panel_iters = self._inside_panel_iters(idx, mcfg, n_iters, coarse)

        def panel(it):
            # a panel between two iterations, from the map as it stands
            if it in panel_iters:
                self._last_panel = self.map_vis.vis(
                    idx, it, depth_np, color_np, cur_c2w, self.decoders,
                    self.grids)

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
            # keyframe sharding keeps the window's images on the host here:
            # each rank uploads only its frames below
            kf_par = self.par_map == 'kf'
            colors, depths, cam7s, cam_mask = [], [], [], []
            for pos in sel:
                kf = store.frames[pos]
                c, d = ((kf.color, kf.depth) if kf_par else
                        self._device_frame(kf.idx, kf.color, kf.depth,
                                           device=mdev))
                colors.append(c)
                depths.append(d)
                cam7s.append(self._cam7(kf.est_c2w, mdev))
                cam_mask.append(0.0 if pos == oldest else 1.0)
            colors.append(color_np if kf_par else color)
            depths.append(depth_np if kf_par else depth)
            cam7s.append(self._cam7(cur_c2w, mdev))
            cam_mask.append(1.0)
            real_n = len(colors)
            # pad the window to its full size by cycling the real frames,
            # newest first; the padding slots' poses are frozen.  A sharded
            # window's frame count is a multiple of the ranks
            n_frames = max(window_size, real_n)
            if self.par_map != 'none':
                n_frames = -(-n_frames // self._map_group.size) \
                    * self._map_group.size
            for k in range(n_frames - real_n):
                src = real_n - 1 - (k % real_n)
                colors.append(colors[src])
                depths.append(depths[src])
                cam7s.append(cam7s[src])
                cam_mask.append(0.0)

            kw = dict(
                trainable=trainable,
                masks=(self._frustum_masks(cur_c2w, depth)
                       if frustum_on else None),
                cam_mask=(torch.tensor(cam_mask, device=mdev)
                          if ba else None),
                lr_tab=lr_table(mcfg_eff, n_iters, lr_factor, ba,
                                nice=self.nice),
                stage_idx=stage_schedule(mcfg_eff, n_iters, nice=self.nice),
                model=self.map_model, rcfg=self.rcfg, mcfg=mcfg_eff,
                intr=self.intr,
                pix_per_frame=max(mcfg.pixels // n_frames, 1),
                generator=self.map_generator,
                on_iteration=panel if panel_iters else None)
            if kf_par:
                mine = pdist.window_slice(n_frames, self._map_group)

                def upload(frames):
                    return torch.as_tensor(np.stack(frames[mine]),
                                           dtype=torch.float32, device=mdev)

                cams, losses = pdist.kf_sharded_map_step(
                    self.decoders, self.grids, torch.stack(cam7s),
                    group=self._map_group, colors=upload(colors),
                    depths=upload(depths), **kw)
            elif self.par_map == 'rays':
                cams, losses = ray_sharded_map_step(
                    self.decoders, self.grids, torch.stack(cam7s),
                    group=self._map_group, colors=torch.stack(colors),
                    depths=torch.stack(depths), **kw)
            else:
                cams, losses = map_step(
                    self.decoders, self.grids, torch.stack(cam7s),
                    colors=torch.stack(colors), depths=torch.stack(depths),
                    **kw)
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

        self._sync(mdev)
        if not coarse:
            self.mapping_idx = idx
        kind = ('coarse' if coarse else 'first' if first
                else 'refine' if refine else 'normal')
        self.timers.add_map(idx, kind, n_iters * outer_iters,
                            time.perf_counter() - t0)
        if (not coarse and self.vis_enabled and self.map_vis is not None
                and idx > 0):
            self._last_panel = self.map_vis.vis(
                idx, 0, depth_np, color_np, cur_c2w, self.decoders,
                self.grids) or self._last_panel

    def _inside_panel_iters(self, idx: int, mcfg: MapperConfig,
                            n_iters: int, coarse: bool) -> frozenset:
        """The iterations of a mapping call (each outer iteration's) before
        which a panel renders: the JAX package renders one before each of
        its compiled chunks whose start is a multiple of
        `mapping.vis_inside_freq`, its chunks `iters` iterations long (a
        third for iMAP*), at most `vis_inside_freq`, on frames that are
        multiples of `mapping.vis_freq`, never in the coarse call, and not
        on frame 0 while `no_vis_on_first_frame` holds."""
        m = self.cfg['mapping']
        inside = int(m.get('vis_inside_freq', 0))
        freq = int(m.get('vis_freq', 0))
        if not (self.vis_enabled and self.map_vis is not None and not coarse
                and freq > 0 and inside > 0 and idx % freq == 0
                and idx % self.map_vis.freq == 0
                and (idx > 0 or not m.get('no_vis_on_first_frame', True))):
            return frozenset()
        chunk = max(min(mcfg.iters // (1 if self.nice else 3), n_iters,
                         inside), 1)
        return frozenset(c for c in range(0, n_iters, chunk)
                         if c % inside == 0)

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
        frame = self._device_frame(idx, color_np, depth_np,
                                   device=self.map_device)
        cur_c2w = self.estimate_c2w[idx].copy()
        if self._map_stream is not None:
            # the round reads what this stream uploaded; the frame tensors
            # are used on the mapping stream
            self._map_stream.wait_stream(
                torch.cuda.current_stream(self.map_device))
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
        return len(set(self.keyframes.indices) | self._queued_keyframes())

    def _queued_keyframes(self) -> set:
        """The frames the queued rounds will append to the keyframes."""
        every = self.mcfg.keyframe_every
        return {p for p, _ in self._rounds
                if p % every == 0 or p == self.n_img - 2}

    def _map_async(self, idx, color_np, depth_np, gt_c2w_np, calls, frame,
                   cur_c2w):
        """Body of an overlapped mapping round, on the mapping thread:
        the calls, then the next tracking snapshot; returns it once the
        mapping stream has finished both."""
        on_card = self._map_stream is not None
        with (torch.cuda.device(self.map_device) if on_card
              else contextlib.nullcontext()), \
                (torch.cuda.stream(self._map_stream) if on_card
                 else contextlib.nullcontext()):
            for kw in calls:
                self.map_frame(idx, color_np, depth_np, gt_c2w_np,
                               frame=frame, cur_c2w=cur_c2w, **kw)
            snapshot = self._build_snapshot()
            self._sync(self.map_device)
            if self.map_device != self.device:
                # the snapshot's copy and expansion on the tracker's card
                self._sync(self.device)
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

    def save_ckpt(self, idx: int) -> str | None:
        """Write the checkpoint of frame idx (rank 0 only: the ranks'
        states are the same); returns its path, or None on another
        rank."""
        if not self.writes:
            return None
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
        here, on the current stream, before it starts.  With more than one
        rank every rank extracts (the lattice query is split over them)
        and rank 0 writes the file; the others return None."""
        if self.mesher is None:
            return None
        self.join_mesh()
        self.join_map()
        name = 'final_mesh.ply' if final else f'{idx:05d}_mesh.ply'
        path = (os.path.join(self.output, 'mesh', name) if self.writes
                else None)
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
        self.timers.add_mesh(os.path.basename(path or ''),
                             time.perf_counter() - t0,
                             dict(self.mesher.timings))

    def join_mesh(self) -> None:
        """Wait for the background mesh, if any (its error is raised
        here)."""
        if self._mesh_future is not None:
            future, self._mesh_future = self._mesh_future, None
            future.result()

    def _log_metrics(self, idx: int, mapped: bool) -> None:
        """The frame's line of metrics.jsonl.  `mapped` and the keyframe
        count are the schedule's, queued rounds included (as the JAX
        package's, which commits a round's host state when it dispatches
        it), not what a mapping thread has finished by now."""
        if not self.writes:
            return
        gt_err = float(np.linalg.norm(
            self.estimate_c2w[idx][:3, 3] - self.gt_c2w[idx][:3, 3]))
        rec = {'frame': idx, 'pose_err_vs_gt': round(gt_err, 5),
               'mapped': mapped,
               'n_keyframes': self._keyframes_after_rounds(),
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
                                     'final_mesh_eval_rec.ply')
                        if self.writes else None,
                        self.decoders, self.grids, self.keyframes,
                        self.estimate_c2w, idx, show_forecast=False,
                        clean_mesh=True, get_mask_use_all_frames=True)
        if self.check_invariants:
            self._assert_invariants(idx)
        self._log_metrics(idx, mapped)
        if self.live is not None:
            self.live.update(idx, self.n_img, self.estimate_c2w,
                             self.gt_c2w,
                             mesh_dir=os.path.join(self.output, 'mesh'),
                             panel_path=self._last_panel,
                             timers=self.timers.summary())
        # keep device copies of keyframes only (a queued round's frame
        # counts as the keyframe it will be)
        if idx not in self.keyframes.indices \
                and idx not in self.coarse_keyframes.indices \
                and idx not in self._queued_keyframes():
            for key in [k for k in list(self._frames) if k[0] == idx]:
                del self._frames[key]

    def run(self, start: int = 0) -> None:
        """Frames `start` .. the last, read through a Prefetcher
        (`data.prefetch` frames ahead, `data.prefetch_workers` threads, by
        default the reader's own `prefetch_workers`).  The mapping round
        and the background mesh are joined (their errors raised here), and
        every thread stopped, however the loop ends."""
        data = self.cfg.get('data', {})
        profiler = None
        if self.profile_dir:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == 'cuda':
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    self.profile_dir))
            profiler.start()
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
            if self.live is not None:
                self.live.close()
            if profiler is not None:
                profiler.stop()
        if self.verbose:
            print('INFO: run complete:', self.timers.summary())
