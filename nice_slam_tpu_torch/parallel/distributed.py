"""Multi-process bring-up and keyframe-sharded mapping; port of
`nice_slam_tpu/parallel/distributed.py`.

JAX starts one runtime over hosts and meshes every process's devices.  The
port runs one process per device: a *rank* (a process) stands for one JAX
mesh device, and `initialize` joins it to a torch.distributed world with a
`tcp://` rendezvous at the coordinator.  The backend is chosen once, at
bring-up, by one rule, and printed:

* NCCL when every rank has a card of its own (at least as many cards as
  ranks): rank r uses `cuda:{r % torch.cuda.device_count()}`;
* gloo when ranks share a card (more ranks than cards), for example two
  ranks on one card: gloo reduces CUDA tensors through the host;
* gloo on the CPU under `cpu_simulation` (`NSTPU_CPU_SIM=1`, the tests).

A rank that should have a card and finds none raises; nothing switches
backend or device after an error.  `initialize_from_env` reads the JAX
package's variables (`NSTPU_COORDINATOR`, `NSTPU_NUM_PROCESSES`,
`NSTPU_PROCESS_ID`, `NSTPU_CPU_SIM`); `NSTPU_LOCAL_DEVICES` above 1 is
refused, since a rank owns one device.  A process with no coordinator is a
world of one.

Every rank holds the whole replicated state (grids, decoders, keyframes,
poses) and tracks every frame, as each JAX process does; the parallel steps
sum their gradients over the ranks, which leaves every rank the same bits.

`kf_sharded_map_step` is `make_kf_sharded_map_step`: the window's frames
are split over the ranks, each rank holds only its frames' images, and the
draws are the slices of the whole window's, so the step is the single-rank
step up to the order of the sums.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from nice_slam_tpu_torch.engine.mapper import (
    draw_map_iteration, map_iterations)
from nice_slam_tpu_torch.parallel.mesh import RankGroup, world_of_one

# the world this process joined (torch.distributed's own state is process
# wide too); None until `initialize`
_WORLD: RankGroup | None = None


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, *, cpu_simulation: bool = False,
               local_device_count: int | None = None) -> RankGroup:
    """Join this process to the world as rank `process_id` of
    `num_processes`; returns the world's group (see the module note for
    the backend and device rule)."""
    global _WORLD
    if local_device_count is not None and local_device_count > 1:
        raise ValueError(f'NSTPU_LOCAL_DEVICES={local_device_count}: a rank '
                         f'of the PyTorch port owns one device; start one '
                         f'process per device instead')
    if not 0 <= process_id < num_processes:
        raise ValueError(f'process id {process_id} outside a world of '
                         f'{num_processes}')
    if cpu_simulation:
        device, backend = torch.device('cpu'), 'gloo'
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(f'rank {process_id}: no CUDA device (set '
                               f'NSTPU_CPU_SIM=1 to run the ranks on the '
                               f'CPU)')
        cards = torch.cuda.device_count()
        device = torch.device('cuda', process_id % cards)
        torch.cuda.set_device(device)
        backend = 'nccl' if num_processes <= cards else 'gloo'
    address = (coordinator_address if '://' in coordinator_address
               else f'tcp://{coordinator_address}')
    dist.init_process_group(backend, init_method=address,
                            world_size=num_processes, rank=process_id)
    _WORLD = RankGroup(num_processes, process_id, device, backend,
                       dist.group.WORLD)
    print(f'INFO: rank {process_id} of {num_processes} on {device}, '
          f'backend {backend}', flush=True)
    return _WORLD


def initialize_from_env() -> RankGroup | None:
    """`initialize` from the NSTPU_* variables; None (a world of one) when
    `NSTPU_COORDINATOR` is not set."""
    coord = os.environ.get('NSTPU_COORDINATOR')
    if not coord:
        return None
    local = int(os.environ.get('NSTPU_LOCAL_DEVICES', '0')) or None
    return initialize(
        coord, int(os.environ['NSTPU_NUM_PROCESSES']),
        int(os.environ['NSTPU_PROCESS_ID']),
        cpu_simulation=bool(int(os.environ.get('NSTPU_CPU_SIM', '0'))),
        local_device_count=local)


def process_world(device) -> RankGroup:
    """The world this process joined, or a world of one on `device`."""
    return _WORLD if _WORLD is not None else world_of_one(device)


def shutdown() -> None:
    """Leave the world (destroys every process group)."""
    global _WORLD
    if dist.is_initialized():
        dist.destroy_process_group()
    _WORLD = None


def window_slice(n_frames: int, group: RankGroup) -> slice:
    """The window frames rank `group.rank` owns (`window_to_global`: each
    rank uploads only these); n_frames must tile the group."""
    if n_frames % group.size:
        raise ValueError(f'window of {n_frames} frames not divisible over '
                         f'{group.size} ranks')
    f_local = n_frames // group.size
    return slice(group.rank * f_local, (group.rank + 1) * f_local)


def kf_sharded_map_step(decoders, grids, cams, *, group: RankGroup,
                        colors: torch.Tensor, depths: torch.Tensor,
                        pix_per_frame: int, draws=None, generator=None,
                        **kw):
    """Keyframe-sharded `engine.mapper.map_step`.

    cams: [F, 7], the whole window (replicated), F a multiple of the group
    size; colors / depths: this rank's frames only (`window_slice`).  Each
    iteration's draws are the whole window's (`draws[it]`, or drawn from
    `generator`, which every rank keeps in step) sliced to this rank's
    frames, so they are the single-rank step's; the far clamp is the
    maximum over the ranks; the loss and every gradient (the camera rows
    of this rank's frames, the volumes, the decoders) are summed over the
    ranks before the identical masked Adam step.  Returns map_step's
    (cams [F, 7], losses)."""
    n_frames = cams.shape[0]
    frames = window_slice(n_frames, group)
    if colors.shape[0] != frames.stop - frames.start:
        raise ValueError(f'rank {group.rank} holds {colors.shape[0]} '
                         f'frames, its share of the window is '
                         f'{frames.stop - frames.start}')
    rcfg, intr = kw['rcfg'], kw['intr']

    def draw(it):
        full = (draws[it] if draws is not None else draw_map_iteration(
            n_frames, pix_per_frame, intr, rcfg, generator=generator,
            device=cams.device))
        return full.frames(frames)

    return map_iterations(decoders, grids, cams, colors=colors,
                          depths=depths, pix_per_frame=pix_per_frame,
                          draw=draw, frames=frames, reduce=group.sum_list,
                          reduce_max=group.max, **kw)
