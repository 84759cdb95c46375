"""Groups of ranks: the port's counterpart of the device meshes of
`nice_slam_tpu/parallel/mesh.py` (`make_ray_mesh`), `distributed.kf_mesh`
and `blocks.make_block_mesh`.  The ray- and keyframe-sharded steps run on
the world's group (or a copy of it, one per thread); `make_block_grid`
splits it into the block and ray groups of grid-block TP.

A JAX mesh names the devices one program runs on.  Here one process, a
*rank*, stands for one mesh device and owns one card (or the CPU), and a
`RankGroup` is the ranks that run one program together: its size, this
process's rank in it, its device, the torch.distributed backend and process
group, and counters of its collectives.  The collectives the parallel steps
need are methods built on `all_reduce` alone, which gloo also takes for
CUDA tensors (ranks that share one card talk through gloo):

* `sum_list`: a list of tensors summed over the ranks in ONE all-reduce of
  one flat buffer (the counterpart of `psum` over a gradient pytree);
* `all_gather_tiled`: each rank's [n, ...] slice placed in a zeroed
  [size * n, ...] buffer and summed, so every rank holds the slices in rank
  order (x + 0 is x, so the result is each slice's own bits);
* `max`: the element-wise maximum over the ranks;
* `min`: the minimum of one host integer over the ranks (a CPU int64
  all-reduce, on a gloo group: the overlapped schedules' agreement on the
  mapping rounds to adopt).

Every rank of a group gets the same bits from a sum: the reduction is
computed once per element and sent to all.  A group of one rank does no
collective and returns its inputs themselves, so a world of one runs the
single-device code bit for bit.

`split` makes sub-groups: `torch.distributed.new_group` must be called by
every rank of the world for every group, in the same order, so each rank
passes the whole partition and keeps the part that holds it.  Threads that
run collectives at the same time each need a group of their own.  A
sub-group may take another backend than the world's (`backend='gloo'`: a
group for host integers beside an NCCL world).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass
class CollectiveStats:
    """Counters of a group's collectives.  With `timed` the calling
    stream is synchronized before and after each one, so `seconds` is the
    collective's own wall time (this costs the overlap of the collective
    with the work queued before it)."""

    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0
    timed: bool = False


class RankGroup:
    """The ranks that run one program together (see the module note).

    size, rank: the group's size and this process's rank in it; device:
    this rank's device; backend: 'nccl', 'gloo', or 'none' for a group of
    one; pg: the torch.distributed process group (None for a group of one);
    ranks: the group's global ranks, in group order."""

    def __init__(self, size: int, rank: int, device: torch.device,
                 backend: str = 'none', pg=None,
                 ranks: tuple[int, ...] | None = None):
        if size > 1 and pg is None:
            raise ValueError('a group of more than one rank needs a process '
                             'group')
        self.size = size
        self.rank = rank
        self.device = torch.device(device)
        self.backend = backend
        self.pg = pg
        self.ranks = tuple(range(size)) if ranks is None else tuple(ranks)
        self.stats = CollectiveStats()
        self._split_cache: dict = {}

    def __repr__(self) -> str:
        return (f'RankGroup(rank {self.rank} of {self.size}, {self.device}, '
                f'{self.backend})')

    # -- collectives ---------------------------------------------------

    def _all_reduce(self, buf: torch.Tensor, op) -> None:
        timed = self.stats.timed and buf.is_cuda
        if timed:
            torch.cuda.current_stream(buf.device).synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(buf, op=op, group=self.pg)
        if timed:
            torch.cuda.current_stream(buf.device).synchronize()
        self.stats.seconds += time.perf_counter() - t0
        self.stats.calls += 1
        self.stats.bytes += buf.numel() * buf.element_size()

    def sum_list(self, tensors) -> list:
        """Each tensor summed over the ranks, in one all-reduce of one flat
        float32 buffer; None entries stay None (every rank must pass the
        same shapes and the same None entries).  The sums are views of that
        one buffer: a caller that keeps one beyond the step (a loss in a
        list) keeps a copy, not the whole buffer."""
        tensors = list(tensors)
        if self.size == 1:
            return tensors
        live = [t for t in tensors if t is not None]
        if any(t.dtype != torch.float32 for t in live):
            raise ValueError('sum_list takes float32 tensors')
        flat = torch.cat([t.detach().reshape(-1) for t in live])
        self._all_reduce(flat, dist.ReduceOp.SUM)
        out, k = [], 0
        for t in tensors:
            if t is None:
                out.append(None)
            else:
                out.append(flat[k:k + t.numel()].view(t.shape))
                k += t.numel()
        return out

    def all_gather_tiled(self, x: torch.Tensor) -> torch.Tensor:
        """[n, ...] per rank -> [size * n, ...], the ranks' slices in rank
        order, on every rank."""
        if self.size == 1:
            return x
        n = x.shape[0]
        out = x.new_zeros((self.size * n,) + tuple(x.shape[1:]))
        out[self.rank * n:(self.rank + 1) * n] = x.detach()
        self._all_reduce(out, dist.ReduceOp.SUM)
        return out

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The element-wise maximum of `x` over the ranks."""
        if self.size == 1:
            return x
        out = x.detach().reshape(-1).clone()
        self._all_reduce(out, dist.ReduceOp.MAX)
        return out.view(x.shape)

    def min(self, value: int) -> int:
        """The minimum of a host integer over the ranks, in one all-reduce
        of a CPU int64 tensor (the group's backend must take CPU tensors:
        gloo)."""
        if self.size == 1:
            return int(value)
        buf = torch.tensor([int(value)], dtype=torch.int64)
        self._all_reduce(buf, dist.ReduceOp.MIN)
        return int(buf.item())

    # -- sub-groups ----------------------------------------------------

    def split(self, partition, tag: str = '',
              backend: str | None = None) -> 'RankGroup':
        """The sub-group holding this rank, of a partition of the world's
        ranks.  Only the world's group splits, and every rank calls it with
        the same partition (torch.distributed.new_group is collective over
        the world); `tag` keeps groups of the same ranks apart (one per
        thread that runs collectives); `backend` is the sub-groups'
        (default: the world's).  A partition already made with the same tag
        and backend is reused."""
        partition = tuple(tuple(int(r) for r in part) for part in partition)
        backend = backend or self.backend
        key = (partition, tag, backend)
        if key not in self._split_cache:
            if self.size > 1 and self.size != dist.get_world_size():
                raise ValueError('only the world group splits')
            mine = None
            for part in partition:
                if len(part) > 1:
                    # every rank of the world takes part in new_group
                    pg = dist.new_group([self.ranks[r] for r in part],
                                        backend=backend)
                else:
                    pg = None
                if self.rank in part:
                    mine = RankGroup(len(part), part.index(self.rank),
                                     self.device, backend
                                     if len(part) > 1 else 'none', pg,
                                     [self.ranks[r] for r in part])
            if mine is None:
                raise ValueError(f'rank {self.rank} is in no part of '
                                 f'{partition}')
            self._split_cache[key] = mine
        return self._split_cache[key]

    def copy(self, tag: str, backend: str | None = None) -> 'RankGroup':
        """A group of the same ranks with a process group of its own (and
        `backend`, by default the world's)."""
        return self.split([range(self.size)], tag=tag, backend=backend)


def world_of_one(device) -> RankGroup:
    """The group of a process that runs alone."""
    return RankGroup(1, 0, torch.device(device))


def make_block_grid(world: RankGroup, n_block: int,
                    n_rays: int | None = None, tag: str = ''):
    """A ('block', 'rays') grid of ranks (JAX: `make_block_mesh`): rank
    b * n_rays + r holds volume block b and ray share r.  Returns
    (block_group, rays_group): the ranks that hold this rank's ray share
    (one per block) and those that hold its block (one per ray share)."""
    if n_rays is None:
        n_rays = world.size // n_block
    if n_block * n_rays != world.size:
        raise ValueError(f'a {n_block} x {n_rays} grid of ranks needs '
                         f'{n_block * n_rays} ranks, the world has '
                         f'{world.size}')
    blocks = [[b * n_rays + r for b in range(n_block)]
              for r in range(n_rays)]
    rays = [[b * n_rays + r for r in range(n_rays)]
            for b in range(n_block)]
    return (world.split(blocks, tag=f'{tag}block'),
            world.split(rays, tag=f'{tag}rays'))
