"""The fused decoder kernel against the plain decoders on the mesher's
lattice query, on the card; the port's `scripts/bench_fused_eval.py`.

    python -m nice_slam_tpu_torch.tools.bench_fused_eval [resolution] \
        [--device cuda|cpu]

Times the fine stage's `eval_raw` over `resolution`^3 (default 256^3,
16.8M) points drawn uniformly in [-1, 1]^3 from default_rng(0), padded to
whole 262,144-point chunks (the mesher's `points_batch`) and queried chunk
by chunk, with `fused_eval` off (the decoders' plain PyTorch forward) and
on (the fused MLP kernel, csrc/fused_mlp.cu): the best of 3 calls each
after one untimed call.  The model is `graft_entry._tiny_setup`'s (the JAX
`__graft_entry__._tiny_setup`: its bound, the default decoders, volumes
and decoders drawn from seed 0), the volumes corner-expanded once for the
fine stage outside the timed calls, as the JAX script prepares them.

Prints the JAX script's two lines (labelled `plain` and `fused` where it
says `xla` and `fused-pallas`), then one JSON line of the same numbers
with the largest difference between the fused and the plain occupancy over
the lattice (`max_abs_diff`) against the kernel's precision bound,
`ops/fused_mlp.PRECISION_TOL` x max(1, max|plain|) over the points inside
the model's bound (`tolerance`, `agree`), the card
(`device`), each row kernel's launches over the run (`launches`) and the
peak device memory (`peak_mem_gb`, None on the CPU).  Exits 1 when the two
disagree.  On the CPU the fused path runs the kernel's plain version, so
the two agree exactly.

Left out as TPU machinery: the compile cache.  TF32 stays off, as in
`SlamSystem`.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from nice_slam_tpu_torch.engine.slam import resolve_device
from nice_slam_tpu_torch.graft_entry import _tiny_setup
from nice_slam_tpu_torch.models.grids import prepare_grids
from nice_slam_tpu_torch.ops.fused_mlp import PRECISION_TOL
from nice_slam_tpu_torch.render.renderer import eval_raw
from nice_slam_tpu_torch.utils import measure

CHUNK = 262144     # meshing.points_batch


def lattice_points(res: int, chunk: int = CHUNK) -> np.ndarray:
    """res^3 uniform points in [-1, 1]^3 from default_rng(0), padded to
    whole chunks: [n_chunks, chunk, 3] float32."""
    nc = -(-res ** 3 // chunk)
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (nc * chunk, 3)).astype(np.float32)
    return pts.reshape(nc, chunk, 3)


def query(decoders, grids: dict, pts3: torch.Tensor, model) -> torch.Tensor:
    """The fine stage's occupancy at every point of `pts3` [n_chunks,
    chunk, 3], one chunk at a time: [n_chunks, chunk]."""
    with torch.no_grad():
        return torch.stack([eval_raw(decoders, grids, p, 'fine', model)[:, 3]
                            for p in pts3])


def main(res: int = 256, device=None, *, reps: int = 3,
         chunk: int = CHUNK) -> dict:
    """Run the lattice query both ways; prints the two lines and returns
    the JSON line's object.  `reps` and `chunk` exist for the CPU tests;
    the defaults are the JAX script's."""
    dev = resolve_device(device)
    measure.true_f32()
    measure.build_kernels(dev)
    model, _, decoders, grids = _tiny_setup(dev)
    n = res ** 3
    pts3 = torch.from_numpy(lattice_points(res, chunk)).to(dev)
    with torch.no_grad():
        grids_p = prepare_grids(grids, model.grid_shapes, stage='fine')
    measure.reset_launch_counts()
    measure.reset_peak(dev)
    out, row = {}, {'metric': 'fused_eval_lattice', 'resolution': res,
                    'points': n, 'chunk': chunk, 'chunks': pts3.shape[0]}
    for fused in (False, True):
        m = model._replace(fused_eval=fused)
        out[fused] = query(decoders, grids_p, pts3, m)
        best = min(measure.wall_s(lambda: query(decoders, grids_p, pts3, m),
                                  dev)[1] for _ in range(reps))
        label = 'fused' if fused else 'plain'
        print(f'{label}: {res}^3 fine-stage query ({n / 1e6:.1f}M pts) in '
              f'{best:.3f} s = {n / best / 1e6:.0f}M pts/s', flush=True)
        row[f'{label}_s'] = best
        row[f'{label}_mpts_per_s'] = n / best / 1e6
    diff = float((out[True] - out[False]).abs().max())
    # outside the bound both give the constant 100 (eval_raw's wall),
    # which would loosen the bound a hundredfold: scale by the decoders'
    # own outputs
    inside = torch.all((pts3 > model.bound[:, 0])
                       & (pts3 < model.bound[:, 1]), dim=-1)
    tol = PRECISION_TOL * max(1.0, float(out[False][inside].abs().max()))
    row.update(speedup=row['plain_s'] / row['fused_s'], max_abs_diff=diff,
               tolerance=tol, agree=diff <= tol, device=measure.card(dev),
               launches=measure.launch_counts(),
               peak_mem_gb=measure.peak_mem_gb(dev))
    return row


def cli(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description='The fused decoder kernel against the plain decoders '
        "on the mesher's lattice query; prints two lines and one JSON "
        'line.')
    ap.add_argument('resolution', nargs='?', type=int, default=256)
    ap.add_argument('--device', default=None, help='cuda (default) or cpu')
    args = ap.parse_args(argv)
    row = main(args.resolution, args.device)
    print(json.dumps(row), flush=True)
    if not row['agree']:
        sys.exit(1)


if __name__ == '__main__':
    cli()
