"""First-frame mapping from scratch on the test scene, for both packages
and swapped initial decoders, on the CPU.

    JAX_PLATFORMS=cpu python scripts/port_first_frame_scan.py \
        [--seeds 0 1 2] [--runs torch jax jax_from_torch torch_from_jax] \
        [--orbit] [--demo] [--volumes]

For each seed and run, one line of JSON with the first and last loss of
the first-frame mapping call (400 iterations) on
`tests.util.make_test_cfg(n_frames=5)`:
  * torch / jax: each package from its own initial model for the seed;
  * jax_from_torch: the JAX package from the port's initial decoders;
  * torch_from_jax: the port from the JAX package's initial decoders.
A last loss near the first one means the map diverged (every occupancy
logit saturated).  Each line also gives `moved`, the largest change of
each decoder's parameters over the call: a decoder left at 0 was never
trained.  With --demo the config is instead the Demo budget's at 480x640
(`nice_slam_tpu_torch.tools.bench_demo.demo_config`, which
tests/test_torch_measure_scripts.py holds equal to scripts/bench_demo.py's
own); with --volumes the two swapped runs carry the initial volumes
across as well as the decoders.  With --orbit, each port run instead goes through the
16-frame orbit of tests/test_recon_acceptance.py (ground-truth poses) and
prints `calc_3d_metric` of its final mesh against the analytic ground
truth, or the error when the mesh is empty.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def torch_tree(module) -> dict:
    """A port decoder module as the JAX package's parameter pytree."""
    import jax.numpy as jnp
    sd = {k: v.detach().numpy() for k, v in module.state_dict().items()}
    n = sum(k.startswith('pts_linears.') and k.endswith('weight') for k in sd)

    def dense(prefix):
        return {'w': jnp.asarray(sd[f'{prefix}.weight'].T),
                'b': jnp.asarray(sd[f'{prefix}.bias'])}

    tree = {'pts_linears': [dense(f'pts_linears.{i}') for i in range(n)],
            'out': dense('output_linear')}
    if 'fc_c.0.weight' in sd:
        tree['fc_c'] = [dense(f'fc_c.{i}') for i in range(n)]
    if 'embedder._B' in sd:
        tree['embed_b'] = jnp.asarray(sd['embedder._B'])
    return tree


def _moved(before: dict, after: dict) -> dict:
    """{decoder: largest |after - before| over its parameters}."""
    import numpy as np
    return {k: max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
                   for a, b in zip(before[k], after[k]))
            for k in sorted(before)}


def _config(demo: bool) -> dict:
    if demo:
        from nice_slam_tpu_torch.tools.bench_demo import demo_config
        return demo_config(500)
    from tests.util import make_test_cfg
    return make_test_cfg(n_frames=5)


def first_frame(run: str, seed: int, out: str, demo: bool = False,
                volumes: bool = False) -> dict:
    import numpy as np

    cfg = _config(demo)
    losses = {}
    if run in ('torch', 'torch_from_jax'):
        import torch

        from nice_slam_tpu_torch.engine import slam as tslam
        slam = tslam.SlamSystem(cfg, device='cpu', seed=seed, output=out)
        if run == 'torch_from_jax':
            import jax
            jax.config.update('jax_platforms', 'cpu')
            from nice_slam_tpu.engine.slam import SlamSystem as JSlam
            from nice_slam_tpu_torch.models.convert import decoders_from_numpy
            j = JSlam(cfg, nice=True, output=out, seed=seed)
            decs = decoders_from_numpy(
                jax.tree_util.tree_map(np.asarray,
                                       {**j.opt_dec, **j.frozen_dec}),
                slam.dcfg)
            slam.decoders.load_state_dict(decs.state_dict())
            if volumes:
                with torch.no_grad():
                    for name, g in slam.grids.items():
                        g.copy_(torch.from_numpy(np.asarray(j.grids[name])))

        def params():
            return {k: [p.detach().numpy().copy()
                        for p in slam.decoders[k].parameters()]
                    for k in slam.decoders}
        map_step = tslam.map_step

        def logged(*args, **kwargs):
            cams, ls = map_step(*args, **kwargs)
            losses.setdefault('first', float(ls[0]))
            losses.setdefault('last', float(ls[-1]))
            return cams, ls

        tslam.map_step = logged
        before = params()
        try:
            _, color, depth, c2w = slam.frame_reader[0]
            slam.estimate_c2w[0] = c2w
            slam.map_frame(0, color, depth, c2w, first=True)
        finally:
            tslam.map_step = map_step
        return {**losses, 'moved': _moved(before, params())}

    import jax
    jax.config.update('jax_platforms', 'cpu')
    from nice_slam_tpu.engine.slam import SlamSystem as JSlam
    j = JSlam(cfg, nice=True, output=out, seed=seed)
    if run == 'jax_from_torch':
        from nice_slam_tpu_torch.engine.slam import SlamSystem as TSlam
        t = TSlam(cfg, device='cpu', seed=seed, output=out)
        for store in (j.opt_dec, j.frozen_dec):
            for k in store:
                store[k] = torch_tree(t.decoders[k])
        if volumes:
            import jax.numpy as jnp
            j.grids = {name: jnp.asarray(g.detach().numpy())
                       for name, g in t.grids.items()}

    def params():
        return {k: [np.asarray(x) for x in jax.tree_util.tree_leaves(v)]
                for k, v in {**j.opt_dec, **j.frozen_dec}.items()}
    before = params()
    _, color, depth, c2w = j.frame_reader[0]
    j.estimate_c2w[0] = c2w
    j.gt_c2w[0] = c2w
    import io
    from contextlib import redirect_stdout
    j.verbose = True
    buf = io.StringIO()
    with redirect_stdout(buf):
        j.map_frame(0, color, depth, c2w, first=True)
    line = next(l for l in buf.getvalue().splitlines()
                if l.startswith('Mapping frame 0'))
    first, last = line.split('loss ')[1].split(' (')[0].split(' -> ')
    return {'first': float(first), 'last': float(last),
            'moved': _moved(before, params())}


def orbit(seed: int, out: str) -> dict:
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    from nice_slam_tpu_torch.eval.recon import calc_3d_metric
    from nice_slam_tpu_torch.io.datasets import synthetic_gt_mesh
    from nice_slam_tpu_torch.mesh.mesher import load_ply
    from tests.util import make_test_cfg
    cfg = make_test_cfg(n_frames=16)
    cfg['synthetic']['step'] = 0.4
    cfg['tracking']['gt_camera'] = True
    cfg['mapping'].update(every_frame=2, keyframe_every=2,
                          mapping_window_size=5, iters=40)
    cfg['meshing']['resolution'] = 96
    SlamSystem(cfg, device='cpu', seed=seed, output=out).run()
    gt_v, gt_t = synthetic_gt_mesh(cfg['synthetic']['box'], resolution=128)
    try:
        rec_v, rec_t = load_ply(os.path.join(out, 'mesh', 'final_mesh.ply'))
        return calc_3d_metric(rec_v, rec_t, gt_v, gt_t, align=False,
                              n_samples=50000)
    except (OSError, ValueError) as e:
        return {'error': str(e)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('--seeds', type=int, nargs='+', default=[0, 1, 2])
    ap.add_argument('--runs', nargs='+', default=['torch', 'jax'],
                    choices=('torch', 'jax', 'jax_from_torch',
                             'torch_from_jax'))
    ap.add_argument('--orbit', action='store_true')
    ap.add_argument('--demo', action='store_true',
                    help='the Demo budget at 480x640, not the test scene')
    ap.add_argument('--volumes', action='store_true',
                    help='the swapped runs carry the volumes across too')
    args = ap.parse_args()
    import torch
    torch.set_num_threads(2)
    for seed in args.seeds:
        for run in (['torch'] if args.orbit else args.runs):
            with tempfile.TemporaryDirectory() as out:
                res = (orbit(seed, out) if args.orbit
                       else first_frame(run, seed, out, args.demo,
                                        args.volumes))
            print(json.dumps({'seed': seed, 'run': run, **res}), flush=True)


if __name__ == '__main__':
    main()
