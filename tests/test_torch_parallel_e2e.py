"""The port's orchestrator on two gloo CPU ranks (tests/torch_rank_pool.py):
5-frame SlamSystem runs of the test scene under `parallel.map: kf`,
`parallel.map: rays` and `parallel.track: rays` (seed 4), and one run of
`python -m nice_slam_tpu_torch` brought up from the NSTPU_* variables.

Every rank tracks every frame on its own replicated state, and the sums
over the ranks leave every rank the same bits, so the ranks' poses must be
identical; the trajectory is held to the JAX package's bound for these
runs (tests/test_distributed.py: largest translation error under 0.03 m).
Only rank 0 writes checkpoints, meshes and metrics."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

from tests.torch_rank_pool import REPO, RankPool, free_port
from tests.util import make_test_cfg


MODES = {'map-kf': {'map': 'kf'},
         'map-rays': {'map': 'rays', 'devices': 2},
         'track-rays': {'track': 'rays'}}


def _cli_procs(tmp):
    """Two `python -m nice_slam_tpu_torch` ranks under NSTPU_* with
    `parallel.map: kf` on the test scene."""
    cfg = make_test_cfg(n_frames=5)
    cfg['parallel'] = {'map': 'kf'}
    cfg['pretrained_decoders'] = {'middle_fine': '', 'coarse': ''}
    path = tmp / 'cfg.yaml'
    path.write_text(yaml.safe_dump(cfg))
    env = dict(os.environ, NSTPU_COORDINATOR=f'localhost:{free_port()}',
               NSTPU_NUM_PROCESSES='2', NSTPU_CPU_SIM='1',
               OMP_NUM_THREADS='1')
    procs = []
    for rank in range(2):
        env['NSTPU_PROCESS_ID'] = str(rank)
        procs.append(subprocess.Popen(
            [sys.executable, '-m', 'nice_slam_tpu_torch', str(path),
             '--device', 'cpu', '--seed', '4', '--output',
             str(tmp / f'out{rank}')],
            cwd=REPO, env=dict(env), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The three SlamSystem runs (a world of two ranks each) and the CLI
    run, started together and collected by the tests."""
    tmp = tmp_path_factory.mktemp('runs')
    pools = {}
    try:
        for mode, parallel in MODES.items():
            pools[mode] = RankPool(2, 'tests.torch_parallel_e2e_tasks',
                                   timeout=400.0)
            pools[mode].submit('slam_run', parallel=parallel,
                               output=str(tmp / mode))
        cli = _cli_procs(tmp)
        yield dict(pools=pools, cli=cli, tmp=tmp)
    finally:
        for p in pools.values():
            p.close()


@pytest.mark.parametrize('mode', list(MODES))
def test_two_ranks_run_slam(runs, mode):
    res = runs['pools'][mode].collect('slam_run')
    assert [r['world'] for r in res] == [2, 2]
    assert all(r['tracked'] == 5 for r in res)
    np.testing.assert_array_equal(res[0]['poses'], res[1]['poses'])
    t_err = np.linalg.norm(res[0]['poses'][:, :3, 3]
                           - res[0]['gt'][:, :3, 3], axis=-1)
    assert np.max(t_err) < 0.03, t_err
    # rank 0 wrote the run's files, rank 1 nothing (the same directory)
    assert 'metrics.jsonl' in res[0]['written']
    assert any(f.startswith('ckpts') for f in res[0]['written'])
    assert os.path.exists(runs['tmp'] / mode / 'mesh' / 'final_mesh.ply')
    assert res[1]['written'] == res[0]['written']


def test_cli_brings_ranks_up_from_nstpu_variables(runs):
    """Two `python -m nice_slam_tpu_torch` processes under NSTPU_* with
    `parallel.map: kf`: both print the same ATE, rank 0 writes the
    trajectory, rank 1 writes nothing."""
    outs = []
    for p in runs['cli']:
        out, _ = p.communicate(timeout=400)
        assert p.returncode == 0, out[-4000:]
        outs.append(out)
    done = [json.loads(line.split('INFO: done. ', 1)[1])
            for out in outs for line in out.splitlines()
            if line.startswith('INFO: done. ')]
    assert len(done) == 2
    key = 'absolute_translational_error.rmse'
    assert done[0][key] == done[1][key] and done[0][key] < 0.03
    assert 'rank 1 of 2 on cpu, backend gloo' in outs[1]
    assert (runs['tmp'] / 'out0' / 'trajectory.npz').exists()
    assert not (runs['tmp'] / 'out1').exists()
