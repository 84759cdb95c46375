"""The port's slice on recorded data, end to end on the CPU: the analytic
scene written in Replica format by the port's writer, read back by
`SlamSystem(device='cpu', input_folder=...)`, tracked and mapped, then
scored by the port's tools (nice_slam_tpu_torch/tools/) -- each against
the JAX package's counterpart on the same files.

Held: the frames the port's SlamSystem receives equal the JAX
SlamSystem's (the codecs are bit-equal to cv2, tests/test_torch_codecs.py);
the ATE inside tests/test_torch_slam.py's bars (largest per-frame error
< 2 cm, mean < 1 cm; seed 4, ROADMAP §3); `eval_ate` prints the in-process
ATE; `cull_mesh` keeps the JAX tool's faces, `eval_recon -3d` prints the
JAX tool's numbers and `prep_own_data` writes the JAX tool's config, on the
same inputs; the port's fixture tool writes the JAX tool's scene config."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from tests.util import make_test_cfg

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 6


def _jax_tool(name):
    sys.path.insert(0, os.path.join(REPO, 'tools'))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def _run_jax_main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, 'argv', [module.__file__] + argv)
    module.main()


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """The port's run on a Replica-format directory: (cfg path, the
    system, its output directory, the data directory)."""
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    from nice_slam_tpu_torch.tools.make_fixture_dataset import write_scene
    root = tmp_path_factory.mktemp('disk')
    data, out = str(root / 'data'), str(root / 'out')
    cfg = write_scene(make_test_cfg(n_frames=N), 'replica', data)
    cfg['data']['output'] = out
    path = str(root / 'scene.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    cfg['data']['input_folder'] = ''     # the argument must win
    slam = SlamSystem(cfg, device='cpu', seed=4, output=out,
                      input_folder=data)
    slam.run()
    return path, slam, out, data


def test_the_slice_tracks_from_disk(run):
    _, slam, out, _ = run
    assert slam.frame_reader.name == 'replica' and slam.n_img == N
    t_err = np.linalg.norm(
        slam.estimate_c2w[:, :3, 3] - slam.gt_c2w[:, :3, 3], axis=-1)
    assert np.max(t_err) < 0.02, t_err
    assert np.mean(t_err) < 0.01, t_err
    summary = slam.timers.summary()
    assert summary['frames_tracked'] == N and summary['read_s'] > 0
    assert summary['prefetch_wait_s'] >= 0
    assert os.listdir(os.path.join(out, 'mesh')) == ['final_mesh.ply']


def test_frames_match_the_jax_slam_system(run, tmp_path):
    from nice_slam_tpu.engine.slam import SlamSystem as JaxSlam
    path, slam, _, data = run
    with open(path) as f:
        cfg = yaml.safe_load(f)
    jslam = JaxSlam(cfg, input_folder=data, output=str(tmp_path))
    assert jslam.n_img == slam.n_img
    for i in range(N):
        for got, want in zip(slam.frame_reader[i], jslam.frame_reader[i]):
            np.testing.assert_array_equal(got, want)


def test_eval_ate_cli_prints_the_in_process_ate(run):
    from nice_slam_tpu_torch.eval.ate import evaluate_ate
    path, slam, out, _ = run
    res = subprocess.run(
        [sys.executable, '-m', 'nice_slam_tpu_torch.tools.eval_ate', path,
         '--output', out], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, 'OMP_NUM_THREADS': '1'})
    assert res.returncode == 0, res.stderr
    printed = dict(line.split(': ') for line in res.stdout.splitlines())
    want = evaluate_ate(slam.estimate_c2w, slam.gt_c2w)
    assert printed['compared_pose_pairs'] == str(N)
    for key in ('rmse', 'mean', 'max'):
        k = f'absolute_translational_error.{key}'
        assert printed[k] == f'{want[k]:.6f}'


@pytest.fixture(scope='module')
def gt_mesh(run):
    """The scene's ground-truth mesh (walls and obstacles) as a PLY."""
    from nice_slam_tpu_torch.io.datasets import synthetic_gt_mesh
    from nice_slam_tpu_torch.mesh.mesher import save_ply
    path, _, out, _ = run
    with open(path) as f:
        box = yaml.safe_load(f)['synthetic']['box']
    gt = os.path.join(os.path.dirname(out), 'gt.ply')
    save_ply(gt, *synthetic_gt_mesh(box, resolution=48))
    return gt


def test_cull_mesh_keeps_the_jax_tools_faces(run, gt_mesh, tmp_path,
                                             monkeypatch):
    from nice_slam_tpu_torch.mesh.mesher import load_ply
    from nice_slam_tpu_torch.tools import cull_mesh
    path = run[0]
    monkeypatch.chdir(REPO)
    mesh = gt_mesh
    mine, theirs = str(tmp_path / 'port.ply'), str(tmp_path / 'jax.ply')
    cull_mesh.main([path, '--input_mesh', mesh, '--output_mesh', mine])
    _run_jax_main(_jax_tool('cull_mesh'),
                  [path, '--input_mesh', mesh, '--output_mesh', theirs],
                  monkeypatch)
    (pv, pt), (jv, jt) = load_ply(mine), load_ply(theirs)
    assert 0 < len(pt) < len(load_ply(mesh)[1])
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pt, jt)


def test_eval_recon_prints_the_jax_tools_numbers(run, gt_mesh, capsys,
                                                 monkeypatch):
    from nice_slam_tpu_torch.tools import eval_recon
    out = run[2]
    argv = ['--rec_mesh', os.path.join(out, 'mesh', 'final_mesh.ply'),
            '--gt_mesh', gt_mesh, '-3d']
    capsys.readouterr()
    eval_recon.main(argv)
    mine = capsys.readouterr().out
    _run_jax_main(_jax_tool('eval_recon'), argv, monkeypatch)
    theirs = capsys.readouterr().out
    assert mine == theirs
    assert 'accuracy_cm' in mine


def test_prep_own_data_writes_the_jax_tools_config(tmp_path, monkeypatch):
    from nice_slam_tpu_torch.io.codecs import write_png
    from nice_slam_tpu_torch.tools import prep_own_data
    folder = tmp_path / 'capture'
    (folder / 'depth').mkdir(parents=True)
    k = [[300.0, 0, 0], [0, 310.0, 0], [39.5, 29.5, 1]]   # column-major
    (folder / 'intrinsic.json').write_text(json.dumps(
        {'width': 80, 'height': 60,
         'intrinsic_matrix': [v for col in k for v in col]}))
    rng = np.random.default_rng(0)
    for i in range(12):
        write_png(str(folder / 'depth' / f'{i:05d}.png'),
                  rng.integers(0, 9000, (60, 80)).astype(np.uint16))
    mine, theirs = tmp_path / 'port.yaml', tmp_path / 'jax.yaml'
    prep_own_data.main(['--folder', str(folder), '--output_config',
                        str(mine)])
    _run_jax_main(_jax_tool('prep_own_data'),
                  ['--folder', str(folder), '--output_config', str(theirs)],
                  monkeypatch)
    assert yaml.safe_load(mine.read_text()) == yaml.safe_load(
        theirs.read_text())


def test_fixture_tool_writes_the_jax_tools_config(tmp_path):
    from nice_slam_tpu_torch.io.datasets import get_dataset
    from nice_slam_tpu_torch.tools import make_fixture_dataset as ptool
    from nice_slam_tpu_torch.utils.config import load_config
    jtool = _jax_tool('make_fixture_dataset')
    for kind in ('tumrgbd', 'replica'):
        dirs = {name: str(tmp_path / f'{kind}_{name}')
                for name in ('port', 'jax')}
        ptool.main([kind, dirs['port'], '--frames', '3', '--height', '30',
                    '--width', '40'])
        frames = jtool.make_frames(3, 30, 40, 20.0, 20.0, 19.5, 14.5)
        jtool.write_dataset(kind, dirs['jax'], frames, 30, 40, 20.0, 20.0,
                            19.5, 14.5)
        jtool.write_config(kind, dirs['jax'], frames, 30, 40, 20.0, 20.0,
                           19.5, 14.5)
        cfgs = {}
        for name, d in dirs.items():
            with open(os.path.join(d, 'config.yaml')) as f:
                cfgs[name] = yaml.safe_load(f)
            cfgs[name].pop('data')
        assert cfgs['port'] == cfgs['jax']
        cfg = load_config(os.path.join(dirs['port'], 'config.yaml'))
        assert len(get_dataset(cfg)) == 3
