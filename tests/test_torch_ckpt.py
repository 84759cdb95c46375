"""Checkpoints of the port's SlamSystem on the CPU (utils/ckpt.py): the
round trip, a bit-faithful resume, and --resume through the CLI (the
port's versions of tests/test_engine.py's checkpoint tests).

The resume contract is exact: with `ckpt.compress_images: false` the
resumed run's poses, grids, decoders and both random streams equal the
uninterrupted run's bit for bit, with PyTorch's deterministic algorithms
on and without them (the mapper's gather backward on the CPU is
index_add_, whose summation order does not depend on the threads).
"""

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


@pytest.fixture
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


def _small_cfg(n_frames):
    cfg = make_test_cfg(n_frames=n_frames, h=30, w=40)
    cfg['meshing']['resolution'] = 24
    return cfg


def test_save_load_round_trip_of_numpy_trees(tmp_path):
    from nice_slam_tpu_torch.utils.ckpt import (
        latest_checkpoint, load_checkpoint, save_checkpoint)
    state = {'grids': {'fine': torch.arange(6.0).reshape(3, 2)},
             'keyframes': [{'idx': 0, 'color': np.full((2, 2, 3), 0.1, np.float32),
                            'depth': np.ones((2, 2), np.float32)}],
             'mapping_idx': 4, 'poses': (np.eye(4), [1, 2])}
    assert latest_checkpoint(str(tmp_path)) is None
    for name, compress in (('00004.ckpt', True), ('00012.ckpt', False)):
        save_checkpoint(str(tmp_path / name), state, compress_images=compress)
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / '00012.ckpt')
    assert not any(f.endswith('.tmp') for f in os.listdir(tmp_path))
    exact = load_checkpoint(str(tmp_path / '00012.ckpt'))
    lossy = load_checkpoint(str(tmp_path / '00004.ckpt'))
    np.testing.assert_array_equal(exact['grids']['fine'],
                                  np.arange(6.0).reshape(3, 2))
    assert exact['keyframes'][0]['color'].dtype == np.float32
    np.testing.assert_array_equal(exact['keyframes'][0]['color'],
                                  np.float32(0.1))
    # float16 images: 0.1 comes back within half a float16 step
    assert lossy['keyframes'][0]['color'].dtype == np.float32
    np.testing.assert_allclose(lossy['keyframes'][0]['color'], 0.1,
                               atol=5e-5)
    assert exact['mapping_idx'] == 4 and exact['poses'][1] == [1, 2]


def test_checkpoint_roundtrip(tmp_path):
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    from nice_slam_tpu_torch.utils.ckpt import load_checkpoint, save_checkpoint
    cfg = make_test_cfg(n_frames=5)
    cfg['meshing']['resolution'] = 24
    slam = SlamSystem(cfg, device='cpu', seed=4, output=str(tmp_path / 'a'))
    slam.step(0)
    path = str(tmp_path / 'state.ckpt')
    save_checkpoint(path, slam.checkpoint_state())

    slam2 = SlamSystem(cfg, device='cpu', seed=9,
                       output=str(tmp_path / 'resume'))
    assert slam2.restore(load_checkpoint(path)) == 1
    assert slam2.keyframes.indices == slam.keyframes.indices
    assert slam2.coarse_keyframes.indices == slam.coarse_keyframes.indices
    for name, g in slam.grids.items():
        assert torch.equal(slam2.grids[name], g), name
    want = slam.decoders.state_dict()
    for k, v in slam2.decoders.state_dict().items():
        assert torch.equal(v, want[k]), k
    # the restored system continues: frames 1..4 tracked and mapped with a
    # bounded error
    slam2.run(start=1)
    assert slam2.timers.summary()['frames_tracked'] == 4
    t_err = np.linalg.norm(
        slam2.estimate_c2w[:, :3, 3] - slam2.gt_c2w[:, :3, 3], axis=-1)
    assert np.max(t_err) < 0.02, t_err


def test_resume_bit_faithful(tmp_path, deterministic):
    """Five frames, a checkpoint with exact images, a restore into a fresh
    system, the rest of the run: the same poses, grids, decoders and
    random streams as the run that never stopped."""
    _check_resume_bit_faithful(tmp_path)


def test_resume_bit_faithful_without_deterministic_algorithms(tmp_path):
    """The same, with PyTorch's deterministic algorithms off (as a run
    has them)."""
    assert not torch.are_deterministic_algorithms_enabled()
    _check_resume_bit_faithful(tmp_path)


def _check_resume_bit_faithful(tmp_path):
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    from nice_slam_tpu_torch.utils.ckpt import load_checkpoint, save_checkpoint
    cfg = _small_cfg(9)

    ref = SlamSystem(cfg, device='cpu', seed=4, output=str(tmp_path / 'a'))
    ref.run()

    part = SlamSystem(cfg, device='cpu', seed=4, output=str(tmp_path / 'b'))
    for i in range(5):
        part.step(i)
    path = str(tmp_path / 'state.ckpt')
    save_checkpoint(path, part.checkpoint_state(), compress_images=False)

    res = SlamSystem(cfg, device='cpu', seed=7, output=str(tmp_path / 'c'))
    assert res.restore(load_checkpoint(path)) == 5
    res.run(start=5)

    assert np.array_equal(res.estimate_c2w, ref.estimate_c2w), (
        np.abs(res.estimate_c2w - ref.estimate_c2w).max())
    for name, g in ref.grids.items():
        assert torch.equal(res.grids[name], g), name
    want = ref.decoders.state_dict()
    for k, v in res.decoders.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert [kf.idx for kf in res.keyframes.frames] == \
        [kf.idx for kf in ref.keyframes.frames]
    assert torch.equal(res.generator.get_state(), ref.generator.get_state())
    assert res.np_rng.bit_generator.state == ref.np_rng.bit_generator.state


def test_cli_resume(tmp_path):
    """--resume restarts from the newest checkpoint of --output and
    continues the run from the frame after it."""
    cfg = _small_cfg(5)
    cfg['mapping'].update(iters_first=20, iters=5, every_frame=2,
                          keyframe_every=2, ckpt_freq=2)
    cfg['tracking'].update(iters=3)
    cfg_path = tmp_path / 'tiny.yaml'
    cfg_path.write_text(yaml.safe_dump(cfg))
    out = tmp_path / 'out'
    env = {**os.environ, 'OMP_NUM_THREADS': '2'}

    def run(*extra):
        res = subprocess.run(
            [sys.executable, '-m', 'nice_slam_tpu_torch', str(cfg_path),
             '--device', 'cpu', '--output', str(out), *extra], cwd=REPO,
            env=env, capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        return res.stdout

    run()
    ckpts = sorted(os.listdir(out / 'ckpts'))
    assert ckpts == ['00002.ckpt', '00004.ckpt']
    assert sorted(os.listdir(out / 'mesh')) == ['final_mesh.ply']
    first = np.load(out / 'trajectory.npz')['estimate_c2w']
    lines = (out / 'metrics.jsonl').read_text().splitlines()
    assert len(lines) == 5

    os.remove(out / 'ckpts' / '00004.ckpt')
    stdout = run('--resume')
    assert f'resumed from {out / "ckpts" / "00002.ckpt"} at frame 3' in stdout
    assert (out / 'ckpts' / '00004.ckpt').exists()
    again = np.load(out / 'trajectory.npz')['estimate_c2w']
    # frames 0-2 come from the checkpoint, 3-4 are tracked anew
    np.testing.assert_array_equal(again[:3], first[:3])
    assert np.isfinite(again).all()
    assert len((out / 'metrics.jsonl').read_text().splitlines()) == 7
