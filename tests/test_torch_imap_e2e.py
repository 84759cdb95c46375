"""iMAP* mode of the port's SlamSystem end to end on the CPU: the port's
copy of tests/test_engine.py's iMAP* run (the same scene, budgets and
bar), and a checkpoint and resume of an iMAP* run (the single decoder,
no volumes), with the mapping-window log of
`mapping.save_selected_keyframes_info` kept across it."""

import os

import numpy as np
import torch

from tests.util import make_test_cfg

torch.set_num_threads(2)


def _imap_cfg(n_frames, **mapping):
    cfg = make_test_cfg(n_frames=n_frames, nice=False, coarse=False)
    cfg['rendering']['N_importance'] = 4
    cfg['rendering']['N_surface'] = 8
    cfg['mapping'].update(iters_first=150, iters=30, **mapping)
    cfg['tracking']['iters'] = 15
    return cfg


def test_imap_end_to_end_run(tmp_path):
    """iMAP* (single MLP, density rendering, N_importance resampling,
    StepLR decay, free-space regulation) over five frames under strict,
    held to the JAX test's bar: largest per-frame error < 0.08 m."""
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    slam = SlamSystem(_imap_cfg(5), nice=False, device='cpu',
                      output=str(tmp_path))
    assert slam.model.kind == 'imap' and slam.grids == {}
    assert list(slam.decoders) == ['imap'] and not slam.coarse_enabled
    slam.run()
    summary = slam.timers.summary()
    assert summary['frames_tracked'] == 5
    # the first map, then one normal call of 3 outer iterations at frame 4
    assert [(i, k, n) for i, k, n, _ in slam.timers.maps] == [
        (0, 'first', 150), (4, 'normal', 30)]
    t_err = np.linalg.norm(
        slam.estimate_c2w[:, :3, 3] - slam.gt_c2w[:, :3, 3], axis=-1)
    assert np.max(t_err) < 0.08, t_err
    assert len((tmp_path / 'metrics.jsonl').read_text().splitlines()) == 5
    assert os.listdir(tmp_path / 'ckpts') == ['00004.ckpt']


def test_imap_checkpoint_and_resume(tmp_path):
    """Five frames, a checkpoint with exact images, a restore into a
    fresh system, the rest of the run: the same poses, decoder, random
    streams and window log as the run that never stopped; and the last
    checkpoint restores the finished run's decoder."""
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    from nice_slam_tpu_torch.utils.ckpt import load_checkpoint, save_checkpoint
    cfg = make_test_cfg(n_frames=7, h=30, w=40, nice=False, coarse=False)
    cfg['rendering']['N_importance'] = 4
    cfg['mapping'].update(iters_first=40, iters=9,
                          save_selected_keyframes_info=True)
    cfg['tracking']['iters'] = 5

    ref = SlamSystem(cfg, nice=False, device='cpu', seed=3,
                     output=str(tmp_path / 'a'))
    ref.run()
    assert sorted(ref.selected_keyframes) == [0, 4, 6]
    assert [kf['idx'] for kf in ref.selected_keyframes[4]] == [0, 4]

    part = SlamSystem(cfg, nice=False, device='cpu', seed=3,
                      output=str(tmp_path / 'b'))
    for i in range(5):
        part.step(i)
    path = str(tmp_path / 'state.ckpt')
    save_checkpoint(path, part.checkpoint_state(), compress_images=False)

    res = SlamSystem(cfg, nice=False, device='cpu', seed=7,
                     output=str(tmp_path / 'c'))
    assert res.restore(load_checkpoint(path)) == 5
    assert sorted(res.selected_keyframes) == [0, 4]
    res.run(start=5)

    assert np.array_equal(res.estimate_c2w, ref.estimate_c2w), (
        np.abs(res.estimate_c2w - ref.estimate_c2w).max())
    want = ref.decoders.state_dict()
    for k, v in res.decoders.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert torch.equal(res.generator.get_state(), ref.generator.get_state())
    assert res.np_rng.bit_generator.state == ref.np_rng.bit_generator.state
    for idx, window in ref.selected_keyframes.items():
        got = res.selected_keyframes[idx]
        assert [kf['idx'] for kf in got] == [kf['idx'] for kf in window]
        for a, b in zip(got, window):
            np.testing.assert_array_equal(a['est_c2w'], b['est_c2w'])

    last = load_checkpoint(str(tmp_path / 'a' / 'ckpts' / '00006.ckpt'))
    assert last['grids'] == {} and list(last['decoders']) == ['imap']
    fresh = SlamSystem(cfg, nice=False, device='cpu', seed=9,
                       output=str(tmp_path / 'd'))
    assert fresh.restore(last) == 7
    for k, v in fresh.decoders.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert np.array_equal(fresh.estimate_c2w, ref.estimate_c2w)


def test_cli_imap_runs_on_cpu(tmp_path):
    """`python -m nice_slam_tpu_torch CONFIG --imap` layers the config over
    configs/imap.yaml and runs iMAP*; --nice and --imap exclude each
    other."""
    import subprocess
    import sys

    import yaml
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = make_test_cfg(n_frames=3, h=30, w=40, nice=False, coarse=False)
    cfg['mapping'].update(iters_first=8, iters=3)
    cfg['tracking'].update(iters=3)
    # left to the base config: imap.yaml's 12 importance samples
    del cfg['rendering']['N_importance']
    path = tmp_path / 'tiny.yaml'
    path.write_text(yaml.safe_dump(cfg))
    out = tmp_path / 'out'
    env = {**os.environ, 'OMP_NUM_THREADS': '2'}
    run = lambda *a: subprocess.run(
        [sys.executable, '-m', 'nice_slam_tpu_torch', str(path), *a],
        cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    res = run('--imap', '--device', 'cpu', '--output', str(out))
    assert res.returncode == 0, res.stderr
    from nice_slam_tpu_torch.utils.ckpt import load_checkpoint
    state = load_checkpoint(str(out / 'ckpts' / '00002.ckpt'))
    assert list(state['decoders']) == ['imap'] and state['grids'] == {}
    assert np.load(out / 'trajectory.npz')['estimate_c2w'].shape == (3, 4, 4)
    # imap.yaml's bfloat16 decoder products are honoured: no warning
    assert 'decoder_matmul_precision' not in res.stderr
    res = run('--imap', '--nice', '--device', 'cpu')
    assert res.returncode != 0 and 'not allowed with' in res.stderr


def test_imap_runs_under_loose(tmp_path):
    """iMAP* under the overlapped schedule: mapping rounds every
    every_frame // 2 frames on the mapping thread, the tracker adopting
    their snapshots (a copy of the one decoder, no volumes)."""
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    cfg = make_test_cfg(n_frames=6, h=30, w=40, nice=False, coarse=False)
    cfg['sync_method'] = 'loose'
    cfg['debug'] = {}               # the invariant checks wait for rounds
    cfg['rendering']['N_importance'] = 4
    cfg['mapping'].update(iters_first=60, iters=9)
    cfg['tracking']['iters'] = 8
    slam = SlamSystem(cfg, nice=False, device='cpu', seed=3,
                      output=str(tmp_path))
    slam.run()
    assert [(i, k) for i, k, *_ in slam.timers.maps] == [
        (0, 'first'), (2, 'normal'), (4, 'normal'), (5, 'normal')]
    assert slam.refreshes['consumed'] + slam.refreshes['forced'] >= 1
    decoders, grids = slam._tracking_grids
    assert grids == {} and decoders is not slam.decoders
    t_err = np.linalg.norm(
        slam.estimate_c2w[:, :3, 3] - slam.gt_c2w[:, :3, 3], axis=-1)
    assert np.max(t_err) < 0.08, t_err
