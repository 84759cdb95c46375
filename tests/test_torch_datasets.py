"""The port's dataset loaders (nice_slam_tpu_torch/io/datasets.py) against
the JAX package's on the same directories, written by the JAX package's
fixture tool (tools/make_fixture_dataset.py, cv2's encoders) and by the
port's (nice_slam_tpu_torch/tools/make_fixture_dataset.py, the port's
encoders), in all five formats: Replica, ScanNet (with an invalid-pose
frame, and with color twice the depth's size), TUM RGB-D (plain, and with
freiburg1_desk's distortion, a crop_size and a crop_edge), CoFusion and
Azure; and eval/ate.associate.

Tolerances: frame counts, TUM's associated paths and depth equal; poses
within 1e-12 (non-finite entries where the JAX loader has them); color
bit-equal (the codecs' bound, PNG and JPEG alike, tests/test_torch_
codecs.py), except where the color is resized to the depth's size (the
resize's 1e-6)."""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'tools'))

import make_fixture_dataset as jtool  # noqa: E402
from nice_slam_tpu.io.datasets import (  # noqa: E402
    get_dataset as jax_get_dataset)
from nice_slam_tpu_torch.io.datasets import get_dataset  # noqa: E402
from nice_slam_tpu_torch.tools import (  # noqa: E402
    make_fixture_dataset as ptool)

H, W = 60, 80
FX = FY = 0.5 * W
CX, CY = 0.5 * W - 0.5, 0.5 * H - 0.5
N = 6
KINDS = ('replica', 'scannet', 'tumrgbd', 'cofusion', 'azure')
FR1_DESK = [0.2624, -0.9531, -0.0054, 0.0026, 1.1633]


@pytest.fixture(scope='module')
def frames():
    return ptool.make_frames(N, H, W, FX, FY, CX, CY)


def _cfg(kind, folder, **cam):
    return {'dataset': kind, 'scale': 1.0,
            'cam': {'H': H, 'W': W, 'fx': FX, 'fy': FY, 'cx': CX, 'cy': CY,
                    'png_depth_scale': ptool.DEPTH_SCALE[kind],
                    'crop_edge': 0, **cam},
            'data': {'input_folder': folder}}


def _assert_same(port, jax, color_atol=0.0):
    assert len(port) == len(jax)
    for i in range(len(jax)):
        pi, pc, pd, pp = port[i]
        ji, jc, jd, jp = jax[i]
        assert pi == ji
        assert pc.dtype == jc.dtype == np.float32 and pc.shape == jc.shape
        assert pd.dtype == jd.dtype and pd.shape == jd.shape
        np.testing.assert_array_equal(pd, jd)
        np.testing.assert_allclose(pp, jp, rtol=0, atol=1e-12)
        if color_atol:
            np.testing.assert_allclose(pc, jc, rtol=0, atol=color_atol)
        else:
            np.testing.assert_array_equal(pc, jc)


def test_the_port_tool_renders_the_jax_tools_frames(frames):
    for (pc, pd, pp), (jc, jd, jp) in zip(
            frames, jtool.make_frames(N, H, W, FX, FY, CX, CY)):
        np.testing.assert_array_equal(pc, jc)
        np.testing.assert_array_equal(pd, jd)
        np.testing.assert_array_equal(pp, jp)


@pytest.mark.parametrize('writer', ['jax', 'port'])
@pytest.mark.parametrize('kind', KINDS)
def test_loader_matches_jax(kind, writer, frames, tmp_path):
    tool = jtool if writer == 'jax' else ptool
    folder = str(tmp_path)
    extra = {'scannet_nan_frame': 3} if kind == 'scannet' else {}
    tool.write_dataset(kind, folder, frames, H, W, FX, FY, CX, CY, **extra)
    port = get_dataset(_cfg(kind, folder))
    jax = jax_get_dataset(_cfg(kind, folder))
    assert len(port) == N
    _assert_same(port, jax)
    if kind == 'tumrgbd':
        assert port.color_paths == jax.color_paths
        assert port.depth_paths == jax.depth_paths
    if kind == 'scannet':
        assert not np.isfinite(port[3][3]).all()
        assert np.isfinite(port[2][3]).all()


def test_tum_with_distortion_crop_size_and_crop_edge(frames, tmp_path):
    folder = str(tmp_path)
    jtool.write_dataset('tumrgbd', folder, frames, H, W, FX, FY, CX, CY)
    cfg = _cfg('tumrgbd', folder, distortion=FR1_DESK, crop_size=[48, 64],
               crop_edge=2)
    port, jax = get_dataset(cfg), jax_get_dataset(cfg)
    assert port[0][1].shape == (44, 60, 3) and port[0][2].shape == (44, 60)
    _assert_same(port, jax)


def test_scannet_color_twice_the_depth_size(frames, tmp_path):
    folder = str(tmp_path)
    ptool.write_dataset('scannet', folder, frames, H, W, FX, FY, CX, CY,
                        color_upscale=2)
    port = get_dataset(_cfg('scannet', folder))
    _assert_same(port, jax_get_dataset(_cfg('scannet', folder)),
                 color_atol=1e-6)
    assert port[0][1].shape == (H, W, 3)


@pytest.mark.parametrize('kind', KINDS)
def test_port_writer_round_trip(kind, frames, tmp_path):
    """The port's writer read back by the port's loader holds the source
    frames to tests/test_dataset_fixtures.py's bars."""
    folder = str(tmp_path)
    ptool.write_dataset(kind, folder, frames, H, W, FX, FY, CX, CY)
    ds = get_dataset(_cfg(kind, folder))
    assert len(ds) == N
    lossy = kind != 'cofusion'
    for i in (0, N - 1):
        _, color, depth, pose = ds[i]
        src_color, src_depth, src_pose = frames[i]
        assert np.mean(np.abs(color - src_color)) < (0.08 if lossy
                                                     else 0.01) / 4
        assert np.max(np.abs(depth - src_depth)) < (
            2.0 / ptool.DEPTH_SCALE[kind] + 1e-4)
        if kind in ('replica', 'scannet', 'azure'):
            np.testing.assert_allclose(pose, src_pose.astype(np.float32),
                                       atol=1e-6)


@pytest.mark.parametrize('kind', KINDS)
def test_empty_folder_raises_naming_it(kind, tmp_path):
    if kind == 'tumrgbd':
        for name in ('rgb.txt', 'depth.txt', 'groundtruth.txt'):
            (tmp_path / name).write_text('# header\n0 x\n'
                                         if name != 'groundtruth.txt'
                                         else '# header\n100 0 0 0 0 0 0 1\n')
        match = 'within 0.08 s'
    else:
        match = 'no frames match'
    with pytest.raises(FileNotFoundError, match=match) as err:
        get_dataset(_cfg(kind, str(tmp_path)))
    assert str(tmp_path) in str(err.value)


def test_input_folder_overrides_the_config(frames, tmp_path):
    ptool.write_dataset('replica', str(tmp_path), frames, H, W, FX, FY, CX,
                        CY)
    ds = get_dataset(_cfg('replica', '/nonexistent'), str(tmp_path))
    assert len(ds) == N and ds.input_folder == str(tmp_path)


def test_associate_matches_jax():
    from nice_slam_tpu.eval.ate import associate as jassociate
    from nice_slam_tpu_torch.eval.ate import associate
    rng = np.random.default_rng(0)
    a = {float(t): i for i, t in enumerate(np.cumsum(rng.random(60) / 30))}
    b = {float(t): i for i, t in enumerate(np.cumsum(rng.random(70) / 35))}
    for offset, max_diff in ((0.0, 0.02), (0.01, 0.005), (-0.003, 0.05)):
        got = associate(a, b, offset, max_diff)
        assert got == jassociate(a, b, offset, max_diff)
        assert got
