"""The port's pretrained-decoder export (nice_slam_tpu_torch/models/
pretrain.py `save_torch_pretrain`) and decoder pretraining tool
(nice_slam_tpu_torch/tools/pretrain_decoders.py) against the JAX
package's: blobs written by either package load into the other bit for
bit, with the same keys in the reference layout; the tool writes loadable
blobs; and its private copy of the small config is the test suite's."""

import os

import jax
import pytest
import torch

from nice_slam_tpu.models import decoders as jd
from nice_slam_tpu.models import pretrain as jp
from nice_slam_tpu_torch.models import decoders as td
from nice_slam_tpu_torch.models import pretrain as tp
from nice_slam_tpu_torch.models.convert import decoders_from_numpy
from tests.test_torch_util import tree_np
from tests.util import make_test_cfg

torch.set_num_threads(2)


def _port_decoders(seed: int, coarse: bool = True):
    return td.init_nice_decoders(
        td.DecoderConfig(coarse=coarse),
        generator=torch.Generator().manual_seed(seed), device='cpu')


def _assert_same(got: torch.nn.Module, want: torch.nn.Module, name: str):
    got, want = got.state_dict(), want.state_dict()
    assert set(got) == set(want), name
    for key in want:
        assert torch.equal(got[key], want[key]), f'{name}.{key}'


def _paths(tmp_path, tag):
    return str(tmp_path / f'{tag}_coarse.pt'), str(tmp_path / f'{tag}_mf.pt')


def test_port_blobs_load_into_jax_bit_for_bit(tmp_path):
    decs = _port_decoders(3)
    coarse_p, mf_p = _paths(tmp_path, 'port')
    tp.save_torch_pretrain(decs, coarse_p, mf_p)
    fresh = jd.init_nice_decoders(jax.random.PRNGKey(42), jd.DecoderConfig())
    loaded = jp.load_torch_pretrain(
        fresh, {'coarse': coarse_p, 'middle_fine': mf_p}, coarse=True)
    back = decoders_from_numpy(tree_np(loaded), td.DecoderConfig())
    for name in ('middle', 'fine', 'coarse'):
        _assert_same(back[name], decs[name], name)
    # the color decoder is not in the blobs
    _assert_same(back['color'], decoders_from_numpy(
        tree_np(fresh), td.DecoderConfig())['color'], 'color')


def test_jax_blobs_load_into_port_bit_for_bit(tmp_path):
    params = jd.init_nice_decoders(jax.random.PRNGKey(7), jd.DecoderConfig())
    coarse_p, mf_p = _paths(tmp_path, 'jax')
    jp.save_torch_pretrain(params, coarse_p, mf_p)
    decs = _port_decoders(0)
    color = {k: v.clone() for k, v in decs['color'].state_dict().items()}
    tp.load_torch_pretrain(decs, {'coarse': coarse_p, 'middle_fine': mf_p},
                           coarse=True)
    want = decoders_from_numpy(tree_np(params), td.DecoderConfig())
    for name in ('middle', 'fine', 'coarse'):
        _assert_same(decs[name], want[name], name)
    for key, v in decs['color'].state_dict().items():
        assert torch.equal(v, color[key]), key


def test_both_exports_have_the_same_keys(tmp_path):
    params = jd.init_nice_decoders(jax.random.PRNGKey(1), jd.DecoderConfig())
    jc, jmf = _paths(tmp_path, 'jax')
    jp.save_torch_pretrain(params, jc, jmf)
    tc, tmf = _paths(tmp_path, 'port')
    tp.save_torch_pretrain(_port_decoders(1), tc, tmf)
    for j, t in ((jc, tc), (jmf, tmf)):
        jm = torch.load(j, map_location='cpu', weights_only=True)['model']
        tm = torch.load(t, map_location='cpu', weights_only=True)['model']
        assert sorted(jm) == sorted(tm)
        for key in jm:
            assert jm[key].shape == tm[key].shape and \
                jm[key].dtype == tm[key].dtype, key
    mf = torch.load(tmf, map_location='cpu', weights_only=True)['model']
    # middle under the reference's 'decoder.coarse.' prefix
    assert {k.split('.')[1] for k in mf} == {'coarse', 'fine'}


def test_coarse_path_none_writes_middle_fine_only(tmp_path):
    decs = _port_decoders(2)
    mf_p = str(tmp_path / 'middle_fine.pt')
    tp.save_torch_pretrain(decs, None, mf_p)
    assert os.listdir(tmp_path) == ['middle_fine.pt']
    # decoders without a coarse MLP: no coarse blob either
    tp.save_torch_pretrain(_port_decoders(2, coarse=False),
                           str(tmp_path / 'coarse.pt'), mf_p)
    assert os.listdir(tmp_path) == ['middle_fine.pt']
    fresh = _port_decoders(9)
    tp.load_torch_pretrain(fresh, {'middle_fine': mf_p}, coarse=True)
    for name in ('middle', 'fine'):
        _assert_same(fresh[name], decs[name], name)


def _initial_decoders(output: str, seed: int, **kw):
    """The decoders a pretraining run starts from (its SlamSystem's)."""
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    from nice_slam_tpu_torch.tools._small_config import small_config
    return SlamSystem(small_config(**kw), device='cpu', seed=seed,
                      output=output).decoders


def test_tool_writes_loadable_blobs(tmp_path, capsys):
    """The tool at a small size on the CPU: its blobs hold the trained
    decoders, which moved from their initialization."""
    from nice_slam_tpu_torch.tools import pretrain_decoders
    pretrain_decoders.main([str(tmp_path / 'blobs'), '--frames', '3',
                            '--iters-first', '60', '--device', 'cpu'])
    blobs = tmp_path / 'blobs'
    assert sorted(os.listdir(blobs)) == ['coarse.pt', 'middle_fine.pt']
    assert 'wrote' in capsys.readouterr().out
    init = _initial_decoders(str(tmp_path / 'init'), 4, n_frames=3, h=120,
                             w=160)
    loaded = _port_decoders(0)
    tp.load_torch_pretrain(loaded, {
        'coarse': str(blobs / 'coarse.pt'),
        'middle_fine': str(blobs / 'middle_fine.pt')}, coarse=True)
    for name in ('middle', 'fine'):
        sd, sd0 = loaded[name].state_dict(), init[name].state_dict()
        assert all(torch.isfinite(v).all() for v in sd.values()), name
        assert not torch.equal(sd['output_linear.weight'],
                               sd0['output_linear.weight']), name


def test_a_diverged_first_frame_raises():
    """Seed 0 of the port's draws diverges on this scene's first frame:
    the decoders would come back untrained, so the tool raises."""
    from nice_slam_tpu_torch.tools.pretrain_decoders import train_decoders
    with pytest.raises(RuntimeError, match='did not move'):
        train_decoders(n_frames=1, h=60, w=80, iters_first=40, seed=0,
                       device='cpu')


@pytest.mark.parametrize('kw', [
    {}, {'n_frames': 3, 'h': 120, 'w': 160},
    {'nice': False, 'coarse': False, 'frustum': False, 'ba': True}])
def test_private_small_config_is_make_test_cfg(kw):
    from nice_slam_tpu_torch.tools._small_config import small_config
    assert small_config(**kw) == make_test_cfg(**kw)
