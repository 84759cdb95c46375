"""The port's account of the JAX package's config keys
(nice_slam_tpu_torch/utils/config.py HONOURED and UNPORTED_OPTIONS): every
key the JAX package's SlamSystem and config readers read is honoured or,
for the TPU settings only, warned about; the warned ones warn once and
change nothing; `visualization.live`, the last option the port refused,
is honoured; every shipped config passes.  And
`mapping.save_selected_keyframes_info`: the port's window log against the
JAX package's window selection on the same draws, kept across a
checkpoint."""

import ast
import glob
import os
import types
import warnings

import numpy as np
import pytest
import torch

from tests.util import make_test_cfg

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# what the JAX package's SlamSystem, its config readers and its dataset
# loaders read
JAX_READERS = ('nice_slam_tpu/engine/slam.py', 'nice_slam_tpu/utils/config.py',
               'nice_slam_tpu/io/datasets.py')


def jax_config_keys(path: str) -> set[str]:
    """Dotted paths of the config keys a JAX source reads ('*' for a key
    that is not a string constant): subscripts and .get calls on `cfg`,
    `self.cfg` and the names assigned from them (`m = cfg['mapping']`),
    leaves only."""
    tree = ast.parse(open(os.path.join(REPO, path)).read())
    found = set()

    def resolve(node, env):
        if isinstance(node, ast.Name):
            return env.get(node.id)
        if (isinstance(node, ast.Attribute) and node.attr == 'cfg'
                and isinstance(node.value, ast.Name)
                and node.value.id == 'self'):
            return ''
        if isinstance(node, ast.BoolOp):          # cfg.get('x', {}) or {}
            return resolve(node.values[0], env)
        if isinstance(node, ast.Subscript):
            base, key = resolve(node.value, env), node.slice
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == 'get'):
            base, key = resolve(node.func.value, env), node.args[0]
        else:
            return None
        if base is None:
            return None
        key = (key.value if isinstance(key, ast.Constant)
               and isinstance(key.value, str) else '*')
        full = f'{base}.{key}' if base else key
        found.add(full)
        return full

    class Reads(ast.NodeVisitor):
        # `pre_cfg` is the argument SlamSystem passes cfg's
        # pretrained_decoders as
        env = {'cfg': '', 'pre_cfg': 'pretrained_decoders'}

        def visit_FunctionDef(self, node):
            saved = dict(self.env)
            self.generic_visit(node)
            self.env = saved

        def visit_Assign(self, node):
            self.visit(node.value)
            p = resolve(node.value, self.env)
            for t in node.targets:
                if isinstance(t, ast.Name):
                    if p is None:
                        self.env.pop(t.id, None)
                    else:
                        self.env[t.id] = p

        def visit_Subscript(self, node):
            resolve(node, self.env)
            self.generic_visit(node)

        def visit_Call(self, node):
            resolve(node, self.env)
            self.generic_visit(node)

    Reads().visit(tree)
    return {k for k in found if not any(o.startswith(k + '.') for o in found)}


def test_every_key_the_jax_package_reads_is_accounted_for():
    from nice_slam_tpu_torch.utils.config import HONOURED, UNPORTED_OPTIONS
    keys = set().union(*(jax_config_keys(p) for p in JAX_READERS))
    # the walk finds what it should: a sample of each kind of read
    assert {'tracking.pixels', 'mapping.stage.*.decoders_lr',
            'parallel.map', 'mapping.vis_inside_freq', 'occupancy',
            'model.decoder_matmul_precision', 'data.prefetch',
            'cam.png_depth_scale', 'cam.distortion',
            'data.input_folder'} <= keys
    assert len(keys) > 100
    assert not HONOURED & set(UNPORTED_OPTIONS)
    missing = keys - HONOURED - set(UNPORTED_OPTIONS)
    assert not missing, sorted(missing)
    for key, (_, inert, what) in UNPORTED_OPTIONS.items():
        assert what, key
    # only the TPU compile re-roll stays unported; the decoder stack's
    # precision and the session-wide one are honoured
    assert {'model.decoder_matmul_precision', 'matmul_precision'} <= HONOURED
    assert set(UNPORTED_OPTIONS) == {
        'tracking.autotune_ms', 'tracking.autotune_candidates',
        'mapping.autotune_ms_per_iter', 'mapping.autotune_candidates'}


@pytest.mark.parametrize('section, option', [
    ('visualization', {'live': True}),
])
def test_live_option_is_honoured_from_construction(tmp_path, section,
                                                   option):
    """The option the port refused until the dashboard was ported
    constructs with no warning and writes `<output>/live/`."""
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    cfg = make_test_cfg(n_frames=2)
    cfg[section] = option
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        slam = SlamSystem(cfg, device='cpu', output=str(tmp_path))
    assert slam.live is not None and slam.live.port is None
    assert os.listdir(tmp_path / 'live') == ['index.html']


def _two_frame_run(tmp_path, parallel):
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    cfg = make_test_cfg(n_frames=2)
    if parallel is not None:
        cfg['parallel'] = parallel
    slam = SlamSystem(cfg, device='cpu', seed=4, output=str(tmp_path))
    slam.run()
    return slam


@pytest.fixture(scope='module')
def parallel_none(tmp_path_factory):
    return _two_frame_run(tmp_path_factory.mktemp('none'), None)


@pytest.mark.parametrize('option', [
    {'map': 'rays'},
    {'map': 'kf', 'devices': 1},
    {'track': 'rays', 'devices': 0},
])
def test_parallel_options_are_honoured_in_a_world_of_one(
        tmp_path, parallel_none, option):
    """Each parallel backend runs; in a world of one (this process alone)
    its draws and sums are the single-device program's, so a 2-frame run
    gives bit-identical poses and map to `parallel: none`."""
    slam = _two_frame_run(tmp_path, option)
    assert slam.world.size == 1
    np.testing.assert_array_equal(slam.estimate_c2w,
                                  parallel_none.estimate_c2w)
    for name, g in slam.grids.items():
        assert torch.equal(g, parallel_none.grids[name]), name


def test_inert_values_pass_and_warned_keys_warn_once(tmp_path):
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    from nice_slam_tpu_torch.utils.config import check_options
    cfg = make_test_cfg(n_frames=2)
    cfg.update(parallel={'map': 'none', 'track': 'none', 'devices': 0},
               visualization={'live': False}, enable_vis=False,
               matmul_precision='float32')
    for section in ('tracking', 'mapping'):
        for key in ('vis_freq', 'vis_inside_freq', 'no_vis_on_first_frame'):
            cfg[section].pop(key, None)
    assert check_options(cfg) == []
    cfg['model']['decoder_matmul_precision'] = 'bfloat16'
    cfg['matmul_precision'] = 'bfloat16'
    cfg['mapping']['autotune_candidates'] = 3
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        slam = SlamSystem(cfg, device='cpu', output=str(tmp_path))
    messages = [str(w.message) for w in caught]
    assert sum(m.startswith('mapping.autotune_candidates:')
               for m in messages) == 1, messages
    # both precisions are honoured, without a warning
    assert not any(m.startswith(('model.decoder_matmul_precision',
                                 'matmul_precision')) for m in messages), \
        messages
    assert slam.dcfg.mm_precision == 'bfloat16'
    assert slam.model.matmul_precision == 'bfloat16'
    # it reaches the products as values: torch's own float32 products stay
    # true float32 (TF32 off)
    assert torch.get_float32_matmul_precision() == 'highest'
    assert slam.n_img == 2


def _base_of(path: str) -> str:
    return ('configs/imap.yaml' if path.endswith('_imap.yaml')
            else 'configs/nice_slam.yaml')


@pytest.mark.parametrize('path', sorted(
    os.path.relpath(p, REPO) for p in glob.glob(
        os.path.join(REPO, 'configs', '*', '*.yaml'))))
def test_shipped_configs_pass_but_the_multichip_ones(path):
    """Every scene config, over its base, passes the check (with
    warnings only), the multi-device ones too since their parallel
    backends are ported: none of their `parallel` keys warns."""
    from nice_slam_tpu_torch.utils.config import check_options, load_config
    cfg = load_config(os.path.join(REPO, path),
                      os.path.join(REPO, _base_of(path)))
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        messages = check_options(cfg)
    if path.endswith('_multichip.yaml'):
        assert cfg['parallel'] and not any(
            m.startswith('parallel') for m in messages), messages


@pytest.mark.parametrize('method', ['global', 'overlap'])
def test_selected_keyframes_log_matches_jax_window(tmp_path, method):
    """The window that map_frame logs is the JAX package's
    `_select_window` on the same keyframes and numpy draws, plus the
    current frame; the log is kept across a checkpoint."""
    from nice_slam_tpu.engine import keyframes as jk
    from nice_slam_tpu.engine.slam import SlamSystem as JaxSlam
    from nice_slam_tpu.engine.slam import mapper_config_from_cfg
    from nice_slam_tpu.utils import config as jcfg
    from nice_slam_tpu_torch.engine.keyframes import Keyframe, KeyframeStore
    from nice_slam_tpu_torch.engine.slam import SlamSystem
    from nice_slam_tpu_torch.utils.ckpt import load_checkpoint, save_checkpoint
    cfg = make_test_cfg(n_frames=9, coarse=False)
    cfg['mapping'].update(save_selected_keyframes_info=True, iters=1,
                          keyframe_selection_method=method)
    slam = SlamSystem(cfg, device='cpu', output=str(tmp_path / 'a'))
    frames = [slam.frame_reader[i] for i in (0, 2, 4, 6, 8)]
    slam.keyframes = KeyframeStore([
        Keyframe(idx=i, color=c, depth=d, est_c2w=g.copy(), gt_c2w=g)
        for i, c, d, g in frames[:4]])
    idx, color, depth, gt = frames[4]
    slam.estimate_c2w[idx] = gt
    slam.np_rng = np.random.default_rng(5)
    slam.map_frame(idx, color, depth, gt)
    got = [kf['idx'] for kf in slam.selected_keyframes[idx]]

    store = jk.KeyframeStore([
        jk.Keyframe(idx=i, color=c, depth=d, est_c2w=g.copy(), gt_c2w=g)
        for i, c, d, g in frames[:4]])
    jself = types.SimpleNamespace(np_rng=np.random.default_rng(5),
                                  intr=jcfg.intrinsics_from_cfg(cfg))
    sel, _ = JaxSlam._select_window(jself, store, mapper_config_from_cfg(cfg),
                                    cfg['mapping']['mapping_window_size'],
                                    idx, color, depth, gt)
    assert got == [store.frames[p].idx for p in sel] + [idx]
    assert len(got) == 4     # 2 selected, the newest keyframe, the frame

    path = str(tmp_path / 'state.ckpt')
    save_checkpoint(path, slam.checkpoint_state())
    other = SlamSystem(cfg, device='cpu', output=str(tmp_path / 'b'))
    other.restore(load_checkpoint(path))
    assert [kf['idx'] for kf in other.selected_keyframes[idx]] == got
    np.testing.assert_array_equal(other.selected_keyframes[idx][-1]['gt_c2w'],
                                  gt)
