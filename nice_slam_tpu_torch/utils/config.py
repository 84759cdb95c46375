"""Layered YAML config and its typed views; port of
`nice_slam_tpu/utils/config.py`.

`load_config` resolves the `inherit_from` chain with a leaf-wins deep
merge over an optional default file; the views build the static config
tuples the engine takes.  The key schema is the reference's, so the JAX
package's config tree loads unchanged.

`HONOURED` and `UNPORTED_OPTIONS` account for every key the JAX package's
SlamSystem and config readers read; `check_options` (called first by
SlamSystem) warns about or refuses the unported ones, so no option of a
config is ignored without a word.
"""

from __future__ import annotations

import os
import warnings

import yaml

from nice_slam_tpu_torch.core.cameras import Intrinsics
from nice_slam_tpu_torch.engine.mapper import MapperConfig
from nice_slam_tpu_torch.engine.tracker import TrackerConfig
from nice_slam_tpu_torch.mesh.mesher import MesherConfig
from nice_slam_tpu_torch.models.decoders import DecoderConfig
from nice_slam_tpu_torch.models.grids import GridConfig, round_bound
from nice_slam_tpu_torch.render.renderer import RenderConfig


# Keys (dotted paths; '*' stands for any key) that act here as in the JAX
# package.
HONOURED = frozenset({
    'cam.H', 'cam.W', 'cam.fx', 'cam.fy', 'cam.cx', 'cam.cy',
    'cam.crop_size', 'cam.crop_edge',
    'grid_len.bound_divisible', 'grid_len.coarse', 'grid_len.middle',
    'grid_len.fine', 'grid_len.color',
    'model.c_dim', 'model.coarse_bound_enlarge',
    'model.pos_embedding_method',
    'rendering.N_samples', 'rendering.N_surface', 'rendering.N_importance',
    'rendering.lindisp', 'rendering.perturb', 'rendering.grad_z',
    'occupancy', 'coarse', 'scale', 'verbose', 'dataset',
    'data.output', 'data.prefetch', 'data.prefetch_workers',
    'pretrained_decoders.middle_fine', 'pretrained_decoders.coarse',
    'sync_method', 'sync_force_free', 'ckpt.compress_images',
    'debug.check_invariants',
    'tracking.pixels', 'tracking.iters', 'tracking.lr',
    'tracking.seperate_LR', 'tracking.w_color_loss',
    'tracking.use_color_in_tracking', 'tracking.ignore_edge_W',
    'tracking.ignore_edge_H', 'tracking.handle_dynamic',
    'tracking.const_speed_assumption', 'tracking.var_floor',
    'tracking.gt_camera',
    'mapping.bound', 'mapping.marching_cubes_bound', 'mapping.pixels',
    'mapping.iters', 'mapping.iters_first', 'mapping.lr_factor',
    'mapping.lr_first_factor', 'mapping.middle_iter_ratio',
    'mapping.fine_iter_ratio', 'mapping.every_frame', 'mapping.BA',
    'mapping.BA_cam_lr', 'mapping.fix_fine', 'mapping.fix_color',
    'mapping.train_middle', 'mapping.frustum_feature_selection',
    'mapping.keyframe_every', 'mapping.mapping_window_size',
    'mapping.w_color_loss', 'mapping.keyframe_selection_method',
    'mapping.color_refine', 'mapping.imap_decoders_lr',
    'mapping.max_rays_per_pass', 'mapping.ckpt_freq', 'mapping.mesh_freq',
    'mapping.no_mesh_on_first_frame', 'mapping.no_log_on_first_frame',
    'mapping.save_selected_keyframes_info',
    'mapping.stage.*.decoders_lr', 'mapping.stage.*.coarse_lr',
    'mapping.stage.*.middle_lr', 'mapping.stage.*.fine_lr',
    'mapping.stage.*.color_lr',
    'meshing.resolution', 'meshing.level_set', 'meshing.clean_mesh',
    'meshing.depth_test', 'meshing.mesh_coarse_level',
    'meshing.clean_mesh_bound_scale', 'meshing.get_largest_components',
    'meshing.remove_small_geometry_threshold',
    'meshing.color_mesh_extraction_method', 'meshing.eval_rec',
    'meshing.async',
})

_ABSENT = object()   # the key is not in the config
_VIS = ('the visualizer panels are not ported (ROADMAP item 18): no '
        'panels are written')
_AUTOTUNE = ("the JAX package's TPU compile re-roll is not ported (the "
             "port's 'Semantics, not TPU workarounds' rule); it has no "
             'effect here')
_F32 = ('a TPU MXU matmul precision: the port keeps true float32 matmuls '
        '(TF32 off, its "Precision" rule)')

# The keys the port does not act on: key -> (action, the JAX package's
# value when the key is absent, the values that change nothing there, what
# the key drives).  When a config gives a key (or its absence gives it) any
# other value, SlamSystem warns once ('warn': an output or a TPU setting;
# the run is the same) or raises NotImplementedError ('refuse') until the
# ROADMAP item named lands.
UNPORTED_OPTIONS = {
    'parallel.map': ('refuse', 'none', ('none',),
                     'multi-device mapping (ROADMAP item 15)'),
    'parallel.track': ('refuse', 'none', ('none',),
                       'ray-sharded tracking (ROADMAP item 15)'),
    'parallel.devices': ('warn', _ABSENT, (0,),
                         'the device count of the parallel backends, which '
                         'are not ported (ROADMAP item 15); it has no '
                         'effect here'),
    'visualization.live': ('refuse', _ABSENT, (None, False),
                           'the live dashboard (ROADMAP item 18)'),
    'visualization.live_freq': ('warn', _ABSENT, (),
                                'the live dashboard is not ported (ROADMAP '
                                'item 18)'),
    'visualization.live_port': ('warn', _ABSENT, (None,),
                                'the live dashboard is not ported (ROADMAP '
                                'item 18)'),
    'enable_vis': ('warn', True, (False,), _VIS),
    'tracking.vis_freq': ('warn', _ABSENT, (), _VIS),
    'mapping.vis_freq': ('warn', _ABSENT, (), _VIS),
    'mapping.vis_inside_freq': ('warn', _ABSENT, (), _VIS),
    'mapping.no_vis_on_first_frame': ('warn', _ABSENT, (), _VIS),
    'debug.profile_dir': ('warn', _ABSENT, (None,),
                          "the JAX profiler trace is not ported (the port's "
                          'profile is scripts/port_profile_room0.py)'),
    'matmul_precision': ('warn', 'float32', ('float32', 'highest'), _F32),
    'model.decoder_matmul_precision': ('warn', _ABSENT,
                                       (None, 'float32', 'highest'), _F32),
    'tracking.autotune_ms': ('warn', _ABSENT, (), _AUTOTUNE),
    'tracking.autotune_candidates': ('warn', _ABSENT, (), _AUTOTUNE),
    'mapping.autotune_ms_per_iter': ('warn', _ABSENT, (), _AUTOTUNE),
    'mapping.autotune_candidates': ('warn', _ABSENT, (), _AUTOTUNE),
}


def _lookup(cfg: dict, key: str):
    node = cfg
    for part in key.split('.'):
        if not isinstance(node, dict) or part not in node:
            return _ABSENT
        node = node[part]
    return node


def check_options(cfg: dict) -> list[str]:
    """Raise NotImplementedError for the first refused option the config
    sets, naming the key and its value; warn once for every warned one.
    Returns the warnings' messages."""
    messages = []
    for key, (action, default, inert, what) in UNPORTED_OPTIONS.items():
        value = _lookup(cfg, key)
        if value is _ABSENT:
            value = default
        if value is _ABSENT or value in inert:
            continue
        if action == 'refuse':
            raise NotImplementedError(
                f'{key}: {value!r} is not ported yet: {what}')
        msg = f'{key}: {value!r} is ignored: {what}'
        warnings.warn(msg, UserWarning, stacklevel=3)
        messages.append(msg)
    return messages


def load_config(path: str, default_path: str | None = None) -> dict:
    """Load a YAML config, resolving `inherit_from` (relative to the working
    directory, else to the including file); later files win key by key."""
    with open(path, 'r') as f:
        special = yaml.safe_load(f)
    inherit = special.get('inherit_from')
    if inherit is not None:
        if not os.path.exists(inherit):
            alt = os.path.join(os.path.dirname(path), inherit)
            inherit = alt if os.path.exists(alt) else inherit
        cfg = load_config(inherit, default_path)
    elif default_path is not None:
        with open(default_path, 'r') as f:
            cfg = yaml.safe_load(f)
    else:
        cfg = {}
    deep_update(cfg, special)
    return cfg


def deep_update(dst: dict, src: dict) -> None:
    """Recursive leaf-wins merge of src into dst."""
    for k, v in src.items():
        if isinstance(v, dict):
            node = dst.setdefault(k, {})
            if isinstance(node, dict):
                deep_update(node, v)
            else:
                dst[k] = dict(v)
        else:
            dst[k] = v


def intrinsics_from_cfg(cfg: dict) -> Intrinsics:
    """Intrinsics after `crop_size` / `crop_edge`."""
    cam = cfg['cam']
    intr = Intrinsics(cam['H'], cam['W'], float(cam['fx']), float(cam['fy']),
                      float(cam['cx']), float(cam['cy']))
    if cam.get('crop_size') is not None:
        ch, cw = cam['crop_size']
        intr = intr.scaled_to(ch, cw)
    return intr.cropped_by(int(cam.get('crop_edge', 0)))


def grid_config_from_cfg(cfg: dict) -> GridConfig:
    gl = cfg['grid_len']
    bound = round_bound(cfg['mapping']['bound'], gl['bound_divisible'],
                        scale=cfg.get('scale', 1.0))
    return GridConfig(
        bound=bound,
        coarse_grid_len=float(gl['coarse']),
        middle_grid_len=float(gl['middle']),
        fine_grid_len=float(gl['fine']),
        color_grid_len=float(gl['color']),
        c_dim=int(cfg['model']['c_dim']),
        coarse_bound_enlarge=float(cfg['model']['coarse_bound_enlarge']),
        coarse=bool(cfg['coarse']),
    )


def decoder_config_from_cfg(cfg: dict) -> DecoderConfig:
    return DecoderConfig(
        c_dim=int(cfg['model']['c_dim']),
        pos_embedding_method=cfg['model']['pos_embedding_method'],
        coarse=bool(cfg['coarse']),
    )


def render_config_from_cfg(cfg: dict) -> RenderConfig:
    r = cfg['rendering']
    return RenderConfig(
        n_samples=int(r['N_samples']),
        n_surface=int(r['N_surface']),
        n_importance=int(r['N_importance']),
        lindisp=bool(r['lindisp']),
        perturb=float(r['perturb']),
        occupancy=bool(cfg['occupancy']),
        grad_z=bool(r.get('grad_z', False)),
    )


def tracker_config_from_cfg(cfg: dict) -> TrackerConfig:
    t = cfg['tracking']
    return TrackerConfig(
        pixels=int(t['pixels']), iters=int(t['iters']),
        cam_lr=float(t['lr']), separate_lr=bool(t['seperate_LR']),
        w_color_loss=float(t['w_color_loss']),
        use_color=bool(t['use_color_in_tracking']),
        ignore_edge_w=int(t['ignore_edge_W']),
        ignore_edge_h=int(t['ignore_edge_H']),
        handle_dynamic=bool(t['handle_dynamic']),
        const_speed=bool(t['const_speed_assumption']),
        var_floor=float(t.get('var_floor', 1e-10)))


def mapper_config_from_cfg(cfg: dict, *, coarse_mapper: bool = False
                           ) -> MapperConfig:
    m = cfg['mapping']
    stage_lr = tuple(
        (s, (float(m['stage'][s]['decoders_lr']),
             float(m['stage'][s]['coarse_lr']),
             float(m['stage'][s]['middle_lr']),
             float(m['stage'][s]['fine_lr']),
             float(m['stage'][s]['color_lr'])))
        for s in ('coarse', 'middle', 'fine', 'color')) \
        if 'stage' in m else ()
    # the coarse mapper always selects keyframes globally
    sel = 'global' if coarse_mapper else m['keyframe_selection_method']
    return MapperConfig(
        pixels=int(m['pixels']), iters=int(m['iters']),
        iters_first=int(m['iters_first']),
        lr_factor=float(m['lr_factor']),
        lr_first_factor=float(m['lr_first_factor']),
        middle_iter_ratio=float(m['middle_iter_ratio']),
        fine_iter_ratio=float(m['fine_iter_ratio']),
        every_frame=int(m['every_frame']),
        ba=bool(m['BA']), ba_cam_lr=float(m['BA_cam_lr']),
        fix_fine=bool(m['fix_fine']), fix_color=bool(m['fix_color']),
        train_middle=bool(m.get('train_middle', False)),
        frustum_selection=bool(m['frustum_feature_selection']),
        keyframe_every=int(m['keyframe_every']),
        window_size=int(m['mapping_window_size']),
        w_color_loss=float(m['w_color_loss']),
        keyframe_selection=sel,
        color_refine=bool(m['color_refine']),
        stage_lr=stage_lr,
        imap_decoders_lr=float(m.get('imap_decoders_lr', 0.0002)),
        max_rays_per_pass=int(m.get('max_rays_per_pass', 0)),
        coarse_mapper=coarse_mapper)


def mesher_config_from_cfg(cfg: dict) -> MesherConfig:
    """`meshing.*`; the marching-cubes bound is scaled by `scale`, and
    without `mapping.marching_cubes_bound` it is the grid bound (rounded
    and scaled, then scaled again), as in the JAX package."""
    me = cfg.get('meshing', {})
    scale = float(cfg.get('scale', 1.0))
    mc_bound = cfg['mapping'].get('marching_cubes_bound',
                                  grid_config_from_cfg(cfg).bound)
    return MesherConfig(
        resolution=int(me.get('resolution', 256)),
        level_set=float(me.get('level_set', 0.0)),
        clean_mesh=bool(me.get('clean_mesh', True)),
        depth_test=bool(me.get('depth_test', False)),
        mesh_coarse_level=bool(me.get('mesh_coarse_level', False)),
        clean_mesh_bound_scale=float(me.get('clean_mesh_bound_scale', 1.02)),
        get_largest_components=bool(me.get('get_largest_components', False)),
        remove_small_geometry_threshold=float(
            me.get('remove_small_geometry_threshold', 0.2)),
        color_mesh_extraction_method=me.get(
            'color_mesh_extraction_method', 'direct_point_query'),
        marching_cubes_bound=tuple(tuple(float(v) * scale for v in b)
                                   for b in mc_bound),
        scale=scale)
