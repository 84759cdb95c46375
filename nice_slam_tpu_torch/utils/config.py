"""Layered YAML config and its typed views; port of
`nice_slam_tpu/utils/config.py`.

`load_config` resolves the `inherit_from` chain with a leaf-wins deep
merge over an optional default file; the views build the static config
tuples the engine takes.  The key schema is the reference's, so the JAX
package's config tree loads unchanged.
"""

from __future__ import annotations

import os

import yaml

from nice_slam_tpu_torch.core.cameras import Intrinsics
from nice_slam_tpu_torch.engine.mapper import MapperConfig
from nice_slam_tpu_torch.engine.tracker import TrackerConfig
from nice_slam_tpu_torch.mesh.mesher import MesherConfig
from nice_slam_tpu_torch.models.decoders import DecoderConfig
from nice_slam_tpu_torch.models.grids import GridConfig, round_bound
from nice_slam_tpu_torch.render.renderer import RenderConfig


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
