"""ATE of a run: the newest checkpoint under the run's output directory,
its estimated trajectory Horn-aligned to the ground truth, the error
statistics printed one per line; the port's counterpart of
`tools/eval_ate.py`.

    python -m nice_slam_tpu_torch.tools.eval_ate configs/Replica/room0.yaml \
        [--output DIR] [--plot]

--output is the run's directory (default: the config's `data.output`);
--plot also writes `eval_ate_plot.png` there, the trajectories in x-z
(utils/draw.py).  Runs on the CPU.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('config', type=str)
    parser.add_argument('--output', type=str, default=None)
    parser.add_argument('--plot', action='store_true')
    args = parser.parse_args(argv)

    from nice_slam_tpu_torch.eval.ate import evaluate_ate
    from nice_slam_tpu_torch.utils.ckpt import (
        latest_checkpoint, load_checkpoint)
    from nice_slam_tpu_torch.utils.config import load_config

    cfg = load_config(args.config, 'configs/nice_slam.yaml')
    output = args.output or cfg['data']['output']
    path = latest_checkpoint(os.path.join(output, 'ckpts'))
    if path is None:
        raise SystemExit(f'no checkpoint found under {output}/ckpts')
    state = load_checkpoint(path)

    n = int(state['mapping_idx']) + 1
    stats = evaluate_ate(state['estimate_c2w'][:n], state['gt_c2w'][:n],
                         scale=float(cfg.get('scale', 1.0)))
    for k, v in stats.items():
        print(f'{k}: {v:.6f}' if isinstance(v, float) else f'{k}: {v}')

    if args.plot:
        from nice_slam_tpu_torch.utils import draw
        est = state['estimate_c2w'][:n, :3, 3]
        gt = state['gt_c2w'][:n, :3, 3]
        image = draw.plot([
            {'xy': gt[:, [0, 2]], 'color': 'k', 'label': 'ground truth'},
            {'xy': est[:, [0, 2]], 'color': 'b', 'label': 'estimated'}],
            600, 600)
        title = (f"ATE RMSE: "
                 f"{stats['absolute_translational_error.rmse'] * 100:.2f} cm")
        out_png = draw.save(os.path.join(output, 'eval_ate_plot.png'),
                            draw.compose([image], [title], ncols=1))
        print(f'plot saved to {out_png}')


if __name__ == '__main__':
    main()
