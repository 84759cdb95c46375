"""Live dashboard during a run; port of `nice_slam_tpu/utils/live.py`.

A self-refreshing dashboard written under `<output>/live/` while the run
executes, optionally served over HTTP:

  * `traj.png`     -- estimated against ground-truth trajectory, top
                      (x/z) and side (x/y) views,
  * `mesh.png`     -- the newest mesh's depth from the current estimated
                      camera (mesh/native.rasterize_depth),
  * `panel.jpg`    -- the newest tracking or mapping panel,
  * `status.json`  -- frame index, timers, pose error so far,
  * `index.html`   -- the page tying them together.

`visualization.live: true` (or the CLI's `--live [--live_port P]`)
enables it; `visualization.live_freq` sets the cadence (every 5 frames by
default; the last frame always).  Everything runs on the host and every
file is replaced atomically.  The images are utils/draw.py's.
"""

from __future__ import annotations

import functools
import json
import os
import shutil
import threading
import time
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from nice_slam_tpu_torch.utils import draw

_INDEX_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8">
<meta http-equiv="refresh" content="2">
<title>nice_slam_tpu_torch live</title>
<style>
 body {{ background:#111; color:#ddd; font-family:monospace; margin:1em; }}
 img {{ max-width:48%; vertical-align:top; margin:0.5%; }}
 .wide {{ max-width:97%; }}
 pre {{ color:#8f8; }}
</style></head><body>
<h2>nice_slam_tpu_torch &mdash; live run</h2>
<pre id="status">loading&hellip;</pre>
<div>
 <img src="traj.png?t={t}" alt="trajectory">
 <img src="mesh.png?t={t}" alt="mesh">
</div>
<div><img class="wide" src="panel.jpg?t={t}" alt="residual panel"></div>
<script>
fetch('status.json?t=' + Date.now()).then(r => r.json()).then(s => {{
  document.getElementById('status').textContent =
    JSON.stringify(s, null, 2);
}});
</script>
</body></html>
"""


class _QuietHandler(SimpleHTTPRequestHandler):
    """No line on stderr for every two-second poll of the page."""

    def log_message(self, *args, **kwargs):
        pass


class LiveViewer:
    def __init__(self, live_dir: str, intr, *, freq: int = 5,
                 port: int | None = None, view_size: int = 360):
        """`port`: serve `live_dir` over HTTP on it (0: a free port, see
        `.port`), bound to NSTPU_LIVE_HOST (default 127.0.0.1)."""
        self.live_dir = live_dir
        self.intr = intr
        self.freq = max(int(freq), 1)
        self.view_size = int(view_size)
        self._mesh_cache: tuple[str, float, tuple] | None = None
        self._server = None
        self._t0 = time.time()
        os.makedirs(live_dir, exist_ok=True)
        with open(os.path.join(live_dir, 'index.html'), 'w') as f:
            f.write(_INDEX_HTML.format(t=int(self._t0)))
        if port is not None:
            self._serve(int(port))

    def _serve(self, port: int) -> None:
        handler = functools.partial(_QuietHandler, directory=self.live_dir)
        host = os.environ.get('NSTPU_LIVE_HOST', '127.0.0.1')
        self._server = ThreadingHTTPServer((host, port), handler)
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()
        print(f'INFO: live view at http://localhost:{self.port}/ (serving '
              f'{self.live_dir})')

    @property
    def port(self) -> int | None:
        return self._server.server_address[1] if self._server else None

    # ------------------------------------------------------------------

    def _plot_traj(self, est: np.ndarray, gt: np.ndarray, n: int) -> None:
        e, g = est[:n, :3, 3], gt[:n, :3, 3]
        views = []
        for a, b in ((0, 2), (0, 1)):
            views.append(draw.plot([
                {'xy': g[:, [a, b]], 'color': 'g', 'label': 'gt'},
                {'xy': e[:, [a, b]], 'color': 'r', 'label': 'estimate'},
                {'xy': e[-1:, [a, b]], 'color': 'r', 'kind': '^'}],
                300, 300))
        draw.save(os.path.join(self.live_dir, 'traj.png'), draw.compose(
            views, ['top (x/z)', 'side (x/y)'], ncols=2))

    @staticmethod
    def _latest_mesh(mesh_dir: str) -> str | None:
        try:
            plys = [os.path.join(mesh_dir, f) for f in os.listdir(mesh_dir)
                    if f.endswith('.ply')]
        except OSError:
            return None
        return max(plys, key=os.path.getmtime) if plys else None

    def mesh_depth(self, path: str, c2w: np.ndarray) -> np.ndarray:
        """Depth [h, w] of the mesh at `path` seen from `c2w`, at
        `view_size` pixels along the frame's longer side (the mesh read
        once per path and modification time)."""
        mtime = os.path.getmtime(path)
        if self._mesh_cache and self._mesh_cache[:2] == (path, mtime):
            verts, tris = self._mesh_cache[2]
        else:
            from nice_slam_tpu_torch.mesh.mesher import load_ply
            verts, tris = load_ply(path)
            self._mesh_cache = (path, mtime, (verts, tris))
        from nice_slam_tpu_torch.mesh.native import rasterize_depth
        scale = self.view_size / max(self.intr.H, self.intr.W)
        h = max(int(self.intr.H * scale), 2)
        w = max(int(self.intr.W * scale), 2)
        # the estimated pose is OpenGL's convention (y up, -z forward);
        # the rasterizer's is CV's (+z forward): flip the y/z columns
        cv = c2w.astype(np.float64).copy()
        cv[:3, 1] *= -1
        cv[:3, 2] *= -1
        return rasterize_depth(verts.astype(np.float64), tris,
                               np.linalg.inv(cv), self.intr.fx * scale,
                               self.intr.fy * scale, self.intr.cx * scale,
                               self.intr.cy * scale, h, w)

    def _plot_mesh(self, mesh_dir: str, c2w: np.ndarray) -> None:
        path = self._latest_mesh(mesh_dir)
        if path is None:
            return
        d = self.mesh_depth(path, c2w)
        image = draw.colormap(d, 0, float(np.max(d)) or 1.0)
        draw.save(os.path.join(self.live_dir, 'mesh.png'), draw.compose(
            [image], [os.path.basename(path)], ncols=1))

    # ------------------------------------------------------------------

    def update(self, idx: int, n_img: int, est_c2w: np.ndarray,
               gt_c2w: np.ndarray, *, mesh_dir: str | None = None,
               panel_path: str | None = None,
               timers: dict | None = None) -> bool:
        """Refresh the dashboard (called once a frame; draws only on the
        cadence and on the last frame).  Returns whether it drew."""
        if idx % self.freq != 0 and idx != n_img - 1:
            return False
        self._plot_traj(est_c2w, gt_c2w, idx + 1)
        if mesh_dir is not None:
            self._plot_mesh(mesh_dir, est_c2w[idx])
        if panel_path and os.path.isfile(panel_path):
            tmp = os.path.join(self.live_dir, '.panel.jpg')
            shutil.copyfile(panel_path, tmp)
            os.replace(tmp, os.path.join(self.live_dir, 'panel.jpg'))
        err = float(np.linalg.norm(est_c2w[idx][:3, 3] - gt_c2w[idx][:3, 3]))
        status = {'frame': idx, 'n_img': n_img,
                  'pose_err_vs_gt_m': round(err, 5),
                  'elapsed_s': round(time.time() - self._t0, 1),
                  **(timers or {})}
        tmp = os.path.join(self.live_dir, '.status.json')
        with open(tmp, 'w') as f:
            json.dump(status, f)
        os.replace(tmp, os.path.join(self.live_dir, 'status.json'))
        return True

    def close(self) -> None:
        """Stop the HTTP server, if any."""
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
