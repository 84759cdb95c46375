// Native host-side geometry kernels for the mesher and 2D reconstruction
// evaluation.  Replaces the reference's third-party native dependencies
// (skimage marching-cubes, Open3D offscreen depth rendering — SURVEY.md
// §2.2) with first-party code:
//
//   * nstpu_marching_tetrahedra: iso-surface extraction over a scalar field
//     laid out x-major ([nx, ny, nz], idx = (x*ny + y)*nz + z).  Each cell
//     splits into 6 tetrahedra; tetrahedron cases are enumerable from first
//     principles (no 256-entry cube tables to transcribe).  Vertices are
//     deduplicated by the lattice edge they lie on, so the output is a
//     watertight shared-vertex mesh suitable for connected-component
//     analysis.
//   * nstpu_rasterize_depth: z-buffer rasterization of a triangle mesh into
//     a depth image (perspective-correct via 1/z interpolation), standard
//     CV pinhole convention (z forward positive).
//
// The port's own copy of nice_slam_tpu/mesh/native/geometry.cpp (the same
// algorithms; its output is bit-equal).  Build: g++ -O3 -shared -fPIC -std=c++17 geometry.cpp -o
// build/libnst_geometry.so (driven by nice_slam_tpu_torch/mesh/native.py at
// first use, loaded with ctypes).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <unordered_map>
#include <vector>

namespace {

struct MeshAssembler {
  std::vector<float> verts;
  std::vector<int> tris;
  std::unordered_map<uint64_t, int> edge_to_vert;

  // Vertex on the lattice edge between flat point indices a and b,
  // interpolated to the iso level.
  int edge_vertex(int64_t a, int64_t b, const float *field,
                  const double *xs, const double *ys, const double *zs,
                  int ny, int nz, float level) {
    if (a > b) std::swap(a, b);
    uint64_t key = (uint64_t)a << 32 | (uint64_t)b;
    auto it = edge_to_vert.find(key);
    if (it != edge_to_vert.end()) return it->second;

    float va = field[a], vb = field[b];
    float denom = vb - va;
    float t = denom == 0.0f ? 0.5f : (level - va) / denom;
    if (t < 0.0f) t = 0.0f;
    if (t > 1.0f) t = 1.0f;

    int ax = (int)(a / ((int64_t)ny * nz)), bx = (int)(b / ((int64_t)ny * nz));
    int ay = (int)((a / nz) % ny), by = (int)((b / nz) % ny);
    int az = (int)(a % nz), bz = (int)(b % nz);
    float px = (float)(xs[ax] + t * (xs[bx] - xs[ax]));
    float py = (float)(ys[ay] + t * (ys[by] - ys[ay]));
    float pz = (float)(zs[az] + t * (zs[bz] - zs[az]));

    int idx = (int)(verts.size() / 3);
    verts.push_back(px);
    verts.push_back(py);
    verts.push_back(pz);
    edge_to_vert.emplace(key, idx);
    return idx;
  }

  void tri(int v0, int v1, int v2) {
    if (v0 == v1 || v1 == v2 || v0 == v2) return;  // degenerate
    tris.push_back(v0);
    tris.push_back(v1);
    tris.push_back(v2);
  }
};

// The 6-tetrahedra decomposition of a cube, as indices into the cube's 8
// corners (corner bit order: (dx<<2)|(dy<<1)|dz).  All six share the main
// diagonal 0-7 so faces of adjacent tets match up.
const int kTets[6][4] = {
    {0, 5, 1, 7}, {0, 1, 3, 7}, {0, 3, 2, 7},
    {0, 2, 6, 7}, {0, 6, 4, 7}, {0, 4, 5, 7},
};

}  // namespace

extern "C" {

// Returns 0 on success.  Caller frees *out_verts / *out_tris with
// nstpu_free.
int nstpu_marching_tetrahedra(const float *field, int nx, int ny, int nz,
                              const double *xs, const double *ys,
                              const double *zs, float level,
                              float **out_verts, int **out_tris,
                              int *n_verts, int *n_tris) {
  MeshAssembler mb;
  const int64_t sy = nz, sx = (int64_t)ny * nz;

  for (int x = 0; x + 1 < nx; ++x) {
    for (int y = 0; y + 1 < ny; ++y) {
      for (int z = 0; z + 1 < nz; ++z) {
        int64_t base = x * sx + y * sy + z;
        int64_t corner[8];
        bool skip = false;
        float vals[8];
        for (int c = 0; c < 8; ++c) {
          int dx = (c >> 2) & 1, dy = (c >> 1) & 1, dz = c & 1;
          corner[c] = base + dx * sx + dy * sy + dz;
          vals[c] = field[corner[c]];
          if (!std::isfinite(vals[c])) skip = true;
        }
        if (skip) continue;
        // fast reject: all corners on one side
        bool any_lo = false, any_hi = false;
        for (int c = 0; c < 8; ++c) {
          if (vals[c] < level) any_lo = true; else any_hi = true;
        }
        if (!any_lo || !any_hi) continue;

        for (int t = 0; t < 6; ++t) {
          const int *T = kTets[t];
          int inside = 0;
          for (int k = 0; k < 4; ++k)
            if (vals[T[k]] >= level) inside |= 1 << k;
          if (inside == 0 || inside == 15) continue;

          // collect tet-local indices of inside/outside vertices
          int in_v[4], out_v[4], ni = 0, no = 0;
          for (int k = 0; k < 4; ++k) {
            if (inside & (1 << k)) in_v[ni++] = T[k];
            else out_v[no++] = T[k];
          }
          auto EV = [&](int a, int b) {
            return mb.edge_vertex(corner[a], corner[b], field, xs, ys, zs,
                                  ny, nz, level);
          };
          if (ni == 1) {        // one inside: single triangle
            int e0 = EV(in_v[0], out_v[0]);
            int e1 = EV(in_v[0], out_v[1]);
            int e2 = EV(in_v[0], out_v[2]);
            mb.tri(e0, e1, e2);
          } else if (ni == 3) { // one outside: single triangle
            int e0 = EV(out_v[0], in_v[0]);
            int e1 = EV(out_v[0], in_v[1]);
            int e2 = EV(out_v[0], in_v[2]);
            mb.tri(e0, e1, e2);
          } else {              // two/two: quad as two triangles
            int e00 = EV(in_v[0], out_v[0]);
            int e01 = EV(in_v[0], out_v[1]);
            int e10 = EV(in_v[1], out_v[0]);
            int e11 = EV(in_v[1], out_v[1]);
            mb.tri(e00, e01, e11);
            mb.tri(e00, e11, e10);
          }
        }
      }
    }
  }

  *n_verts = (int)(mb.verts.size() / 3);
  *n_tris = (int)(mb.tris.size() / 3);
  *out_verts = (float *)std::malloc(mb.verts.size() * sizeof(float));
  *out_tris = (int *)std::malloc(mb.tris.size() * sizeof(int));
  if ((*out_verts == nullptr && !mb.verts.empty()) ||
      (*out_tris == nullptr && !mb.tris.empty()))
    return 1;
  std::memcpy(*out_verts, mb.verts.data(), mb.verts.size() * sizeof(float));
  std::memcpy(*out_tris, mb.tris.data(), mb.tris.size() * sizeof(int));
  return 0;
}

void nstpu_free(void *p) { std::free(p); }

// Depth z-buffer render.  w2c: 4x4 row-major world->camera (CV convention:
// camera looks along +z, z>0 in front).  out_depth must be H*W floats,
// initialized to 0 (0 = no hit).
void nstpu_rasterize_depth(const float *verts, int n_verts, const int *tris,
                           int n_tris, const float *w2c, float fx, float fy,
                           float cx, float cy, int H, int W,
                           float *out_depth) {
  std::vector<float> cam(n_verts * 3);
  std::vector<float> u(n_verts), v(n_verts), iz(n_verts);
  for (int i = 0; i < n_verts; ++i) {
    const float *p = verts + 3 * i;
    for (int r = 0; r < 3; ++r)
      cam[3 * i + r] = w2c[4 * r + 0] * p[0] + w2c[4 * r + 1] * p[1] +
                       w2c[4 * r + 2] * p[2] + w2c[4 * r + 3];
    float z = cam[3 * i + 2];
    if (z > 1e-6f) {
      iz[i] = 1.0f / z;
      u[i] = fx * cam[3 * i + 0] * iz[i] + cx;
      v[i] = fy * cam[3 * i + 1] * iz[i] + cy;
    } else {
      iz[i] = -1.0f;  // behind camera
    }
  }

  std::vector<float> zbuf(H * W, INFINITY);
  for (int t = 0; t < n_tris; ++t) {
    int a = tris[3 * t], b = tris[3 * t + 1], c = tris[3 * t + 2];
    if (iz[a] <= 0 || iz[b] <= 0 || iz[c] <= 0) continue;  // clip
    float minu = std::fmin(u[a], std::fmin(u[b], u[c]));
    float maxu = std::fmax(u[a], std::fmax(u[b], u[c]));
    float minv = std::fmin(v[a], std::fmin(v[b], v[c]));
    float maxv = std::fmax(v[a], std::fmax(v[b], v[c]));
    int x0 = (int)std::floor(minu), x1 = (int)std::ceil(maxu);
    int y0 = (int)std::floor(minv), y1 = (int)std::ceil(maxv);
    if (x1 < 0 || y1 < 0 || x0 >= W || y0 >= H) continue;
    x0 = x0 < 0 ? 0 : x0;
    y0 = y0 < 0 ? 0 : y0;
    x1 = x1 >= W ? W - 1 : x1;
    y1 = y1 >= H ? H - 1 : y1;

    float d = (u[b] - u[a]) * (v[c] - v[a]) - (u[c] - u[a]) * (v[b] - v[a]);
    if (std::fabs(d) < 1e-12f) continue;
    float inv_d = 1.0f / d;
    for (int py = y0; py <= y1; ++py) {
      for (int px = x0; px <= x1; ++px) {
        float wx = px + 0.0f, wy = py + 0.0f;
        float l1 = ((wx - u[a]) * (v[c] - v[a]) -
                    (u[c] - u[a]) * (wy - v[a])) * inv_d;
        float l2 = ((u[b] - u[a]) * (wy - v[a]) -
                    (wx - u[a]) * (v[b] - v[a])) * inv_d;
        float l0 = 1.0f - l1 - l2;
        if (l0 < 0 || l1 < 0 || l2 < 0) continue;
        // perspective-correct depth: interpolate 1/z
        float izp = l0 * iz[a] + l1 * iz[b] + l2 * iz[c];
        float z = 1.0f / izp;
        float &zb = zbuf[py * W + px];
        if (z < zb) zb = z;
      }
    }
  }
  for (int i = 0; i < H * W; ++i)
    out_depth[i] = std::isinf(zbuf[i]) ? 0.0f : zbuf[i];
}

}  // extern "C"
