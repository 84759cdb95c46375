// Corner expansion of a flat feature grid and its exact transpose (fold),
// for sm_90a.  Plain C interface, bound from Python with ctypes
// (nice_slam_tpu_torch/ops/expand.py builds this file with nvcc at first use).
//
// Layout: the grid G is [M, C] float32, M = nx*ny*nz, row m = (x*ny + y)*nz + z.
// The expansion E is [M, 8C]: corner k = dx*4 + dy*2 + dz of row m holds
// G[min(x+dx, nx-1), min(y+dy, ny-1), min(z+dz, nz-1)] in channels
// [k*C, (k+1)*C).  The fold computes dG = E^T dE for the same map.
//
// expand_corners replaces the TPU kernels _expand_kernel and
// _expand_kernel_chunked (nice_slam_tpu/ops/pallas/expand.py, reached from
// _expand_call and _expand_call_chunked); fold_corners replaces _fold_kernel
// and _fold_kernel_chunked (_fold_call, _fold_call_chunked).  The TPU
// kernels stream whole x-planes (split along y) through VMEM; none of that
// block structure carries over.
//
// What bounds them on an H100: both are pure data movement.  Expand reads
// M*C*4 bytes and writes M*8C*4; fold the reverse.  At the room0 fine+color
// volume (74x56x44, C = 64) that is about 420 MB, about 125 us at 3.35 TB/s.
// Design for that bound, kept simple:
//   * expand: one thread per (row m, corner k, 16-byte channel chunk).
//     Consecutive threads write consecutive float4s, so the 8x larger
//     output stream is fully coalesced; each thread's read of the clamped
//     neighbour row is a 16-byte load of a row that its neighbours in y/z
//     and x also read, which L2 serves.
//   * fold: gather form, one thread per (voxel a, 16-byte chunk of C).  On
//     each axis, offset 0 reads source a; offset 1 reads source a-1 when
//     a >= 1 and also source a when a is the last index.  The thread sums
//     those sources for the 8 corners in a fixed order: no atomics, so the
//     result is deterministic.
// Making them faster (TMA or shared-memory staging of x-planes) is later work.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void add4(float4& a, const float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// Sources along one axis whose clamped +d shift lands on index a.
__device__ __forceinline__ int axis_sources(int a, int n, int d, int* out) {
  if (d == 0) {
    out[0] = a;
    return 1;
  }
  int cnt = 0;
  if (a >= 1) out[cnt++] = a - 1;
  if (a == n - 1) out[cnt++] = a;
  return cnt;
}

__global__ void expand_corners_kernel(const float4* __restrict__ g,
                                      float4* __restrict__ e, int nx, int ny,
                                      int nz, int c4, long long total) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int row4 = 8 * c4;
  const long long m = t / row4;
  const int q = (int)(t - m * row4);
  const int k = q / c4;
  const int ch = q - k * c4;
  const int z = (int)(m % nz);
  const long long r = m / nz;
  const int y = (int)(r % ny);
  const int x = (int)(r / ny);
  const int sx = min(x + (k >> 2), nx - 1);
  const int sy = min(y + ((k >> 1) & 1), ny - 1);
  const int sz = min(z + (k & 1), nz - 1);
  const long long src = ((long long)sx * ny + sy) * nz + sz;
  e[t] = __ldg(&g[src * c4 + ch]);
}

__global__ void fold_corners_kernel(const float4* __restrict__ de,
                                    float4* __restrict__ g, int nx, int ny,
                                    int nz, int c4, long long total) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long a = t / c4;
  const int ch = (int)(t - a * c4);
  const int az = (int)(a % nz);
  const long long r = a / nz;
  const int ay = (int)(r % ny);
  const int ax = (int)(r / ny);
  const long long row4 = 8LL * c4;

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int xs[2], ys[2], zs[2];
  for (int k = 0; k < 8; ++k) {
    const int nxs = axis_sources(ax, nx, k >> 2, xs);
    const int nys = axis_sources(ay, ny, (k >> 1) & 1, ys);
    const int nzs = axis_sources(az, nz, k & 1, zs);
    for (int i = 0; i < nxs; ++i) {
      for (int j = 0; j < nys; ++j) {
        for (int l = 0; l < nzs; ++l) {
          const long long s = ((long long)xs[i] * ny + ys[j]) * nz + zs[l];
          add4(acc, __ldg(&de[s * row4 + (long long)k * c4 + ch]));
        }
      }
    }
  }
  g[t] = acc;
}

constexpr int kThreads = 256;

unsigned int blocks_for(long long total) {
  return (unsigned int)((total + kThreads - 1) / kThreads);
}

}  // namespace

// g: [nx*ny*nz, c] float32, e: [nx*ny*nz, 8c] float32, c % 4 == 0.
// Returns cudaGetLastError() after the launch.
extern "C" int nst_expand_corners(const float* g, float* e, int nx, int ny,
                                  int nz, int c, void* stream) {
  const int c4 = c / 4;
  const long long total = (long long)nx * ny * nz * 8 * c4;
  if (total == 0) return (int)cudaSuccess;
  expand_corners_kernel<<<blocks_for(total), kThreads, 0,
                          (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(g), reinterpret_cast<float4*>(e), nx,
      ny, nz, c4, total);
  return (int)cudaGetLastError();
}

// de: [nx*ny*nz, 8c] float32, g: [nx*ny*nz, c] float32, c % 4 == 0.
// Returns cudaGetLastError() after the launch.
extern "C" int nst_fold_corners(const float* de, float* g, int nx, int ny,
                                int nz, int c, void* stream) {
  const int c4 = c / 4;
  const long long total = (long long)nx * ny * nz * c4;
  if (total == 0) return (int)cudaSuccess;
  fold_corners_kernel<<<blocks_for(total), kThreads, 0,
                        (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(de), reinterpret_cast<float4*>(g), nx,
      ny, nz, c4, total);
  return (int)cudaGetLastError();
}
