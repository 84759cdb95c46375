// Row gather out[i] = table[idx[i]] and its adjoint, the row scatter-add
// out[idx[i]] += grad[i], for sm_90a.  Plain C interface, bound from Python
// with ctypes (nice_slam_tpu_torch/ops/gather.py builds this file with nvcc
// at first use).
//
// gather_rows replaces the three Pallas row gathers of the gather studies:
// pallas_gather_tiles (scripts/studies/proto_gather_sweep.py), one DMA per
// 1024-float tile row; pallas_gather_rows (proto_pallas_gather.py), one DMA
// per row with a ring of semaphores; and pallas_gather
// (proto_gather_paths.py), the table resident in VMEM and jnp.take.  All
// three compute table[idx] with f32 rows; the studies were written to replace
// the XLA gather `eg.e[m]` of nice_slam_tpu/ops/trilinear.py, which in the
// port is the gather of every grid lookup (ops/trilinear.py).  The TPU
// versions are shaped by its DMA descriptor issue rate and by VMEM; neither
// carries over.  scatter_add_rows is the gather's backward, which the TPU
// package left to XLA's scatter.
//
// What bounds them on an H100: data movement.  The gather reads N rows of W
// floats and writes N rows; at room0's mapping shape (48,000 points, W = 512)
// that is 2 x 98 MB, about 59 us at 3.35 TB/s.  The scatter zeroes the
// [M, W] output (the wrapper's memset), reads N gradient rows and writes
// each target row once.  Design, kept simple:
//   * one thread per (row i, 16-byte chunk of the row): consecutive threads
//     read consecutive float4s of one table row and write consecutive
//     float4s of the output, so both streams are coalesced;
//   * the scatter is sorted and segmented, not atomic: the wrapper sorts the
//     indices stably (with the positions they came from), and the thread of
//     the first sorted position of each target row sums that row's gradient
//     rows from 0 in the order of their positions, then stores it once.  The
//     result is deterministic and is the sum, in the same order, that
//     PyTorch's sort-based index_put_ with accumulate (the backward of
//     table[idx] in autograd) forms, so the port's trajectories do not move
//     with this kernel.  A vector atomicAdd per float4 (sm_90) would skip
//     the sort but sum in an order that changes from run to run, which moved
//     the from-scratch synthetic trajectory outside its bound on the card.
//   * an index outside [0, M) fails a device-side assertion in either
//     kernel, as PyTorch's own index kernels do for table[idx] on the card:
//     the launch is aborted and the next call that synchronizes raises.
// Making them faster (the gather fused into the interpolation, the sort
// shared by the tracker's or mapper's several lookups) is later work.

#include <cassert>

#include <cuda_runtime.h>

namespace {

__global__ void gather_rows_kernel(const float4* __restrict__ table,
                                   const long long* __restrict__ idx,
                                   float4* __restrict__ out, long long m,
                                   int w4, long long total) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long i = t / w4;
    const int ch = (int)(t - i * w4);
    const long long row = __ldg(&idx[i]);
    assert(row >= 0 && row < m);
    out[t] = __ldg(&table[row * w4 + ch]);
  }
}

// sorted: the indices in ascending order, pos: the position each came from
// (a stable sort), both [n].  One thread per (sorted position, chunk); the
// first position of each run of equal indices sums the run.
__global__ void scatter_add_rows_kernel(const float4* __restrict__ grad,
                                        const long long* __restrict__ sorted,
                                        const long long* __restrict__ pos,
                                        float4* __restrict__ out,
                                        long long m, long long n, int w4,
                                        long long total) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long s = t / w4;
    const int ch = (int)(t - s * w4);
    const long long row = __ldg(&sorted[s]);
    assert(row >= 0 && row < m);
    if (s > 0 && __ldg(&sorted[s - 1]) == row) continue;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (long long q = s; q < n && __ldg(&sorted[q]) == row; ++q) {
      const float4 g = __ldg(&grad[__ldg(&pos[q]) * w4 + ch]);
      acc.x += g.x;
      acc.y += g.y;
      acc.z += g.z;
      acc.w += g.w;
    }
    out[row * w4 + ch] = acc;
  }
}

constexpr int kThreads = 256;
// enough blocks to fill 132 SMs many times over; larger problems loop
constexpr long long kMaxBlocks = 132LL * 64;

unsigned int blocks_for(long long total) {
  long long b = (total + kThreads - 1) / kThreads;
  return (unsigned int)(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

// table: [m, w] float32, idx: [n] int64, out: [n, w] float32, w % 4 == 0.
// Returns cudaGetLastError() after the launch.
extern "C" int nst_gather_rows(const float* table, const long long* idx,
                               float* out, long long m, long long n, int w,
                               void* stream) {
  const int w4 = w / 4;
  const long long total = n * w4;
  if (total == 0) return (int)cudaSuccess;
  gather_rows_kernel<<<blocks_for(total), kThreads, 0,
                       (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(table), idx,
      reinterpret_cast<float4*>(out), m, w4, total);
  return (int)cudaGetLastError();
}

// grad: [n, w] float32; sorted, pos: [n] int64, the indices stably sorted
// and the positions they came from; out: [m, w] float32 already zeroed,
// w % 4 == 0.  Returns cudaGetLastError() after the launch.
extern "C" int nst_scatter_add_rows(const float* grad, const long long* sorted,
                                    const long long* pos, float* out,
                                    long long m, long long n, int w,
                                    void* stream) {
  const int w4 = w / 4;
  const long long total = n * w4;
  if (total == 0) return (int)cudaSuccess;
  scatter_add_rows_kernel<<<blocks_for(total), kThreads, 0,
                            (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(grad), sorted, pos,
      reinterpret_cast<float4*>(out), m, n, w4, total);
  return (int)cudaGetLastError();
}
