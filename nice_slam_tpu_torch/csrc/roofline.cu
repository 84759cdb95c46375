// Streaming-roofline probes of the corner expansion, for sm_90a.  Plain C
// interface, bound from Python with ctypes (nice_slam_tpu_torch/ops/roofline.py
// builds this file with nvcc at first use).  The SLAM path never calls them:
// they measure how close the expansion's traffic pattern can come to the
// card's memory rate.
//
// Four modes, on the flat layout of ops/expand.py (x [M, C] float32,
// M = nx*ny*nz, row m = (x*ny + y)*nz + z):
//   copy           y = x * 1.0 on an [R, W] buffer (the [M, 8C] expansion)
//   widen8         out[m] = concat(x[m] x 8): [M, C] -> [M, 8C]
//   shifts         where(z == nz-1, x[m], x[m+1]) + where(y == ny-1, x[m],
//                  x[m+nz]): [M, C] -> [M, C]
//   expand_same_x  the expansion with the dx = 1 corners read from the same
//                  x-plane as dx = 0: [M, C] -> [M, 8C]
// They replace the Pallas functions of scripts/studies/proto_expand_roofline.py:
// pallas_copy (copy), and the three bodies of variants.<locals>.run
// (concat8 -> widen8, shifts_only -> shifts, full -> expand_same_x).  The
// study's variants2 body (the real two-plane expansion with channel-slice
// stores) is expand_corners of csrc/expand.cu, timed beside these.  The TPU
// versions stream whole x-planes through VMEM.
//
// What bounds them: bytes only (one add per output float in `shifts`).
//
// copy (copy_kernel) is the streaming bound every data-movement kernel is
// measured against, so it has to stream at the card's rate: each thread
// issues kUnroll independent 16-byte loads before any of its stores (32
// KB in flight per block), consecutive threads on consecutive float4s;
// the grid is the card's resident blocks (occupancy x SMs, one wave) or
// fewer, walking the buffer in strides; buffers larger than the L2 cache
// (50 MB) are read and written with evict-first hints (ld/st.global.cs),
// so the stream does not push the next reads out of L2 for nothing.  It
// streams ~2.8 TB/s on an H100, ~5% below clone (cudaMemcpyAsync); 4 or 16
// loads a thread, a 256-byte L2 prefetch, a slab per block and a TMA bulk
// copy through shared memory measured the same within 1.5% (PERF.md), so
// the plainest stays.
// The other three modes: one thread per output float4; consecutive threads
// write consecutive float4s, and reads of a neighbouring row are served by
// L2.
#include <cuda_runtime.h>

namespace {

enum Mode { kCopy = 0, kWiden8 = 1, kShifts = 2, kExpandSameX = 3 };

__device__ __forceinline__ float4 add4(const float4 a, const float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

template <int MODE>
__global__ void probe_kernel(const float4* __restrict__ x,
                             float4* __restrict__ out, int ny, int nz,
                             int c4, long long total) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    if (MODE == kShifts) {
      const long long m = t / c4;
      const int ch = (int)(t - m * c4);
      const int z = (int)(m % nz);
      const int y = (int)((m / nz) % ny);
      const float4 cur = __ldg(&x[t]);
      const float4 a = z == nz - 1 ? cur : __ldg(&x[(m + 1) * c4 + ch]);
      const float4 b = y == ny - 1 ? cur : __ldg(&x[(m + nz) * c4 + ch]);
      out[t] = add4(a, b);
    } else {
      const int row4 = 8 * c4;
      const long long m = t / row4;
      const int q = (int)(t - m * row4);
      const int k = q / c4;
      const int ch = q - k * c4;
      long long src = m;
      if (MODE == kExpandSameX) {
        const int z = (int)(m % nz);
        const int y = (int)((m / nz) % ny);
        const int sy = min(y + ((k >> 1) & 1), ny - 1);
        const int sz = min(z + (k & 1), nz - 1);
        src = m + (long long)(sy - y) * nz + (sz - z);
      }
      out[t] = __ldg(&x[src * c4 + ch]);
    }
  }
}

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 64;

unsigned int blocks_for(long long total) {
  long long b = (total + kThreads - 1) / kThreads;
  return (unsigned int)(b < kMaxBlocks ? b : kMaxBlocks);
}

constexpr int kUnroll = 8;              // loads in flight per thread
constexpr long long kL2Bytes = 50LL << 20;

template <bool kEvictFirst>
__device__ __forceinline__ float4 load4(const float4* p) {
  if constexpr (kEvictFirst) return __ldcs(p);
  else return __ldg(p);
}

template <bool kEvictFirst>
__device__ __forceinline__ void store4(float4* p, float4 v) {
  if constexpr (kEvictFirst) __stcs(p, v);
  else *p = v;
}

// y = x * 1.0 over `total` float4s: kUnroll loads in flight per thread
template <bool kEvictFirst>
__global__ void __launch_bounds__(kThreads)
    copy_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                long long total) {
  constexpr long long kChunk = (long long)kThreads * kUnroll;
  const long long step = (long long)gridDim.x * kChunk;
  for (long long base = blockIdx.x * kChunk + threadIdx.x; base < total;
       base += step) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kThreads;
      if (i < total) v[u] = load4<kEvictFirst>(x + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kThreads;
      if (i < total)
        store4<kEvictFirst>(out + i, make_float4(v[u].x * 1.0f, v[u].y * 1.0f,
                                                 v[u].z * 1.0f,
                                                 v[u].w * 1.0f));
    }
  }
}

// The copy's grid: the resident blocks of the card (computed at the first
// launch of each hint), or fewer when the buffer needs fewer chunks.
template <bool kEvictFirst>
int launch_copy(const float4* x, float4* out, long long total,
                cudaStream_t s) {
  static long long resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, copy_kernel<kEvictFirst>, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident = (long long)sms * per_sm;
  }
  const long long chunks = (total + kThreads * kUnroll - 1) /
                           (kThreads * kUnroll);
  const unsigned int blocks =
      (unsigned int)(chunks < resident ? chunks : resident);
  copy_kernel<kEvictFirst><<<blocks, kThreads, 0, s>>>(x, out, total);
  return (int)cudaGetLastError();
}

}  // namespace

// mode: 0 copy, 1 widen8, 2 shifts, 3 expand_same_x.  x: [rows, c] float32
// (copy: any rows; the others: rows = nx*ny*nz), c % 4 == 0; out: [rows, c]
// for copy and shifts, [rows, 8c] for widen8 and expand_same_x.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// an unknown mode.
extern "C" int nst_roofline_probe(int mode, const float* x, float* out,
                                  long long rows, int ny, int nz, int c,
                                  void* stream) {
  const int c4 = c / 4;
  const long long total =
      rows * c4 * ((mode == kWiden8 || mode == kExpandSameX) ? 8 : 1);
  if (total == 0) return (int)cudaSuccess;
  const unsigned int blocks = blocks_for(total);
  cudaStream_t s = (cudaStream_t)stream;
  const float4* in4 = reinterpret_cast<const float4*>(x);
  float4* out4 = reinterpret_cast<float4*>(out);
  switch (mode) {
    case kCopy:
      return 16 * total > kL2Bytes ? launch_copy<true>(in4, out4, total, s)
                                   : launch_copy<false>(in4, out4, total, s);
    case kWiden8:
      probe_kernel<kWiden8><<<blocks, kThreads, 0, s>>>(in4, out4, ny, nz,
                                                        c4, total);
      break;
    case kShifts:
      probe_kernel<kShifts><<<blocks, kThreads, 0, s>>>(in4, out4, ny, nz,
                                                        c4, total);
      break;
    case kExpandSameX:
      probe_kernel<kExpandSameX><<<blocks, kThreads, 0, s>>>(in4, out4, ny,
                                                             nz, c4, total);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
