// Fused decoder-MLP forward for sm_90a.  Plain C interface, bound from
// Python with ctypes (nice_slam_tpu_torch/ops/fused_mlp.py builds this file
// with nvcc at first use).
//
// What it computes, per point n (exactly MLP.forward of
// nice_slam_tpu_torch/models/decoders.py for the Fourier-embedding decoders
// with grid features):
//   e   = sin(p_n @ B)                       B [3, 93]
//   h   = e
//   for i in 0..4:
//     h = relu(W_i h + b_i) + (Wc_i c_n + bc_i)
//     if i == 2: h = [e, h]                  (the skip)
//   out = W_o h + b_o                        width 1 (occupancy) or 4 (rgb+occ)
// with hidden width 32, c_n of width 32 (middle, color) or 64 (fine).
//
// It replaces the TPU kernel _kernel of nice_slam_tpu/ops/pallas/fused_mlp.py
// (reached from _fused_forward), which keeps a 1024-point block and all
// weights in VMEM and runs the layer stack as block matmuls on the MXU.
//
// What bounds it on an H100: operations.  A point costs 15,479 (middle),
// 20,599 (fine) or 15,575 (color) multiply-adds plus 93 precise sinf, and
// reads only 12 bytes of p, 128-256 bytes of c and writes 4-16 bytes: about
// 215 flop per byte, far above the FP32 ridge of ~20 flop/byte (67 TFLOP/s
// non-tensor FP32 over 3.35 TB/s).  So the design keeps every operand of
// the multiply-adds on chip:
//   * one thread per point (a grid-stride loop over a grid sized to fill
//     the card once, so each block loads the weights once);
//   * all weights of the MLP, packed by the wrapper into one f32 buffer with
//     every W_i stored [in][out], are copied into shared memory once per
//     block.  For input k the 32 outputs read W[k][0..31] as 8 float4s at
//     the same address in every lane of the warp: a broadcast, no bank
//     conflicts.  The fine MLP's weights are 83,696 bytes, above the 48 KB
//     static limit, hence dynamic shared memory and cudaFuncSetAttribute;
//   * the activation vector h[32] and the accumulator acc[32] live in
//     registers (every loop that indexes them is fully unrolled);
//   * the 93 embedding values are not kept: they are recomputed (93 more
//     sinf) where the skip needs them, which costs less than 93 registers
//     or a shared-memory slab per thread;
//   * the feature row c_n is read with __ldg as float4s, straight from
//     device memory through the read-only cache, five times (once per
//     block).  Staging it in shared memory would need 256 threads x 64
//     floats = 64 KB per block on top of the 84 KB of weights, which would
//     leave room for one block per SM instead of two; the five re-reads of a
//     128-256 byte row hit L1/L2.
// Everything is true FP32 (no fast-math, precise sinf: the embedding's
// arguments reach ~10^3 rad, where __sinf's error grows with the argument).
// Making it fast (tensor-core tiles of points with split 3xTF32 products to
// keep FP32 accuracy) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kHidden = 32;
constexpr int kEmbed = 93;
constexpr int kBlocks = 5;
constexpr int kSkip = 2;
constexpr int kThreads = 256;

// Float offsets of the packed weights (ops/fused_mlp.pack_weights writes
// the same layout).  Every section starts on a multiple of 4 floats:
//   B [3][93] (padded to 280) | 5 x (W_i [in_i][32], b_i [32])
//   | 5 x (Wc_i [C][32], bc_i [32]) | W_o [32][OUT] | b_o [OUT] (padded)
__host__ __device__ constexpr int in_width(int i) {
  return i == 0 ? kEmbed : (i == kSkip + 1 ? kEmbed + kHidden : kHidden);
}
__host__ __device__ constexpr int w_off(int i) {
  return i == 0 ? 280 : w_off(i - 1) + in_width(i - 1) * kHidden + kHidden;
}
__host__ __device__ constexpr int b_off(int i) {
  return w_off(i) + in_width(i) * kHidden;
}
constexpr int kWcOff = b_off(kBlocks - 1) + kHidden;
__host__ __device__ constexpr int wc_off(int c, int i) {
  return kWcOff + i * (c * kHidden + kHidden);
}
__host__ __device__ constexpr int bc_off(int c, int i) {
  return wc_off(c, i) + c * kHidden;
}
__host__ __device__ constexpr int wo_off(int c) { return wc_off(c, kBlocks); }
__host__ __device__ constexpr int bo_off(int c, int out) {
  return wo_off(c) + kHidden * out;
}
__host__ __device__ constexpr int pack_size(int c, int out) {
  return (bo_off(c, out) + out + 3) / 4 * 4;
}

// acc[0..31] += x * w[0..31]  (w: one shared-memory row, 16-byte aligned)
__device__ __forceinline__ void axpy_row(float (&acc)[kHidden], float x,
                                         const float* w) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int q = 0; q < kHidden / 4; ++q) {
    const float4 v = w4[q];
    acc[4 * q + 0] = fmaf(x, v.x, acc[4 * q + 0]);
    acc[4 * q + 1] = fmaf(x, v.y, acc[4 * q + 1]);
    acc[4 * q + 2] = fmaf(x, v.z, acc[4 * q + 2]);
    acc[4 * q + 3] = fmaf(x, v.w, acc[4 * q + 3]);
  }
}

__device__ __forceinline__ void load_bias(float (&acc)[kHidden],
                                          const float* b) {
#pragma unroll
  for (int j = 0; j < kHidden; ++j) acc[j] = b[j];
}

// acc += W[0..92] . sin(p @ B), the embedding recomputed on the fly
__device__ __forceinline__ void dense_embed(float (&acc)[kHidden], float p0,
                                            float p1, float p2,
                                            const float* sb, const float* w) {
#pragma unroll 1
  for (int k = 0; k < kEmbed; ++k) {
    const float arg =
        fmaf(p2, sb[2 * kEmbed + k], fmaf(p1, sb[kEmbed + k], p0 * sb[k]));
    axpy_row(acc, sinf(arg), w + k * kHidden);
  }
}

// acc += W[0..31] . h
__device__ __forceinline__ void dense_hidden(float (&acc)[kHidden],
                                             const float (&h)[kHidden],
                                             const float* w) {
#pragma unroll
  for (int k = 0; k < kHidden; ++k) axpy_row(acc, h[k], w + k * kHidden);
}

// h = relu(acc) + (Wc c + bc); h's old value is dead by now and holds the
// feature product while it accumulates
template <int C>
__device__ __forceinline__ void inject(float (&h)[kHidden],
                                       const float (&acc)[kHidden],
                                       const float4* __restrict__ crow,
                                       const float* wc, const float* bc) {
#pragma unroll
  for (int j = 0; j < kHidden; ++j) h[j] = 0.f;
#pragma unroll 2
  for (int q = 0; q < C / 4; ++q) {
    const float4 cv = __ldg(crow + q);
    axpy_row(h, cv.x, wc + (4 * q + 0) * kHidden);
    axpy_row(h, cv.y, wc + (4 * q + 1) * kHidden);
    axpy_row(h, cv.z, wc + (4 * q + 2) * kHidden);
    axpy_row(h, cv.w, wc + (4 * q + 3) * kHidden);
  }
#pragma unroll
  for (int j = 0; j < kHidden; ++j) h[j] = fmaxf(acc[j], 0.f) + (h[j] + bc[j]);
}

// Block I of the stack: h = relu(W_I x + b_I) + (Wc_I c + bc_I), x = e for
// I = 0, [e, h] after the skip, h otherwise
template <int C, int I>
__device__ __forceinline__ void run_block(float (&h)[kHidden], float p0,
                                          float p1, float p2,
                                          const float4* __restrict__ crow,
                                          const float* s) {
  constexpr int w = w_off(I), b = b_off(I);
  constexpr int wc = wc_off(C, I), bc = bc_off(C, I);
  float acc[kHidden];
  load_bias(acc, s + b);
  if constexpr (I == 0) {
    dense_embed(acc, p0, p1, p2, s, s + w);
  } else if constexpr (I == kSkip + 1) {
    dense_embed(acc, p0, p1, p2, s, s + w);
    dense_hidden(acc, h, s + w + kEmbed * kHidden);
  } else {
    dense_hidden(acc, h, s + w);
  }
  inject<C>(h, acc, crow, s + wc, s + bc);
}

template <int C, int OUT>
__global__ void __launch_bounds__(kThreads)
    fused_mlp_kernel(const float* __restrict__ p, const float* __restrict__ c,
                     const float* __restrict__ wpack, float* __restrict__ out,
                     long long n) {
  constexpr int wo = wo_off(C), bo = bo_off(C, OUT);
  extern __shared__ float4 smem4[];
  const float* s = reinterpret_cast<const float*>(smem4);
  const float4* g4 = reinterpret_cast<const float4*>(wpack);
  for (int i = threadIdx.x; i < pack_size(C, OUT) / 4; i += blockDim.x)
    smem4[i] = __ldg(g4 + i);
  __syncthreads();

  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += (long long)gridDim.x * blockDim.x) {
    const float p0 = __ldg(p + 3 * t);
    const float p1 = __ldg(p + 3 * t + 1);
    const float p2 = __ldg(p + 3 * t + 2);
    const float4* crow = reinterpret_cast<const float4*>(c + t * C);
    float h[kHidden];
    static_assert(kBlocks == 5 && kSkip == 2, "the stack below is unrolled");
    run_block<C, 0>(h, p0, p1, p2, crow, s);
    run_block<C, 1>(h, p0, p1, p2, crow, s);
    run_block<C, 2>(h, p0, p1, p2, crow, s);
    run_block<C, 3>(h, p0, p1, p2, crow, s);
    run_block<C, 4>(h, p0, p1, p2, crow, s);

    float o[OUT];
#pragma unroll
    for (int j = 0; j < OUT; ++j) o[j] = s[bo + j];
#pragma unroll
    for (int k = 0; k < kHidden; ++k) {
#pragma unroll
      for (int j = 0; j < OUT; ++j)
        o[j] = fmaf(h[k], s[wo + k * OUT + j], o[j]);
    }
    if constexpr (OUT == 4) {
      reinterpret_cast<float4*>(out)[t] = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int j = 0; j < OUT; ++j) out[t * OUT + j] = o[j];
    }
  }
}

template <int C, int OUT>
int launch(const float* p, const float* c, const float* w, float* out,
           long long n, cudaStream_t stream) {
  auto kernel = fused_mlp_kernel<C, OUT>;
  constexpr int smem = pack_size(C, OUT) * (int)sizeof(float);
  // The grid fills the card once: blocks per SM (shared memory and
  // registers decide it) x SMs, computed at the first launch.
  static int max_blocks = 0;
  if (max_blocks == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    max_blocks = sms * per_sm;
  }
  long long want = (n + kThreads - 1) / kThreads;
  int blocks = (int)(want < max_blocks ? want : max_blocks);
  kernel<<<blocks, kThreads, smem, stream>>>(p, c, w, out, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Packed weight buffer length in floats for a (c_dim, out_dim) pair, or -1.
int nst_fused_mlp_pack_size(int c_dim, int out_dim) {
  if ((c_dim == 32 || c_dim == 64) && (out_dim == 1 || out_dim == 4))
    return pack_size(c_dim, out_dim);
  return -1;
}

// p [n, 3], c [n, c_dim], w the packed weights, out [n, out_dim]; all f32,
// contiguous, c/w/out 16-byte aligned.  Returns a cudaError_t (0 = launched).
int nst_fused_mlp(const float* p, const float* c, const float* w, float* out,
                  long long n, int c_dim, int out_dim, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c_dim == 32 && out_dim == 1) return launch<32, 1>(p, c, w, out, n, s);
  if (c_dim == 32 && out_dim == 4) return launch<32, 4>(p, c, w, out, n, s);
  if (c_dim == 64 && out_dim == 1) return launch<64, 1>(p, c, w, out, n, s);
  if (c_dim == 64 && out_dim == 4) return launch<64, 4>(p, c, w, out, n, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
