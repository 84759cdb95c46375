// Fused decoder-MLP forward for sm_90a on the tensor cores.  Plain C
// interface, bound from Python with ctypes (nice_slam_tpu_torch/ops/
// fused_mlp.py builds this file with nvcc at first use).
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
// What bounds it on an H100: operations.  A point costs 15,200 (middle,
// color) or 20,320 (fine) multiply-adds in the dense, fc_c and head
// products, 279 in the embedding argument and 93 precise sinf, and moves
// 12 bytes of p, 128-256 bytes of c and 4-16 bytes of output.  So the
// products go to the tensor cores, at FP32 accuracy:
//
//  * mma.sync.m16n8k8 TF32 with three products per tile (3xTF32): each
//    operand x is split into hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(
//    x - hi), and lo*hi + hi*lo + hi*hi is accumulated in FP32 (~22 of
//    FP32's 24 mantissa bits; the dropped lo*lo is 2^-22 relative).  The
//    weights are split once, when ops/fused_mlp.py packs them; the
//    activations are split as they enter a fragment.
//  * Orientation: the points are M (the A operand, in registers), the
//    weights B (N = hidden 32 = four n8 tiles).  The accumulator of an n8
//    tile holds, per lane (g = lane/4, t = lane%4), rows g, g+8 at columns
//    2t, 2t+1; the A operand of a k8 tile wants columns t, t+4.  Taking
//    every K range in the order "logical k t <-> physical 2t, logical t+4
//    <-> 2t+1" (the packer orders the weights' rows the same way) makes
//    one layer's accumulators the next layer's A fragments as they are:
//    no shuffle and no shared-memory round trip between layers.  The skip
//    [e, h] is two K ranges of one product (93 padded to 96, then 32).
//  * The embedding argument stays on the FP32 cores, once per point and
//    column: arg = fmaf(p2, B2k, fmaf(p1, B1k, p0 * B0k)), then precise
//    sinf (arguments reach ~10^3 rad over room0's bound, where 3xTF32's
//    2^-21 relative error would be ~8 FP32 ulps of the argument).  The 96
//    values are recomputed for the skip at block 3 instead of kept: a
//    warp's 32 x 96 floats (12 KB) do not fit beside the weights and the
//    staged features (below), and registers cannot hold them.
//  * Tiles: a warp takes 32 points (two m16 tiles; each B fragment load
//    feeds 6 mma, which keeps shared-memory reads at ~85 B/clk per SM at
//    the full tensor rate, under the 128 B/clk the SM serves).  Per lane:
//    h and the accumulator, 2 x 4 x 4 floats each; 113-126 registers, so
//    16 warps (4 per scheduler) fit one SM and hide the mma.sync and sinf
//    latencies (with 8 warps a call took 20% longer).
//  * The next tile's p rows (all decoders) and c rows (c_dim 32) are
//    copied, coalesced and 16 bytes a lane, into the warp's shared-memory
//    staging buffer with cp.async while this tile computes: p after block
//    3's embedding (its last reader), c after block 4's fc_c product (the
//    last reader), so the copies fly during block 4, the head and the next
//    tile's embedding and layer 0.  The c rows are stored with their
//    32-byte groups XORed by (row & 3), so the fragment loads (float2, rows
//    g, g+8, columns 2t, 2t+1) hit 32 distinct banks.  With c_dim 64 the
//    fine decoder's weights leave room for 7 staging warps only; it reads
//    its c fragments straight from global memory instead (float2 loads,
//    each warp load 8 rows x 32 contiguous bytes: whole sectors), with 16
//    warps (staging with 7 warps took 23% longer).
//  * All weights, pre-split hi/lo in fragment order (each lane's
//    {hi(2t), hi(2t+1), lo(2t), lo(2t+1)} one 16-byte vector, a warp's
//    512 contiguous bytes: no bank conflicts), stay in shared memory for
//    the block's life; the grid fills the card once and each warp walks
//    its tiles.
//
// Budget (227 KB = 232,448 bytes of shared memory per block):
//   packed weights: 616 FP32 floats (B [3][96], b_i, bc_i, b_o [8]) +
//   hi/lo fragments of the five dense layers (40 k8 tiles x 4 n8 tiles x
//   128 floats = 20,480), the fc_c products (5 x C/8 x 4 x 128: 20,480
//   for C 64, 10,240 for C 32) and the head (4 x 1 x 128 = 512):
//   fine 42,088 floats = 168,352 bytes, middle / color 31,848 = 127,392.
//   staging per warp: 32 x 32 + 96 floats = 4,480 bytes (c_dim 32), 96
//   floats = 384 bytes (c_dim 64, p only; staging c too would be 8,576).
//   middle / color: 16 warps, 127,392 + 16 x 4,480 = 199,072 bytes; fine:
//   16 warps, 168,352 + 16 x 384 = 174,496 bytes.  One block of 512
//   threads per SM: at most 128 registers a thread, and ptxas needs
//   113-126 without spills.
// The multiply-adds are FP32 throughout (no fast-math, precise sinf).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHidden = 32;
constexpr int kEmbedPad = 96;   // 93 Fourier features, padded to k8 tiles
constexpr int kBlocks = 5;
constexpr int kSkip = 2;
constexpr int kTile = 32;       // points per warp tile: two m16 tiles
constexpr int kNT = kHidden / 8;
constexpr int kFrag = 32 * 4;   // floats of one (k8, n8) weight fragment

// Float offsets of the packed weights (ops/fused_mlp.pack_weights writes
// the same layout; every section starts on a multiple of 4 floats):
//   B [3][96] | b_i [5][32] | bc_i [5][32] | b_o [8]
//   | W_i fragments [k8 tiles][4][32 lanes][4], i = 0..4
//   | Wc_i fragments [C/8][4][32][4], i = 0..4 | W_o fragments [4][1][32][4]
__host__ __device__ constexpr int layer_kt(int i) {
  return i == 0 ? kEmbedPad / 8
                : (i == kSkip + 1 ? (kEmbedPad + kHidden) / 8 : kHidden / 8);
}
constexpr int kOffBias = 3 * kEmbedPad;
constexpr int kOffBiasC = kOffBias + kBlocks * kHidden;
constexpr int kOffBiasO = kOffBiasC + kBlocks * kHidden;
constexpr int kOffW = kOffBiasO + 8;
__host__ __device__ constexpr int w_off(int i) {
  return i == 0 ? kOffW : w_off(i - 1) + layer_kt(i - 1) * kNT * kFrag;
}
__host__ __device__ constexpr int wc_off(int c, int i) {
  return w_off(kBlocks) + i * (c / 8) * kNT * kFrag;
}
__host__ __device__ constexpr int wo_off(int c) { return wc_off(c, kBlocks); }
__host__ __device__ constexpr int pack_size(int c) {
  return wo_off(c) + (kHidden / 8) * kFrag;
}

template <int C>
struct Cfg {
  static constexpr int kWarps = 16;
  static constexpr bool kStageC = C == 32;   // fine reads c from global memory
  static constexpr int kThreads = 32 * kWarps;
  // staged floats per warp: c rows (when staged), p rows
  static constexpr int kStage = (kStageC ? kTile * C : 0) + kTile * 3;
  static constexpr int kSmem = (pack_size(C) + kWarps * kStage) * 4;
};
static_assert(Cfg<64>::kSmem <= 232448 && Cfg<32>::kSmem <= 232448,
              "shared memory over the 227 KB a block can use");

// ---------------------------------------------------------------------------
// tensor-core and copy primitives
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// hi/lo TF32 halves of an A fragment
__device__ __forceinline__ void split(const float (&a)[4], uint32_t (&hi)[4],
                                      uint32_t (&lo)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    hi[q] = tf32(a[q]);
    lo[q] = tf32(a[q] - __uint_as_float(hi[q]));
  }
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . w in 3xTF32, the small terms first; w = {hi0, hi1, lo0, lo1}
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], float4 w) {
  const uint32_t h0 = __float_as_uint(w.x), h1 = __float_as_uint(w.y);
  mma(d, alo, h0, h1);
  mma(d, ahi, __float_as_uint(w.z), __float_as_uint(w.w));
  mma(d, ahi, h0, h1);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// staging of a tile's inputs (one commit group each)
// ---------------------------------------------------------------------------

// p rows [first, first + 32) (96 floats, 24 chunks; zero past n)
__device__ __forceinline__ void stage_p(float* sp, const float* p, long long n,
                                        long long first, int lane) {
  if (lane < kTile * 3 / 4) {
    const long long f = 3 * first + 4 * lane;
    const long long left = 3 * n - f;
    const int bytes = left >= 4 ? 16 : (left > 0 ? 4 * (int)left : 0);
    cp_async16(sp + 4 * lane, bytes ? p + f : p, bytes);
  }
  cp_async_commit();
}

// c rows [first, first + 32), 16-byte chunk ch of row r stored at
// 32-byte group (ch / 2) ^ (r & 3) (zero rows past n)
template <int C>
__device__ __forceinline__ void stage_c(float* sc, const float* c, long long n,
                                        long long first, int lane) {
  constexpr int kRowChunks = C / 4;
#pragma unroll
  for (int i = 0; i < kTile * kRowChunks / 32; ++i) {
    const int q = lane + 32 * i;
    const int r = q / kRowChunks, ch = q % kRowChunks;
    const bool ok = first + r < n;
    const int phys = (((ch >> 1) ^ (r & 3)) << 1) | (ch & 1);
    cp_async16(sc + r * C + 4 * phys, ok ? c + (first + r) * C + 4 * ch : c,
               ok ? 16 : 0);
  }
  cp_async_commit();
}

// ---------------------------------------------------------------------------
// the products of one warp tile.  acc[mt][nt] is the m16 x n8 accumulator
// of rows 16 mt + (g, g+8), columns 8 nt + (2t, 2t+1).
// ---------------------------------------------------------------------------

typedef float Acc[2][kNT][4];

// acc += E . W over the 12 k8 tiles of the embedding, E computed here
// from the tile's staged points sp (rows g, g+8, 16+g, 24+g of this lane)
__device__ __forceinline__ void dense_embed(Acc& acc, const float* sB,
                                            const float4* w, const float* sp,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
  struct {
    float x[4], y[4], z[4];
  } pt;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* r = sp + 3 * (8 * i + g);
    pt.x[i] = r[0];
    pt.y[i] = r[1];
    pt.z[i] = r[2];
  }
#pragma unroll 1
  for (int kt = 0; kt < kEmbedPad / 8; ++kt) {
    const int col = 8 * kt + 2 * t;
    const float2 b0 = *reinterpret_cast<const float2*>(sB + col);
    const float2 b1 = *reinterpret_cast<const float2*>(sB + kEmbedPad + col);
    const float2 b2 =
        *reinterpret_cast<const float2*>(sB + 2 * kEmbedPad + col);
    uint32_t hi[2][4], lo[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float a[4];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = 2 * mt + rr;
        a[rr] = sinf(fmaf(pt.z[i], b2.x, fmaf(pt.y[i], b1.x, pt.x[i] * b0.x)));
        a[2 + rr] =
            sinf(fmaf(pt.z[i], b2.y, fmaf(pt.y[i], b1.y, pt.x[i] * b0.y)));
      }
      split(a, hi[mt], lo[mt]);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const float4 wv = w[(kt * kNT + nt) * 32 + lane];
      mma3(acc[0][nt], hi[0], lo[0], wv);
      mma3(acc[1][nt], hi[1], lo[1], wv);
    }
  }
}

// acc += H . W over the 4 k8 tiles of the hidden vector (an accumulator
// of the layer before: its n8 tile j is this product's k8 tile j)
__device__ __forceinline__ void dense_hidden(Acc& acc, const Acc& h,
                                             const float4* w, int lane) {
#pragma unroll
  for (int kt = 0; kt < kNT; ++kt) {
    uint32_t hi[2][4], lo[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float a[4] = {h[mt][kt][0], h[mt][kt][2], h[mt][kt][1],
                          h[mt][kt][3]};
      split(a, hi[mt], lo[mt]);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const float4 wv = w[(kt * kNT + nt) * 32 + lane];
      mma3(acc[0][nt], hi[0], lo[0], wv);
      mma3(acc[1][nt], hi[1], lo[1], wv);
    }
  }
}

// What a warp's blocks read of its tile besides the weights: the staged
// rows, and the global inputs for the copies it starts
struct Tile {
  const float* sc;   // staged c rows [32][C] (when staged)
  float* sp;         // staged p rows [32][3]
  const float* p;
  const float* c;
  long long n, first, next, tiles;
  int lane;
};

// acc += Cfeat . Wc over the C/8 k8 tiles of the tile's features, staged
// in shared memory or (kStaged false) read from global memory
template <int C, bool kStaged>
__device__ __forceinline__ void dense_feat(Acc& acc, const Tile& tl,
                                           const float4* w) {
  const int lane = tl.lane, g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int kk = 0; kk < C / 8; ++kk) {
    uint32_t hi[2][4], lo[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = 16 * mt + g;   // rows r and r + 8 share r & 3
      float2 v0, v1;
      if constexpr (kStaged) {
        const int off = ((kk ^ (r & 3)) << 3) + 2 * t;
        v0 = *reinterpret_cast<const float2*>(tl.sc + r * C + off);
        v1 = *reinterpret_cast<const float2*>(tl.sc + (r + 8) * C + off);
      } else {   // rows past n read the last row; their outputs are dropped
        const long long r0 = min(tl.first + r, tl.n - 1);
        const long long r1 = min(tl.first + r + 8, tl.n - 1);
        v0 = __ldg(reinterpret_cast<const float2*>(tl.c + r0 * C + 8 * kk +
                                                   2 * t));
        v1 = __ldg(reinterpret_cast<const float2*>(tl.c + r1 * C + 8 * kk +
                                                   2 * t));
      }
      const float a[4] = {v0.x, v1.x, v0.y, v1.y};
      split(a, hi[mt], lo[mt]);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const float4 wv = w[(kk * kNT + nt) * 32 + lane];
      mma3(acc[0][nt], hi[0], lo[0], wv);
      mma3(acc[1][nt], hi[1], lo[1], wv);
    }
  }
}

// acc = the bias vector b in the accumulator layout
__device__ __forceinline__ void load_bias(Acc& acc, const float* b, int t) {
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const float2 v = *reinterpret_cast<const float2*>(b + 8 * nt + 2 * t);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      acc[mt][nt][0] = v.x;
      acc[mt][nt][1] = v.y;
      acc[mt][nt][2] = v.x;
      acc[mt][nt][3] = v.y;
    }
  }
}

// Block I: h = relu(W_I x + b_I) + bc_I + Wc_I c, x = e for I = 0, [e, h]
// after the skip (its h range first, so h is dead while the embedding is
// recomputed), h otherwise.  Block 0 waits for the tile's c after its
// embedding product; block 3 starts the copy of the next tile's p
// once it has read this tile's.
template <int C, int I>
__device__ __forceinline__ void run_block(Acc& h, const float* s,
                                          const Tile& tl) {
  const int lane = tl.lane, t = lane & 3;
  const float4* w = reinterpret_cast<const float4*>(s + w_off(I));
  Acc acc;
  load_bias(acc, s + kOffBias + I * kHidden, t);
  if constexpr (I == 0) {
    dense_embed(acc, s, w, tl.sp, lane);
  } else if constexpr (I == kSkip + 1) {
    dense_hidden(acc, h, w + (kEmbedPad / 8) * kNT * 32, lane);
    dense_embed(acc, s, w, tl.sp, lane);
    __syncwarp();   // every lane is done with this tile's p
    if (tl.next < tl.tiles) stage_p(tl.sp, tl.p, tl.n, tl.next * kTile, lane);
    else cp_async_commit();
  } else {
    dense_hidden(acc, h, w, lane);
  }
  const float* bc = s + kOffBiasC + I * kHidden;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const float2 v = *reinterpret_cast<const float2*>(bc + 8 * nt + 2 * t);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      acc[mt][nt][0] = fmaxf(acc[mt][nt][0], 0.f) + v.x;
      acc[mt][nt][1] = fmaxf(acc[mt][nt][1], 0.f) + v.y;
      acc[mt][nt][2] = fmaxf(acc[mt][nt][2], 0.f) + v.x;
      acc[mt][nt][3] = fmaxf(acc[mt][nt][3], 0.f) + v.y;
    }
  }
  if constexpr (I == 0) {
    cp_async_wait<0>();   // this tile's c
    __syncwarp();
  }
  dense_feat<C, Cfg<C>::kStageC>(
      acc, tl, reinterpret_cast<const float4*>(s + wc_off(C, I)));
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) h[mt][nt][q] = acc[mt][nt][q];
}

template <int C, int OUT>
__global__ void __launch_bounds__(Cfg<C>::kThreads, 1)
    fused_mlp_kernel(const float* __restrict__ p, const float* __restrict__ c,
                     const float* __restrict__ wpack, float* __restrict__ out,
                     long long n) {
  using K = Cfg<C>;
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* sc = s + pack_size(C) + warp * K::kStage;
  float* sp = sc + (K::kStageC ? kTile * C : 0);
  const long long tiles = (n + kTile - 1) / kTile;
  const long long stride = (long long)gridDim.x * K::kWarps;
  long long tile = (long long)blockIdx.x * K::kWarps + warp;

  // groups in flight, oldest first: p(tile), c(tile), the weights
  stage_p(sp, p, n, tile * kTile, lane);
  if (K::kStageC) stage_c<C>(sc, c, n, tile * kTile, lane);
  else cp_async_commit();
  for (int i = threadIdx.x; i < pack_size(C) / 4; i += blockDim.x)
    cp_async16(smem4 + i, wpack + 4 * i, 16);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (; tile < tiles; tile += stride) {
    // in flight here: p(tile), then c(tile) (both done on the first tile)
    cp_async_wait<1>();
    __syncwarp();
    const long long next = tile + stride;
    const Tile tl{sc, sp, p, c, n, tile * kTile, next, tiles, lane};
    Acc h;
    static_assert(kBlocks == 5 && kSkip == 2, "the stack below is unrolled");
    run_block<C, 0>(h, s, tl);
    run_block<C, 1>(h, s, tl);
    run_block<C, 2>(h, s, tl);
    run_block<C, 3>(h, s, tl);
    run_block<C, 4>(h, s, tl);
    __syncwarp();   // every lane is done with this tile's c
    if (K::kStageC && next < tiles) stage_c<C>(sc, c, n, next * kTile, lane);
    else cp_async_commit();

    // head: one n8 tile, columns >= OUT zero
    float o[2][4];
    {
      const float2 v = *reinterpret_cast<const float2*>(s + kOffBiasO + 2 * t);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        o[mt][0] = v.x;
        o[mt][1] = v.y;
        o[mt][2] = v.x;
        o[mt][3] = v.y;
      }
    }
    const float4* wo = reinterpret_cast<const float4*>(s + wo_off(C));
#pragma unroll
    for (int kt = 0; kt < kNT; ++kt) {
      const float4 wv = wo[kt * 32 + lane];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float a[4] = {h[mt][kt][0], h[mt][kt][2], h[mt][kt][1],
                            h[mt][kt][3]};
        uint32_t hi[4], lo[4];
        split(a, hi, lo);
        mma3(o[mt], hi, lo, wv);
      }
    }
    const long long first = tile * kTile;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const long long row = first + 16 * mt + 8 * rr + g;
        if (row >= n) continue;
        if constexpr (OUT == 1) {
          if (t == 0) out[row] = o[mt][2 * rr];
        } else {
          if (2 * t < OUT)
            *reinterpret_cast<float2*>(out + row * OUT + 2 * t) =
                make_float2(o[mt][2 * rr], o[mt][2 * rr + 1]);
        }
      }
    }
  }
  cp_async_wait<0>();   // no copy outlives the block
}

template <int C, int OUT>
int launch(const float* p, const float* c, const float* w, float* out,
           long long n, cudaStream_t stream) {
  using K = Cfg<C>;
  auto kernel = fused_mlp_kernel<C, OUT>;
  // The grid fills the card once (blocks per SM from shared memory and
  // registers, times SMs), computed at the first launch; each warp walks
  // its tiles.
  static int max_blocks = 0;
  if (max_blocks == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K::kSmem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, K::kThreads, K::kSmem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    max_blocks = sms * per_sm;
  }
  const long long tiles = (n + kTile - 1) / kTile;
  const long long want = (tiles + K::kWarps - 1) / K::kWarps;
  const int blocks = (int)(want < max_blocks ? want : max_blocks);
  kernel<<<blocks, K::kThreads, K::kSmem, stream>>>(p, c, w, out, n);
  return (int)cudaGetLastError();
}

bool supported(int c_dim, int out_dim) {
  return (c_dim == 32 || c_dim == 64) && (out_dim == 1 || out_dim == 4);
}

}  // namespace

extern "C" {

// Packed weight buffer length in floats for a (c_dim, out_dim) pair, or -1.
int nst_fused_mlp_pack_size(int c_dim, int out_dim) {
  return supported(c_dim, out_dim) ? pack_size(c_dim) : -1;
}

// Dynamic shared memory of one block in bytes, or -1.
int nst_fused_mlp_smem_bytes(int c_dim, int out_dim) {
  if (!supported(c_dim, out_dim)) return -1;
  return c_dim == 64 ? Cfg<64>::kSmem : Cfg<32>::kSmem;
}

// Warps per block, or -1.
int nst_fused_mlp_warps(int c_dim, int out_dim) {
  if (!supported(c_dim, out_dim)) return -1;
  return c_dim == 64 ? Cfg<64>::kWarps : Cfg<32>::kWarps;
}

// p [n, 3], c [n, c_dim], w the packed weights, out [n, out_dim]; all f32,
// contiguous, 16-byte aligned.  Returns a cudaError_t (0 = launched).
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
