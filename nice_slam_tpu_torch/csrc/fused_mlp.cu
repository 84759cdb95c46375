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
//
// bfloat16 modes (the decoders' effective matmul precision, models/
// precision.py, is not float32): the same kernel with every product of the
// stack -- hidden, skip, fc_c and head -- at the TPU's bf16 rule on
// mma.sync.m16n8k16 bf16 with FP32 accumulation:
//  * one pass (P = 1): each operand rounded to bf16 (cvt.rn: to nearest,
//    ties to even), products summed in FP32;
//  * three passes (P = 3): each operand split as hi = bf16(x), lo =
//    bf16(x - hi), and lo*hi + hi*lo + hi*hi accumulated in FP32, the
//    split of models/precision.split.
//  Bias, ReLU, the skip concatenation and the sine stay FP32.  The
//  embedding argument stays on the FP32 cores as fmaf chains over the
//  bf16-rounded (split) p and B: a bf16 x bf16 product is exact in FP32,
//  so that is the rule itself; then precise sinf.
//  * Fragment reuse: the accumulators of n8 tiles 2j and 2j+1 (rows g,
//    g+8, columns 2t, 2t+1 of each) are, packed to bf16x2, the four
//    registers of the next product's k16 A fragment (rows g, g+8, columns
//    2t, 2t+1 and 2t+8, 2t+9) in the natural K order: no shuffle between
//    layers.  The staged c rows give theirs the same way, two 32-byte
//    groups per k16 tile.
//  * Weights: packed once per parameter set and mode by ops/fused_mlp.py
//    as bf16x2 B fragments, per lane {hi b0, hi b1} (8 bytes) or {hi b0,
//    hi b1, lo b0, lo b1} (16 bytes) of each (k16, n8) tile; B in FP32 as
//    its bf16 value (P = 1) or its hi and lo parts (P = 3).  K pads to a
//    multiple of 16 with zeros (93 -> 96; the skip 96 + 32).  The weights
//    take 43,936 / 86,560 bytes (c 64) at P = 1 / 3, under the 3xTF32
//    buffer; the warps, staging and grid are the 3xTF32 kernel's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHidden = 32;
constexpr int kEmbedPad = 96;   // 93 Fourier features, padded to k8 tiles
constexpr int kBlocks = 5;
constexpr int kSkip = 2;
constexpr int kTile = 32;       // points per warp tile: two m16 tiles
constexpr int kNT = kHidden / 8;

// The packed weights of mode P (0: 3xTF32; 1, 3: bf16 passes), in 32-bit
// words (ops/fused_mlp.pack_weights writes the same layout; every section
// starts on a multiple of 4 words):
//   B [3][96] (P = 3: B hi [3][96], B lo [3][96]) | b_i [5][32]
//   | bc_i [5][32] | b_o [8]
//   | W_i fragments [K tiles][4][32 lanes][kWords], i = 0..4
//   | Wc_i fragments [C/kK][4][32][kWords], i = 0..4
//   | W_o fragments [32/kK][1][32][kWords]
// with K tiles of kK = 8 (TF32 hi/lo: 4 words a lane) or 16 (bf16x2: 2
// words a lane at P = 1, hi then lo at P = 3).
template <int P>
struct Layout {
  static constexpr int kK = P == 0 ? 8 : 16;
  static constexpr int kWords = P == 1 ? 2 : 4;
  static constexpr int kFrag = 32 * kWords;   // words of one (kK, n8) tile
  static constexpr int kOffBias = (P == 3 ? 6 : 3) * kEmbedPad;
  static constexpr int kOffBiasC = kOffBias + kBlocks * kHidden;
  static constexpr int kOffBiasO = kOffBiasC + kBlocks * kHidden;
  static constexpr int kOffW = kOffBiasO + 8;
  // K tiles of dense layer i: the embedding, [e, h] after the skip, h
  __host__ __device__ static constexpr int layer_kt(int i) {
    return (i == 0 ? kEmbedPad
                   : (i == kSkip + 1 ? kEmbedPad + kHidden : kHidden)) / kK;
  }
  __host__ __device__ static constexpr int w_off(int i) {
    return i == 0 ? kOffW : w_off(i - 1) + layer_kt(i - 1) * kNT * kFrag;
  }
  __host__ __device__ static constexpr int wc_off(int c, int i) {
    return w_off(kBlocks) + i * (c / kK) * kNT * kFrag;
  }
  __host__ __device__ static constexpr int wo_off(int c) {
    return wc_off(c, kBlocks);
  }
  __host__ __device__ static constexpr int pack_size(int c) {
    return wo_off(c) + (kHidden / kK) * kFrag;
  }
};

template <int C, int P>
struct Cfg {
  static constexpr int kWarps = 16;
  static constexpr bool kStageC = C == 32;   // fine reads c from global memory
  static constexpr int kThreads = 32 * kWarps;
  // staged floats per warp: c rows (when staged), p rows
  static constexpr int kStage = (kStageC ? kTile * C : 0) + kTile * 3;
  static constexpr int kSmem =
      (Layout<P>::pack_size(C) + kWarps * kStage) * 4;
};
static_assert(Cfg<64, 0>::kSmem <= 232448 && Cfg<32, 0>::kSmem <= 232448,
              "shared memory over the 227 KB a block can use");
static_assert(Layout<0>::pack_size(64) == 42088 &&
                  Layout<0>::pack_size(32) == 31848,
              "the 3xTF32 layout of the budget above");

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

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16x2 of (lo, hi), round to nearest even (cvt.rn.bf16x2.f32)
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The k16 A fragment of a[8] (register r holds a[2r], a[2r+1]): its bf16
// values (hi), and at P = 3 the bf16 values of the remainders (lo)
template <int P>
__device__ __forceinline__ void split_bf16(const float (&a)[8],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    hi[r] = bf16x2(a[2 * r], a[2 * r + 1]);
    if constexpr (P == 3) {
      const float2 h =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi[r]));
      lo[r] = bf16x2(a[2 * r] - h.x, a[2 * r + 1] - h.y);
    }
  }
}

// d += a . w at P passes; w = this lane's {hi b0, hi b1[, lo b0, lo b1]}
template <int P>
__device__ __forceinline__ void mma_passes(float (&d)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           const uint32_t* w) {
  if constexpr (P == 3) {   // the small terms first
    mma_bf16(d, alo, w[0], w[1]);
    mma_bf16(d, ahi, w[2], w[3]);
  }
  mma_bf16(d, ahi, w[0], w[1]);
}

// this lane's words of fragment f (kWords of them, one vector load)
template <int P>
__device__ __forceinline__ void load_frag(uint32_t (&w)[4],
                                          const uint32_t* base, int f,
                                          int lane) {
  if constexpr (P == 1) {
    const uint2 v = reinterpret_cast<const uint2*>(base)[f * 32 + lane];
    w[0] = v.x;
    w[1] = v.y;
  } else {
    const uint4 v = reinterpret_cast<const uint4*>(base)[f * 32 + lane];
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
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

// bf16 modes: acc += E . W over the 6 k16 tiles of the embedding.  The
// argument of column k at a point is sum_j p_j B_jk under the rule, on the
// FP32 cores: one pass, fmaf over the bf16 values of p and B (sB holds B's
// bf16 values); three passes, the passes (p hi, B lo), (p lo, B hi), (p hi,
// B hi) summed in that order (sB holds B hi, then B lo).
template <int P>
__device__ __forceinline__ void dense_embed_bf16(Acc& acc, const float* sB,
                                                 const uint32_t* w,
                                                 const float* sp, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int kt = 0; kt < kEmbedPad / 16; ++kt) {
    uint32_t hi[2][4], lo[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      // the bf16 parts of p at rows 16 mt + g (rr 0) and + 8 (rr 1), read
      // again from the staged rows for each tile (fewer live registers)
      float ph[2][3], pl[2][3];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float* r = sp + 3 * (16 * mt + 8 * rr + g);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          ph[rr][j] = bf16_round(r[j]);
          pl[rr][j] = P == 3 ? bf16_round(r[j] - ph[rr][j]) : 0.f;
        }
      }
      // the sines at columns 16 kt + 2t + {0, 1} (half 0) and + 8 (half
      // 1), in A-fragment order
      float a[8];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int col = 16 * kt + 8 * hf + 2 * t;
        float2 bh[3], bl[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          bh[j] = *reinterpret_cast<const float2*>(sB + j * kEmbedPad + col);
          if constexpr (P == 3)
            bl[j] = *reinterpret_cast<const float2*>(
                sB + (3 + j) * kEmbedPad + col);
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float b0 = e ? bh[0].y : bh[0].x;
            const float b1 = e ? bh[1].y : bh[1].x;
            const float b2 = e ? bh[2].y : bh[2].x;
            const float* h = ph[rr];
            float arg = fmaf(h[2], b2, fmaf(h[1], b1, h[0] * b0));
            if constexpr (P == 3) {
              const float* l = pl[rr];
              const float l0 = e ? bl[0].y : bl[0].x;
              const float l1 = e ? bl[1].y : bl[1].x;
              const float l2 = e ? bl[2].y : bl[2].x;
              const float hl = fmaf(h[2], l2, fmaf(h[1], l1, h[0] * l0));
              const float lh = fmaf(l[2], b2, fmaf(l[1], b1, l[0] * b0));
              arg = (hl + lh) + arg;
            }
            a[4 * hf + 2 * rr + e] = sinf(arg);
          }
      }
      split_bf16<P>(a, hi[mt], lo[mt]);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      uint32_t wv[4];
      load_frag<P>(wv, w, kt * kNT + nt, lane);
      mma_passes<P>(acc[0][nt], hi[0], lo[0], wv);
      mma_passes<P>(acc[1][nt], hi[1], lo[1], wv);
    }
  }
}

// The k16 A fragment of k tile kk of an accumulator (its n8 tiles 2 kk and
// 2 kk + 1), for one m16 tile
__device__ __forceinline__ void acc_fragment(float (&a)[8], const Acc& h,
                                             int mt, int kk) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int q = 0; q < 4; ++q) a[4 * hf + q] = h[mt][2 * kk + hf][q];
}

// bf16 modes: acc += H . W over the 2 k16 tiles of the hidden vector
template <int P>
__device__ __forceinline__ void dense_hidden_bf16(Acc& acc, const Acc& h,
                                                  const uint32_t* w,
                                                  int lane) {
#pragma unroll
  for (int kt = 0; kt < kHidden / 16; ++kt) {
    uint32_t hi[2][4], lo[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float a[8];
      acc_fragment(a, h, mt, kt);
      split_bf16<P>(a, hi[mt], lo[mt]);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      uint32_t wv[4];
      load_frag<P>(wv, w, kt * kNT + nt, lane);
      mma_passes<P>(acc[0][nt], hi[0], lo[0], wv);
      mma_passes<P>(acc[1][nt], hi[1], lo[1], wv);
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

// bf16 modes: acc += Cfeat . Wc over the C/16 k16 tiles of the features
// (each two 32-byte groups of the staged rows, or global memory)
template <int C, bool kStaged, int P>
__device__ __forceinline__ void dense_feat_bf16(Acc& acc, const Tile& tl,
                                                const uint32_t* w) {
  const int lane = tl.lane, g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int kk = 0; kk < C / 16; ++kk) {
    uint32_t hi[2][4], lo[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = 16 * mt + g;   // rows r and r + 8 share r & 3
      float a[8];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int k8 = 2 * kk + hf;
        float2 v0, v1;
        if constexpr (kStaged) {
          const int off = ((k8 ^ (r & 3)) << 3) + 2 * t;
          v0 = *reinterpret_cast<const float2*>(tl.sc + r * C + off);
          v1 = *reinterpret_cast<const float2*>(tl.sc + (r + 8) * C + off);
        } else {   // rows past n read the last row; their outputs are dropped
          const long long r0 = min(tl.first + r, tl.n - 1);
          const long long r1 = min(tl.first + r + 8, tl.n - 1);
          v0 = __ldg(reinterpret_cast<const float2*>(tl.c + r0 * C + 8 * k8 +
                                                     2 * t));
          v1 = __ldg(reinterpret_cast<const float2*>(tl.c + r1 * C + 8 * k8 +
                                                     2 * t));
        }
        a[4 * hf + 0] = v0.x;
        a[4 * hf + 1] = v0.y;
        a[4 * hf + 2] = v1.x;
        a[4 * hf + 3] = v1.y;
      }
      split_bf16<P>(a, hi[mt], lo[mt]);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      uint32_t wv[4];
      load_frag<P>(wv, w, kk * kNT + nt, lane);
      mma_passes<P>(acc[0][nt], hi[0], lo[0], wv);
      mma_passes<P>(acc[1][nt], hi[1], lo[1], wv);
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
// once it has read this tile's.  P: 0 3xTF32, 1 / 3 bf16 passes.
template <int C, int I, int P>
__device__ __forceinline__ void run_block(Acc& h, const float* s,
                                          const Tile& tl) {
  using L = Layout<P>;
  const int lane = tl.lane, t = lane & 3;
  Acc acc;
  load_bias(acc, s + L::kOffBias + I * kHidden, t);
  if constexpr (P == 0) {
    const float4* w = reinterpret_cast<const float4*>(s + L::w_off(I));
    if constexpr (I == 0) {
      dense_embed(acc, s, w, tl.sp, lane);
    } else if constexpr (I == kSkip + 1) {
      dense_hidden(acc, h, w + (kEmbedPad / 8) * kNT * 32, lane);
      dense_embed(acc, s, w, tl.sp, lane);
    } else {
      dense_hidden(acc, h, w, lane);
    }
  } else {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(s + L::w_off(I));
    if constexpr (I == 0) {
      dense_embed_bf16<P>(acc, s, w, tl.sp, lane);
    } else if constexpr (I == kSkip + 1) {
      dense_hidden_bf16<P>(acc, h, w + (kEmbedPad / 16) * kNT * L::kFrag,
                           lane);
      dense_embed_bf16<P>(acc, s, w, tl.sp, lane);
    } else {
      dense_hidden_bf16<P>(acc, h, w, lane);
    }
  }
  if constexpr (I == kSkip + 1) {
    __syncwarp();   // every lane is done with this tile's p
    if (tl.next < tl.tiles) stage_p(tl.sp, tl.p, tl.n, tl.next * kTile, lane);
    else cp_async_commit();
  }
  const float* bc = s + L::kOffBiasC + I * kHidden;
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
  if constexpr (P == 0) {
    dense_feat<C, Cfg<C, P>::kStageC>(
        acc, tl, reinterpret_cast<const float4*>(s + L::wc_off(C, I)));
  } else {
    dense_feat_bf16<C, Cfg<C, P>::kStageC, P>(
        acc, tl, reinterpret_cast<const uint32_t*>(s + L::wc_off(C, I)));
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) h[mt][nt][q] = acc[mt][nt][q];
}

template <int C, int OUT, int P>
__global__ void __launch_bounds__(Cfg<C, P>::kThreads, 1)
    fused_mlp_kernel(const float* __restrict__ p, const float* __restrict__ c,
                     const float* __restrict__ wpack, float* __restrict__ out,
                     long long n) {
  using K = Cfg<C, P>;
  using L = Layout<P>;
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* sc = s + L::pack_size(C) + warp * K::kStage;
  float* sp = sc + (K::kStageC ? kTile * C : 0);
  const long long tiles = (n + kTile - 1) / kTile;
  const long long stride = (long long)gridDim.x * K::kWarps;
  long long tile = (long long)blockIdx.x * K::kWarps + warp;

  // groups in flight, oldest first: p(tile), c(tile), the weights
  stage_p(sp, p, n, tile * kTile, lane);
  if (K::kStageC) stage_c<C>(sc, c, n, tile * kTile, lane);
  else cp_async_commit();
  for (int i = threadIdx.x; i < L::pack_size(C) / 4; i += blockDim.x)
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
    run_block<C, 0, P>(h, s, tl);
    run_block<C, 1, P>(h, s, tl);
    run_block<C, 2, P>(h, s, tl);
    run_block<C, 3, P>(h, s, tl);
    run_block<C, 4, P>(h, s, tl);
    __syncwarp();   // every lane is done with this tile's c
    if (K::kStageC && next < tiles) stage_c<C>(sc, c, n, next * kTile, lane);
    else cp_async_commit();

    // head: one n8 tile, columns >= OUT zero
    float o[2][4];
    {
      const float2 v =
          *reinterpret_cast<const float2*>(s + L::kOffBiasO + 2 * t);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        o[mt][0] = v.x;
        o[mt][1] = v.y;
        o[mt][2] = v.x;
        o[mt][3] = v.y;
      }
    }
    if constexpr (P == 0) {
      const float4* wo = reinterpret_cast<const float4*>(s + L::wo_off(C));
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
    } else {
      const uint32_t* wo =
          reinterpret_cast<const uint32_t*>(s + L::wo_off(C));
#pragma unroll
      for (int kt = 0; kt < kHidden / 16; ++kt) {
        uint32_t wv[4];
        load_frag<P>(wv, wo, kt, lane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float a[8];
          acc_fragment(a, h, mt, kt);
          uint32_t hi[4], lo[4];
          split_bf16<P>(a, hi, lo);
          mma_passes<P>(o[mt], hi, lo, wv);
        }
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

template <int C, int OUT, int P>
int launch(const float* p, const float* c, const float* w, float* out,
           long long n, cudaStream_t stream) {
  using K = Cfg<C, P>;
  auto kernel = fused_mlp_kernel<C, OUT, P>;
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

template <int C, int OUT>
int launch_mode(const float* p, const float* c, const float* w, float* out,
                long long n, int passes, cudaStream_t stream) {
  if (passes == 0) return launch<C, OUT, 0>(p, c, w, out, n, stream);
  if (passes == 1) return launch<C, OUT, 1>(p, c, w, out, n, stream);
  if (passes == 3) return launch<C, OUT, 3>(p, c, w, out, n, stream);
  return (int)cudaErrorInvalidValue;
}

bool supported(int c_dim, int out_dim, int passes) {
  return (c_dim == 32 || c_dim == 64) && (out_dim == 1 || out_dim == 4) &&
         (passes == 0 || passes == 1 || passes == 3);
}

template <int P>
int pack_size_of(int c_dim) {
  return c_dim == 64 ? Layout<P>::pack_size(64) : Layout<P>::pack_size(32);
}

template <int P>
int smem_of(int c_dim) {
  return c_dim == 64 ? Cfg<64, P>::kSmem : Cfg<32, P>::kSmem;
}

}  // namespace

extern "C" {

// Packed weight buffer length in floats (32-bit words) for a (c_dim,
// out_dim) pair in mode `passes` (0: 3xTF32; 1, 3: bf16 passes), or -1.
int nst_fused_mlp_pack_size(int c_dim, int out_dim, int passes) {
  if (!supported(c_dim, out_dim, passes)) return -1;
  return passes == 0 ? pack_size_of<0>(c_dim)
                     : (passes == 1 ? pack_size_of<1>(c_dim)
                                    : pack_size_of<3>(c_dim));
}

// Dynamic shared memory of one block in bytes, or -1.
int nst_fused_mlp_smem_bytes(int c_dim, int out_dim, int passes) {
  if (!supported(c_dim, out_dim, passes)) return -1;
  return passes == 0 ? smem_of<0>(c_dim)
                     : (passes == 1 ? smem_of<1>(c_dim) : smem_of<3>(c_dim));
}

// Warps per block, or -1.
int nst_fused_mlp_warps(int c_dim, int out_dim, int passes) {
  if (!supported(c_dim, out_dim, passes)) return -1;
  return Cfg<32, 0>::kWarps;
}

// p [n, 3], c [n, c_dim], w the packed weights of mode `passes`, out [n,
// out_dim]; all f32, contiguous, 16-byte aligned.  Returns a cudaError_t
// (0 = launched).
int nst_fused_mlp(const float* p, const float* c, const float* w, float* out,
                  long long n, int c_dim, int out_dim, int passes,
                  void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c_dim == 32 && out_dim == 1)
    return launch_mode<32, 1>(p, c, w, out, n, passes, s);
  if (c_dim == 32 && out_dim == 4)
    return launch_mode<32, 4>(p, c, w, out, n, passes, s);
  if (c_dim == 64 && out_dim == 1)
    return launch_mode<64, 1>(p, c, w, out, n, passes, s);
  if (c_dim == 64 && out_dim == 4)
    return launch_mode<64, 4>(p, c, w, out, n, passes, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
