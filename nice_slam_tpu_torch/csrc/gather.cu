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
// What bounds them on an H100.  At room0's mapping shapes (48,000 rows of
// W = 256 or 512 floats) both move tens to hundreds of MB: the gather reads
// each touched row and writes [n, W] (0.020 / 0.048 ms at 3.35 TB/s), the
// scatter reads [n, W] and writes every row of [M, W] once (0.022 / 0.141
// ms, the finecolor output alone 373 MB).  At a tracking iteration's 9,600
// rows the gather's device work is ~10 us and the host's launch path is
// most of a call.  A real mapping index puts its 48,000 points on ~1,150
// rows of the middle volume (segments up to ~1,800 positions): there the
// scatter's time is that of its longest segments' ordered sums.
//
// gather_rows: a group of G lanes per output row (G = 32, or the power of
// two >= W/4 when W/4 < 32, at least 8).  Each group takes R rows at a
// time; one lane per row reads its index (int32 or int64), checks it with a
// device-side assertion and broadcasts the row's offset with __shfl_sync;
// then every lane issues the 16-byte loads of all R rows' chunks it owns
// (R x CH = 16 per lane: R = 8 up to W = 256, 4 above) before any store.
// Offsets are 32-bit where M*W and N*W are below 2^31 (every main-path
// shape), 64-bit otherwise.  The grid is the resident blocks of the card
// (occupancy x SMs); warps stride over the rows.  One launch per call.
//
// scatter_add_rows: sort-free and deterministic.  The sum of each target
// row is formed from 0 over its gradient rows in ascending position order:
// the bits that PyTorch's sort-based index_put_ with accumulate (autograd's
// backward of table[idx] on the card) and index_add_ on the CPU give, so the
// port's trajectories do not depend on this kernel.  (A float4 atomicAdd
// scatter sums in an order that changes from run to run; it moved the
// from-scratch synthetic trajectory past its bound on the card.)  Steps,
// one stream, no host synchronization:
//   0. memset of the [M] int32 counts, the long-row list's length and the
//      long units' cursor;
//   1. count_kernel: counts[idx[i]] += 1 with int atomics (an index outside
//      [0, M) fails the device-side assertion before its atomic);
//   2. tile_sum_kernel + scan_kernel: the exclusive scan of the counts into
//      CSR offsets [M + 1], reduce-then-scan over tiles of kTile counts
//      (each block sums the tile totals before it: no look-back, no
//      inter-block waiting);
//   3. place_kernel: each position into its row's segment, the slot taken
//      by an int atomic on the count (the order within a segment is
//      arbitrary here);
//   4. the segments are ordered out of place, into a second positions
//      array, each by one writer: order_short_kernel, a thread per row,
//      sorts a segment of at most kLaneSort positions in registers and
//      lists a longer row; order_long_kernel, a block per listed row, sets
//      one bit per position in a shared-memory bitmap over the range the
//      segment spans (in windows of kBits positions) and writes the set
//      bits out in order (a block scan gives each thread's run its rank);
//   5. the sums read the ordered positions and write every row of the
//      output once (zeros for a row no position hits: no separate zeroing
//      pass).  sum_long_kernel: a warp per listed row and slice of 32 float
//      columns, taken from an atomic cursor, a lane per column with kLong
//      gradient values loaded ahead of the adds (a long segment's ordered
//      sum is a chain of adds, so its speed is the loads in flight, and the
//      columns spread it over W / 32 warps; the cursor keeps two long
//      segments from queueing on one warp).  segment_sum_kernel: a group of
//      G lanes per kSegRows consecutive rows and slice of G 16-byte chunks;
//      the short segments are staged in shared memory and summed in one
//      walk across the row boundaries with kDepth rows' loads in flight
//      (the order of the adds fixes the bits, not that of the loads).
// A call makes 1 memset + 8 kernels (n = 0: 1 memset + 3), where the sorted
// design before it made torch.sort's launches (a radix sort over the 64-bit
// key), a fill of the [M, W] output and one kernel.  The scratch (cursor,
// counts, list, offsets, tile totals, positions; nst_scatter_scratch_ints
// ints) is the caller's.
//
// An index outside [0, M) fails a device-side assertion, as PyTorch's own
// index kernels do for table[idx] on the card: the launch is aborted and the
// next call that synchronizes raises.

#include <cassert>
#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;        // counts per block of the scan
constexpr int kPerThread = kTile / kThreads;
constexpr int kLaneSort = 32;      // longest segment one thread orders
constexpr int kWords = 4096;       // bitmap words of a long segment's window
constexpr long long kBits = 32LL * kWords;  // positions per window
constexpr int kSegRows = 8;        // target rows a summing group takes
constexpr int kDepth = 16;         // gradient rows loaded ahead of the adds
constexpr int kLong = 64;          // same, per lane, for a listed row

template <int G>
__device__ __forceinline__ unsigned group_mask(int lane) {
  return G == 32 ? kFull : ((1u << G) - 1u) << (lane & ~(G - 1));
}

// G lanes per row; each group takes R rows at a time and each lane owns CH
// 16-byte chunks of a row per pass (R * CH = 16 loads in flight per lane).
template <int G, int CH, int R, typename Idx, typename Off>
__global__ void __launch_bounds__(kThreads)
    gather_rows_kernel(const float4* __restrict__ table,
                       const Idx* __restrict__ idx, float4* __restrict__ out,
                       long long m, long long n, int w4) {
  constexpr long long kPerWarp = (long long)(32 / G) * R;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long step = (long long)gridDim.x * kWarps * kPerWarp;
  for (long long base = warp * kPerWarp; base < n; base += step) {
    const long long first = base + (long long)(lane / G) * R;
    Off mine = -1;
    if (sub < R && first + sub < n) {
      const long long row = (long long)idx[first + sub];
      assert(row >= 0 && row < m);
      mine = (Off)row * w4;
    }
    Off src[R];
#pragma unroll
    for (int r = 0; r < R; ++r) src[r] = __shfl_sync(kFull, mine, r, G);
    for (int c0 = sub; c0 < w4; c0 += G * CH) {
      float4 v[R][CH];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int q = 0; q < CH; ++q)
          if (src[r] >= 0 && c0 + q * G < w4)
            v[r][q] = __ldg(&table[src[r] + c0 + q * G]);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int q = 0; q < CH; ++q)
          if (src[r] >= 0 && c0 + q * G < w4)
            out[(Off)(first + r) * w4 + c0 + q * G] = v[r][q];
    }
  }
}

template <typename Idx>
__global__ void __launch_bounds__(kThreads)
    count_kernel(const Idx* __restrict__ idx, int* __restrict__ counts,
                 long long m, long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long row = (long long)idx[i];
  assert(row >= 0 && row < m);
  atomicAdd(&counts[row], 1);
}

// every thread returns the block's total; red: [kWarps] shared ints
__device__ int block_sum(int v, int* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < kWarps ? red[lane] : 0;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// exclusive scan of one int per thread in thread order; total: the sum
__device__ int block_exclusive_scan(int v, int* red, int& total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += u;
  }
  __syncthreads();
  if (lane == 31) red[warp] = inc;
  __syncthreads();
  int below = 0;
  total = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    const int t = red[k];
    below += k < warp ? t : 0;
    total += t;
  }
  return below + inc - v;
}

__global__ void __launch_bounds__(kThreads)
    tile_sum_kernel(const int* __restrict__ counts, int* __restrict__ tiles,
                    long long m) {
  __shared__ int red[kWarps];
  const long long lo = (long long)blockIdx.x * kTile;
  int s = 0;
  for (int k = threadIdx.x; k < kTile; k += kThreads)
    if (lo + k < m) s += counts[lo + k];
  s = block_sum(s, red);
  if (threadIdx.x == 0) tiles[blockIdx.x] = s;
}

// offsets[i] = sum of counts[0..i), offsets[m] = n
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const int* __restrict__ counts, const int* __restrict__ tiles,
                int* __restrict__ offsets, long long m, long long n) {
  __shared__ int red[kWarps];
  int carry = 0;
  for (int k = threadIdx.x; k < (int)blockIdx.x; k += kThreads)
    carry += tiles[k];
  carry = block_sum(carry, red);
  const long long lo = (long long)blockIdx.x * kTile + threadIdx.x;
  int v[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long i = lo + (long long)j * kThreads;
    v[j] = i < m ? counts[i] : 0;
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    int total;
    const int below = block_exclusive_scan(v[j], red, total);
    const long long i = lo + (long long)j * kThreads;
    if (i < m) offsets[i] = carry + below;
    carry += total;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) offsets[m] = (int)n;
}

// counts[row] comes back to 0: each position takes slot counts[row] - 1
template <typename Idx>
__global__ void __launch_bounds__(kThreads)
    place_kernel(const Idx* __restrict__ idx, int* __restrict__ counts,
                 const int* __restrict__ offsets, int* __restrict__ pos,
                 long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long row = (long long)idx[i];
  const int slot = atomicSub(&counts[row], 1) - 1;
  pos[offsets[row] + slot] = (int)i;
}

// A thread per target row: a segment of 1 .. kLaneSort positions is written
// to `sorted` in ascending order from registers (each position's rank is
// the count of the smaller ones; positions are distinct); a longer row is
// appended to the list rows_listed (its length in *listed) for
// order_long_kernel and sum_long_kernel.
__global__ void __launch_bounds__(kThreads)
    order_short_kernel(const int* __restrict__ offsets,
                       const int* __restrict__ pos, int* __restrict__ sorted,
                       int* __restrict__ listed, int* __restrict__ rows_listed,
                       long long m) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= m) return;
  const int s = offsets[r], len = offsets[r + 1] - s;
  if (len == 0) return;
  if (len > kLaneSort) {
    rows_listed[atomicAdd(listed, 1)] = (int)r;
    return;
  }
  int v[kLaneSort];
#pragma unroll
  for (int i = 0; i < kLaneSort; ++i) v[i] = i < len ? pos[s + i] : INT_MAX;
#pragma unroll
  for (int i = 0; i < kLaneSort; ++i) {
    int k = 0;
#pragma unroll
    for (int j = 0; j < kLaneSort; ++j) k += v[j] < v[i];
    if (i < len) sorted[s + k] = v[i];
  }
}

// A block per listed row (the list's order does not matter: each row is
// ordered on its own).  The range [plo, phi] its positions span is taken
// in windows of kBits positions: a bitmap in shared memory gets one bit per
// position of the segment in the window, and each thread writes the
// positions of its run of words to `sorted` in order, at the rank a block
// scan of the runs' counts gives.
__global__ void __launch_bounds__(kThreads)
    order_long_kernel(const int* __restrict__ offsets,
                      const int* __restrict__ pos, int* __restrict__ sorted,
                      const int* __restrict__ listed,
                      const int* __restrict__ rows_listed) {
  __shared__ unsigned bits[kWords];
  __shared__ int red[kWarps];
  __shared__ int span[2];
  const int count = *listed;
  for (int k = blockIdx.x; k < count; k += gridDim.x) {
    const int row = rows_listed[k];
    const int start = offsets[row], len = offsets[row + 1] - start;
    const int* seg = pos + start;
    __syncthreads();  // the previous row is done with bits and span
    if (threadIdx.x == 0) {
      span[0] = INT_MAX;
      span[1] = -1;
    }
    __syncthreads();
    int lo = INT_MAX, hi = -1;
    for (int i = threadIdx.x; i < len; i += kThreads) {
      lo = min(lo, seg[i]);
      hi = max(hi, seg[i]);
    }
    atomicMin(&span[0], lo);
    atomicMax(&span[1], hi);
    __syncthreads();
    const long long plo = span[0], phi = span[1];
    int done = 0;
    for (long long base = plo; base <= phi; base += kBits) {
      const long long left = (phi - base) / 32 + 1;
      const int words = (int)(left < kWords ? left : kWords);
      for (int i = threadIdx.x; i < words; i += kThreads) bits[i] = 0u;
      __syncthreads();
      for (int i = threadIdx.x; i < len; i += kThreads) {
        const long long q = seg[i] - base;
        if (q >= 0 && q < kBits)
          atomicOr(&bits[q >> 5], 1u << (q & 31));
      }
      __syncthreads();
      const int per = (words + kThreads - 1) / kThreads;
      const int w0 = threadIdx.x * per;
      const int w1 = w0 + per < words ? w0 + per : words;
      int mine = 0;
      for (int i = w0; i < w1; ++i) mine += __popc(bits[i]);
      int total;
      int at = start + done + block_exclusive_scan(mine, red, total);
      for (int i = w0; i < w1; ++i)
        for (unsigned b = bits[i]; b; b &= b - 1u)
          sorted[at++] = (int)(base + 32LL * i + __ffs(b) - 1);
      done += total;
      __syncthreads();  // every run is written before bits is cleared
    }
  }
}

// Sum entries [0, total) of P (ascending positions, staged in shared
// memory) into target rows r0 .. r0 + rows - 1, 16-byte chunk c of each
// (c >= w4: nothing): entry t goes to row r0 + rowof[t]; each row's sum
// starts from 0 and is written once, zeros where no entry reaches it,
// except the rows whose bit is set in `listed` (sum_long_kernel's).
// kDepth gradient rows are loaded ahead of the adds, across row boundaries.
template <typename Off>
__device__ void walk_sum(const float4* __restrict__ grad, const int* P,
                         const unsigned char* rowof, int total, int rows,
                         unsigned listed, float4* __restrict__ out,
                         long long r0, int w4, int c) {
  if (c >= w4) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int cur = 0;
  for (int t0 = 0; t0 < total; t0 += kDepth) {
    float4 g[kDepth];
#pragma unroll
    for (int d = 0; d < kDepth; ++d)
      if (t0 + d < total) g[d] = __ldg(&grad[(Off)P[t0 + d] * w4 + c]);
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      if (t0 + d < total) {
        const int row = (int)rowof[t0 + d];
        for (; cur < row; ++cur) {  // store row cur, zeros up to row
          if (!(listed >> cur & 1u)) out[(Off)(r0 + cur) * w4 + c] = acc;
          acc = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        acc.x += g[d].x;
        acc.y += g[d].y;
        acc.z += g[d].z;
        acc.w += g[d].w;
      }
    }
  }
  for (; cur < rows; ++cur) {
    if (!(listed >> cur & 1u)) out[(Off)(r0 + cur) * w4 + c] = acc;
    acc = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Groups of G lanes take units over the grid: kSegRows consecutive rows and
// a slice of G 16-byte chunks, whose segments (at most kLaneSort positions
// each, already ordered) are staged in shared memory with each entry's row,
// one read per lane and row, and summed by one walk_sum.  Listed rows are
// sum_long_kernel's.  Reads the ordered positions.
template <int G, typename Off>
__global__ void __launch_bounds__(kThreads, 2)
    segment_sum_kernel(const float4* __restrict__ grad,
                       const int* __restrict__ offsets,
                       const int* __restrict__ sorted, float4* __restrict__ out,
                       long long m, int w4) {
  constexpr int kGroupsPerBlock = kThreads / G;
  constexpr int kStage = kSegRows * kLaneSort;
  __shared__ int keys[kGroupsPerBlock][kStage];
  __shared__ unsigned char rowof[kGroupsPerBlock][kStage];
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);
  const unsigned mask = group_mask<G>(lane);
  const int gid = threadIdx.x / G;
  int* sp = keys[gid];
  unsigned char* tag = rowof[gid];
  const int slices = (w4 + G - 1) / G;
  const long long units = (m + kSegRows - 1) / kSegRows * slices;
  const long long step = (long long)gridDim.x * kGroupsPerBlock;
  for (long long u = (long long)blockIdx.x * kGroupsPerBlock + gid; u < units;
       u += step) {
    const long long r0 = u / slices * kSegRows;
    const int c = (int)(u % slices) * G + sub;
    const int rows = (int)(m - r0 < kSegRows ? m - r0 : kSegRows);
    int s = 0, len = 0;
    if (sub < rows) {
      s = offsets[r0 + sub];
      len = offsets[r0 + sub + 1] - s;
    }
    const bool long_row = len > kLaneSort;
    const unsigned skip =
        (__ballot_sync(mask, long_row) >> (lane & ~(G - 1))) & 0xffu;
    const int mine = long_row ? 0 : len;
    int inc = mine;  // inclusive prefix of the staged lengths over the rows
#pragma unroll
    for (int o = 1; o < kSegRows; o <<= 1) {
      const int y = __shfl_up_sync(mask, inc, o, G);
      if (sub >= o) inc += y;
    }
    const int total = __shfl_sync(mask, inc, kSegRows - 1, G);
    __syncwarp(mask);  // the previous unit's walk is done with sp and tag
    for (int k = 0, d = inc - mine; k < mine; ++k, ++d) {
      sp[d] = sorted[s + k];
      tag[d] = (unsigned char)sub;
    }
    __syncwarp(mask);
    walk_sum<Off>(grad, sp, tag, total, rows, skip, out, r0, w4, c);
  }
}

// The listed rows' sums.  A warp takes one unit at a time from the cursor:
// a listed row and a slice of 32 float columns, a lane per column (so a
// long segment never waits behind another on one warp, and its columns
// spread over W / 32 warps).  The row's ascending positions are read 32 at
// a time, one per lane, and broadcast; kLong gradient values per lane are
// loaded ahead of the adds, and the next kLong positions while they add.
template <typename Off>
__global__ void __launch_bounds__(kThreads)
    sum_long_kernel(const float* __restrict__ grad,
                    const int* __restrict__ offsets,
                    const int* __restrict__ sorted,
                    const int* __restrict__ listed,
                    const int* __restrict__ rows_listed,
                    unsigned long long* __restrict__ cursor,
                    float* __restrict__ out, int w) {
  constexpr int kPer = kLong / 32;
  const int lane = threadIdx.x & 31;
  const int lslices = (w + 31) / 32;
  const unsigned long long units = (unsigned long long)*listed * lslices;
  for (;;) {
    unsigned long long u = 0;
    if (lane == 0) u = atomicAdd(cursor, 1ull);
    u = __shfl_sync(kFull, u, 0);
    if (u >= units) return;
    const int row = rows_listed[u / lslices];
    const int col = (int)(u % lslices) * 32 + lane;
    const bool live = col < w;
    const int start = offsets[row], len = offsets[row + 1] - start;
    const int* P = sorted + start;
    float acc = 0.f;
    int p[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int t = j * 32 + lane;
      p[j] = t < len ? P[t] : 0;
    }
    for (int t0 = 0; t0 < len; t0 += kLong) {
      float g[kLong];
#pragma unroll
      for (int d = 0; d < kLong; ++d) {
        const int q = __shfl_sync(kFull, p[d / 32], d % 32);
        if (live && t0 + d < len) g[d] = __ldg(&grad[(Off)q * w + col]);
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int t = t0 + kLong + j * 32 + lane;
        p[j] = t < len ? P[t] : 0;
      }
#pragma unroll
      for (int d = 0; d < kLong; ++d)
        if (t0 + d < len) acc += g[d];
    }
    if (live) out[(Off)row * w + col] = acc;
  }
}

// resident blocks of `kernel` on the current device: occupancy x SMs
template <typename Kernel>
int resident_blocks(Kernel kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
}

unsigned int grid_for(long long work, long long per_block, int resident) {
  const long long b = (work + per_block - 1) / per_block;
  return (unsigned int)(b < resident ? b : resident);
}

bool fits32(long long m, long long n, int w) {
  const long long rows = m > n ? m : n;
  return rows * w < (1LL << 31);
}

template <int G, int CH, int R, typename Idx, typename Off>
int launch_gather(const float* table, const void* idx, float* out,
                  long long m, long long n, int w, cudaStream_t stream) {
  const auto kernel = gather_rows_kernel<G, CH, R, Idx, Off>;
  static const int resident = resident_blocks(kernel);
  kernel<<<grid_for(n, (long long)kThreads / G * R, resident), kThreads, 0,
           stream>>>(reinterpret_cast<const float4*>(table),
                     static_cast<const Idx*>(idx),
                     reinterpret_cast<float4*>(out), m, n, w / 4);
  return (int)cudaGetLastError();
}

template <typename Idx, typename Off>
int gather_typed(const float* table, const void* idx, float* out, long long m,
                 long long n, int w, cudaStream_t stream) {
  const int w4 = w / 4;
  if (w4 <= 8)
    return launch_gather<8, 1, 8, Idx, Off>(table, idx, out, m, n, w, stream);
  if (w4 <= 16)
    return launch_gather<16, 1, 8, Idx, Off>(table, idx, out, m, n, w,
                                             stream);
  if (w4 <= 32)
    return launch_gather<32, 1, 8, Idx, Off>(table, idx, out, m, n, w,
                                             stream);
  if (w4 <= 64)
    return launch_gather<32, 2, 8, Idx, Off>(table, idx, out, m, n, w,
                                             stream);
  return launch_gather<32, 4, 4, Idx, Off>(table, idx, out, m, n, w, stream);
}

long long scan_tiles(long long m) { return (m + kTile - 1) / kTile; }

// rows the list can hold at most: each has more than kLaneSort positions
long long most_listed(long long m, long long n) {
  const long long k = n / (kLaneSort + 1);
  return k < m ? k : m;
}

template <int G, typename Off>
int launch_segment_sum(const float* grad, const int* offsets, const int* sorted,
                       float* out, long long m, int w, cudaStream_t stream) {
  const auto kernel = segment_sum_kernel<G, Off>;
  static const int resident = resident_blocks(kernel);
  const long long units =
      (m + kSegRows - 1) / kSegRows * ((w / 4 + G - 1) / G);
  kernel<<<grid_for(units, kThreads / G, resident), kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(grad), offsets, sorted,
      reinterpret_cast<float4*>(out), m, w / 4);
  return (int)cudaGetLastError();
}

// scratch: the long units' cursor (8 bytes) and the list's length, one int
// of padding, the counts [m] (these 4 + m ints zeroed by one memset), the
// listed rows [m], offsets [m + 1], tile totals, positions as placed [n]
// and ordered [n]
template <typename Idx, typename Off>
int scatter_typed(const float* grad, const void* idx, float* out,
                  int* scratch, long long m, long long n, int w,
                  cudaStream_t stream) {
  auto* cursor = reinterpret_cast<unsigned long long*>(scratch);
  int* listed = scratch + 2;
  int* counts = scratch + 4;
  int* rows_listed = counts + m;
  int* offsets = rows_listed + m;
  int* tiles = offsets + m + 1;
  int* pos = tiles + scan_tiles(m);
  int* sorted = pos + n;
  const Idx* index = static_cast<const Idx*>(idx);
  int err = (int)cudaMemsetAsync(scratch, 0, (4 + m) * sizeof(int), stream);
  if (err) return err;
  const unsigned int per_position =
      (unsigned int)((n + kThreads - 1) / kThreads);
  if (n > 0) {
    count_kernel<Idx><<<per_position, kThreads, 0, stream>>>(index, counts, m,
                                                            n);
    if ((err = (int)cudaGetLastError())) return err;
  }
  const unsigned int tiles_n = (unsigned int)scan_tiles(m);
  tile_sum_kernel<<<tiles_n, kThreads, 0, stream>>>(counts, tiles, m);
  if ((err = (int)cudaGetLastError())) return err;
  scan_kernel<<<tiles_n, kThreads, 0, stream>>>(counts, tiles, offsets, m, n);
  if ((err = (int)cudaGetLastError())) return err;
  if (n > 0) {
    place_kernel<Idx><<<per_position, kThreads, 0, stream>>>(index, counts,
                                                            offsets, pos, n);
    if ((err = (int)cudaGetLastError())) return err;
    order_short_kernel<<<(unsigned int)((m + kThreads - 1) / kThreads),
                         kThreads, 0, stream>>>(offsets, pos, sorted, listed,
                                                rows_listed, m);
    if ((err = (int)cudaGetLastError())) return err;
    static const int order_resident = resident_blocks(order_long_kernel);
    order_long_kernel<<<grid_for(most_listed(m, n) + 1, 1, order_resident),
                        kThreads, 0, stream>>>(offsets, pos, sorted, listed,
                                               rows_listed);
    if ((err = (int)cudaGetLastError())) return err;
    const auto sum_long = sum_long_kernel<Off>;
    static const int sum_resident = resident_blocks(sum_long);
    sum_long<<<grid_for(most_listed(m, n) * ((w + 31) / 32) + 1, kWarps,
                        sum_resident),
               kThreads, 0, stream>>>(grad, offsets, sorted, listed,
                                      rows_listed, cursor, out, w);
    if ((err = (int)cudaGetLastError())) return err;
  }
  const int w4 = w / 4;
  if (w4 <= 8)
    return launch_segment_sum<8, Off>(grad, offsets, sorted, out, m, w,
                                      stream);
  if (w4 <= 16)
    return launch_segment_sum<16, Off>(grad, offsets, sorted, out, m, w,
                                       stream);
  return launch_segment_sum<32, Off>(grad, offsets, sorted, out, m, w,
                                     stream);
}

}  // namespace

// table: [m, w] float32, idx: [n] int64 (idx64 != 0) or int32, out: [n, w]
// float32, w % 4 == 0, all 16-byte aligned.  Returns cudaGetLastError()
// after the launch.
extern "C" int nst_gather_rows(const float* table, const void* idx, int idx64,
                               float* out, long long m, long long n, int w,
                               void* stream) {
  if (n == 0 || w == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (fits32(m, n, w))
    return idx64 ? gather_typed<long long, int>(table, idx, out, m, n, w, s)
                 : gather_typed<int, int>(table, idx, out, m, n, w, s);
  return idx64
             ? gather_typed<long long, long long>(table, idx, out, m, n, w, s)
             : gather_typed<int, long long>(table, idx, out, m, n, w, s);
}

// Ints of scratch nst_scatter_add_rows needs: the cursor, the list's
// length and a pad (4), counts [m], listed rows [m], offsets [m + 1], tile
// totals, positions placed and ordered [2n].
extern "C" long long nst_scatter_scratch_ints(long long m, long long n) {
  return 4 + m + m + (m + 1) + scan_tiles(m) + 2 * n;
}

// grad: [n, w] float32, idx: [n] int64 (idx64 != 0) or int32, out: [m, w]
// float32 (every row is written), w % 4 == 0, all 16-byte aligned; scratch:
// nst_scatter_scratch_ints(m, n) int32, 8-byte aligned; n < 2^31.  Returns the first error
// of its launches (cudaGetLastError() after each).
extern "C" int nst_scatter_add_rows(const float* grad, const void* idx,
                                    int idx64, float* out, int* scratch,
                                    long long m, long long n, int w,
                                    void* stream) {
  if (m == 0 || w == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (fits32(m, n, w))
    return idx64 ? scatter_typed<long long, int>(grad, idx, out, scratch, m, n,
                                                 w, s)
                 : scatter_typed<int, int>(grad, idx, out, scratch, m, n, w,
                                           s);
  return idx64 ? scatter_typed<long long, long long>(grad, idx, out, scratch,
                                                     m, n, w, s)
               : scatter_typed<int, long long>(grad, idx, out, scratch, m, n,
                                               w, s);
}
