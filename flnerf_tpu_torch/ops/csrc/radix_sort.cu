// K5: a segmented LSD radix sort of (key, payload) int2 pairs, each row
// ascending by key, stable.
//
// Replaces the TPU kernels
//   K5  _sort_kernel_v2 (flnerf_tpu/ops/sort_pallas.py:118, via _sort_call_v2
//       at :192) and
//   K5' _sort_kernel (:61, via _sort_call at :215),
// one bitonic network under two TPU schedules; both sort each row of a
// [G, N] int32 key array ascending and permute int32 payloads with their
// keys, so one kernel serves both.  The plain version is
// flnerf_tpu_torch/ops/sort_kernel.py bitonic_sort_plain (a stable torch
// sort and a gather), which this sort equals exactly.
//
// Contract: pairs [g, n] int2 (key, payload), n a power of two >= 128, keys
// non-negative.  The caller states a key width b (sort_kernel.py
// key_bits_for): every key is < 2^b - 1 or equals the pad 2^31 - 1, whose
// low bits are all ones.  Sorting on the low D >= b bits then orders the
// real keys exactly and puts the pads after them.  The D bits are cut into
// an even number of digits of at most 10 bits, least significant first
// (b = 20: 2 x 10; b = 31: 4 x 8), so the passes ping-pong between `pairs`
// and `scratch` and the result lands back in `pairs`.
//
// One pass is reduce-then-scan over tiles of T = min(n, 8192) pairs:
//   radix_hist_kernel     one CTA per (tile, row): the tile's digit counts by
//                         shared integer atomics, one per run of equal
//                         digits in a thread's pairs (so a tile of one digit
//                         does not serialise) -> counts[row][tile][digit];
//   radix_scan_kernel     one thread per (row, digit): the exclusive prefix
//                         over tiles, in place, and the digit's row total
//                         -> totals[row][digit];
//   radix_scatter_kernel  one CTA per (tile, row): loads the tile into
//                         registers (32 pairs a thread; warp w holds
//                         consecutive chunks of 32 pairs), ranks each pair
//                         among the equal digits before it in its warp (one
//                         ballot per digit bit finds a lane's peers, as
//                         match.any.sync would at a lower throughput;
//                         per-warp counters in shared memory), turns the
//                         warps' counts into tile-local starts and the row
//                         totals into digit bases (one block scan of
//                         both), places the tile in shared memory in digit
//                         order, then writes it out in that order:
//                         consecutive threads write consecutive addresses
//                         within each digit's run.
// Stability: within a warp pairs are ranked chunk by chunk and lane by
// lane, warps hold consecutive chunks and are offset in warp order, tiles in
// tile order, so equal digits keep their input order in every pass.
//
// What bounds it on this card: bytes.  A pass reads the pairs twice (counts,
// scatter) and writes them once, 3 x 8 B a pair, plus the counts (4 B per
// digit per tile: 0.5 B a pair at 10-bit digits and full tiles) written,
// read and written by the scan, read by the scatter.  At the sorted engine's
// [336, 2^17] pairs (352 MB) the two 10-bit passes move ~2.3 GB, ~0.7 ms at
// 3.35 TB/s, where the bitonic network this replaces made 21 read+write
// sweeps; the one-read-one-write bound is 0.21 ms.  The design's answers:
// a pass count fixed by the stated key width, not by log^2 n; full tiles of
// 8192 pairs, so the counts stay small beside the pairs; writes in digit
// runs, so they coalesce.  Measured (PERF.md), the passes reach about half
// the card's rate: the scatter's ranking and shared-memory round trips, not
// its writes, set its time.  Not done: one pass per digit (the counts folded
// into the scatter with decoupled look-back), which would save one of the
// three sweeps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;               // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 32;                  // pairs a thread holds in the scatter
constexpr int kTile = kThreads * kItems;    // 8192 pairs a tile
constexpr int kMaxDigitBits = 10;
constexpr int kMaxDigits = 1 << kMaxDigitBits;
constexpr int kDigitsPerThread = kMaxDigits / kThreads;

__device__ __forceinline__ int digit_of(int key, int shift, int mask) {
  return (int)(((unsigned)key >> shift) & (unsigned)mask);
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// The lanes of the (whole) warp whose digit equals this lane's: one ballot
// per digit bit (match.any.sync has a far lower throughput).
__device__ __forceinline__ unsigned match_digit(int d, int dbits) {
  unsigned peers = 0xffffffffu;
#pragma unroll
  for (int b = 0; b < kMaxDigitBits; ++b) {
    if (b < dbits) {
      const bool set = (d >> b) & 1;
      const unsigned ones = __ballot_sync(0xffffffffu, set);
      peers &= set ? ones : ~ones;
    }
  }
  return peers;
}

__global__ void __launch_bounds__(kThreads)
radix_hist_kernel(const int2* __restrict__ src, int* __restrict__ counts, int n, int tile,
                  int shift, int dbits) {
  __shared__ int h[kMaxDigits];
  const int R = 1 << dbits, mask = R - 1;
  const int row = blockIdx.y, t = blockIdx.x;
  for (int d = threadIdx.x; d < R; d += kThreads) h[d] = 0;
  // two pairs a 16-byte load, all of the thread's loads in flight at once
  const int4* s = reinterpret_cast<const int4*>(src + (int64_t)row * n + (int64_t)t * tile);
  const int quads = tile >> 1;
  int4 q[kItems / 2];
#pragma unroll
  for (int k = 0; k < kItems / 2; ++k) {
    const int i = k * kThreads + threadIdx.x;
    if (i < quads) q[k] = s[i];
  }
  __syncthreads();
  // a thread counts runs of one digit in its own pairs and adds each run
  // once: a tile of one digit costs one add a thread, not one a pair
  int run_d = -1, run_n = 0;
#pragma unroll
  for (int k = 0; k < kItems / 2; ++k) {
    if (k * kThreads + threadIdx.x < quads) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = digit_of(half ? q[k].z : q[k].x, shift, mask);
        if (d != run_d) {
          if (run_n) atomicAdd(&h[run_d], run_n);
          run_d = d;
          run_n = 0;
        }
        ++run_n;
      }
    }
  }
  if (run_n) atomicAdd(&h[run_d], run_n);
  __syncthreads();
  int* out = counts + ((int64_t)row * gridDim.x + t) * R;
  for (int d = threadIdx.x; d < R; d += kThreads) out[d] = h[d];
}

__global__ void __launch_bounds__(kThreads)
radix_scan_kernel(int* __restrict__ counts, int* __restrict__ totals, int tiles, int dbits) {
  const int R = 1 << dbits;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= R) return;
  const int row = blockIdx.y;
  int* c = counts + (int64_t)row * tiles * R + d;
  int run = 0, t = 0;
  for (; t + 8 <= tiles; t += 8) {   // 8 loads in flight before the stores
    int v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = c[(int64_t)(t + u) * R];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      c[(int64_t)(t + u) * R] = run;
      run += v[u];
    }
  }
  for (; t < tiles; ++t) {
    const int v = c[(int64_t)t * R];
    c[(int64_t)t * R] = run;
    run += v;
  }
  totals[(int64_t)row * R + d] = run;
}

// Exclusive scan of v over the block's threads in thread order.
__device__ __forceinline__ unsigned long long block_exclusive_scan(unsigned long long v,
                                                                   unsigned long long* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned long long y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  unsigned long long base = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w)
    if (w < warp) base += sums[w];
  return base + x - v;
}

__global__ void __launch_bounds__(kThreads, 2)
radix_scatter_kernel(const int2* __restrict__ src, int2* __restrict__ dst,
                     const int* __restrict__ counts, const int* __restrict__ totals, int n,
                     int tile, int shift, int dbits) {
  extern __shared__ int4 smem[];
  __shared__ unsigned long long warp_sums[kWarps];
  const int R = 1 << dbits, mask = R - 1;
  int2* buf = reinterpret_cast<int2*>(smem);          // [tile] pairs in digit order
  int* wcnt = reinterpret_cast<int*>(buf + tile);     // [kWarps][R] per-warp counts, then starts
  int* dofs = wcnt + kWarps * R;                      // [R] row position - tile-local slot
  const int row = blockIdx.y, t = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kWarps * R; i += kThreads) wcnt[i] = 0;

  // this thread's digits [d0, d0 + dpt): their tile prefixes and row totals,
  // read now so the loads overlap the ranking
  const int dpt = (R + kThreads - 1) / kThreads;
  const int d0 = threadIdx.x * dpt;
  const int* tc = counts + ((int64_t)row * gridDim.x + t) * R;   // tiles before this one
  const int* rt = totals + (int64_t)row * R;
  int tpre[kDigitsPerThread], rtot[kDigitsPerThread];
#pragma unroll
  for (int j = 0; j < kDigitsPerThread; ++j) {
    const bool mine = j < dpt && d0 + j < R;
    tpre[j] = mine ? tc[d0 + j] : 0;
    rtot[j] = mine ? rt[d0 + j] : 0;
  }
  const int chunks = tile >> 5;
  const int cpw = (chunks + kWarps - 1) / kWarps;   // chunks a warp holds, <= kItems
  const int2* s = src + (int64_t)row * n + (int64_t)t * tile;
  int2 item[kItems];
  unsigned rank[kItems / 2];   // two 16-bit ranks a register (a rank is < 32 * kItems)
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int ch = warp * cpw + k;
    if (k < cpw && ch < chunks) item[k] = s[ch * 32 + lane];
  }
  __syncthreads();

  // rank among the equal digits before it in the warp (warp-uniform branches)
  int* my = wcnt + warp * R;
  const unsigned lt = lanemask_lt();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int ch = warp * cpw + k;
    if (k < cpw && ch < chunks) {
      const int d = digit_of(item[k].x, shift, mask);
      const unsigned peers = match_digit(d, dbits);
      const int base = my[d];
      __syncwarp();
      if (lane == __ffs(peers) - 1) my[d] = base + __popc(peers);
      __syncwarp();
      const unsigned rk = (unsigned)(base + __popc(peers & lt));
      rank[k >> 1] = (k & 1) ? (rank[k >> 1] | (rk << 16)) : rk;
    }
  }
  __syncthreads();

  // digits [d0, d0 + dpt) of this thread: warp counts -> warp-exclusive
  // prefixes; the tile's and the row's per-digit totals, packed as
  // (row total << 32 | tile total) for one scan (tile totals < 2^14, row
  // totals < 2^31: no carry between the halves)
  int tot[kDigitsPerThread];
  unsigned long long packed = 0;
#pragma unroll
  for (int j = 0; j < kDigitsPerThread; ++j) {
    const int d = d0 + j;
    tot[j] = 0;
    if (j < dpt && d < R) {
      int run = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int c = wcnt[w * R + d];
        wcnt[w * R + d] = run;
        run += c;
      }
      tot[j] = run;
      packed += (unsigned long long)(unsigned)run | ((unsigned long long)(unsigned)rtot[j] << 32);
    }
  }
  const unsigned long long start = block_exclusive_scan(packed, warp_sums);
  int tstart = (int)(start & 0xffffffffu), rstart = (int)(start >> 32);
#pragma unroll
  for (int j = 0; j < kDigitsPerThread; ++j) {
    const int d = d0 + j;
    if (j < dpt && d < R) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) wcnt[w * R + d] += tstart;
      // tile-local slot q of digit d goes to row position dofs[d] + q
      dofs[d] = rstart + tpre[j] - tstart;
      tstart += tot[j];
      rstart += rtot[j];
    }
  }
  __syncthreads();

#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int ch = warp * cpw + k;
    if (k < cpw && ch < chunks)
      buf[my[digit_of(item[k].x, shift, mask)] + ((rank[k >> 1] >> ((k & 1) * 16)) & 0xffffu)] =
          item[k];
  }
  __syncthreads();
  int2* o = dst + (int64_t)row * n;
  for (int q = threadIdx.x; q < tile; q += kThreads) {
    const int2 v = buf[q];
    o[dofs[digit_of(v.x, shift, mask)] + q] = v;
  }
}

int tile_of(int n) { return n < kTile ? n : kTile; }

size_t scatter_smem(int tile, int dbits) {
  return (size_t)tile * sizeof(int2) + (size_t)(kWarps + 1) * (1u << dbits) * sizeof(int);
}

}  // namespace

extern "C" {

// The sort's geometry for rows of n pairs and digits of dbits bits:
// out[0] = pairs a tile, out[1] = tiles a row, out[2] = the scatter
// kernel's dynamic shared memory in bytes, out[3] = int32 scratch a row
// (counts and totals).  Returns 0, or cudaErrorInvalidValue.
int radix_sort_config(int n, int dbits, long long* out) {
  if (n < 128 || (n & (n - 1)) != 0 || dbits < 1 || dbits > kMaxDigitBits)
    return (int)cudaErrorInvalidValue;
  const int tile = tile_of(n), tiles = n / tile;
  out[0] = tile;
  out[1] = tiles;
  out[2] = (long long)scatter_smem(tile, dbits);
  out[3] = (long long)(tiles + 1) << dbits;
  return 0;
}

// K5.  pairs [g, n, 2] int32 (key, payload) and scratch (the same size) are
// device memory, as is ints (g * radix_sort_config's out[3] int32).  Sorts
// each row of pairs in place, ascending and stable by the low
// passes * dbits bits of the key (passes even, passes * dbits <= 32).  The
// rows are the grid's y axis, so g <= 65,535 a call: ops/sort_kernel.py
// sorts a taller array in blocks of rows, one call each.
// Returns the first failing cudaError_t of the launches (0 on success).
int radix_sort_pairs(int* pairs, int* scratch, int* ints, int g, int n, int dbits, int passes,
                     void* stream) {
  long long cfg[4];
  if (g < 1 || g > 65535 || passes < 1 || passes * dbits > 32 ||
      radix_sort_config(n, dbits, cfg) != 0)
    return (int)cudaErrorInvalidValue;
  const int tile = (int)cfg[0], tiles = (int)cfg[1], R = 1 << dbits;
  const size_t smem = (size_t)cfg[2];
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(radix_scatter_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int* counts = ints;
  int* totals = ints + (int64_t)g * tiles * R;
  int2* a = reinterpret_cast<int2*>(pairs);
  int2* b = reinterpret_cast<int2*>(scratch);
  const dim3 grid(tiles, g), scan_grid((R + kThreads - 1) / kThreads, g);
  for (int p = 0; p < passes; ++p) {
    const int shift = p * dbits;
    radix_hist_kernel<<<grid, kThreads, 0, st>>>(a, counts, n, tile, shift, dbits);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    radix_scan_kernel<<<scan_grid, kThreads, 0, st>>>(counts, totals, tiles, dbits);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    radix_scatter_kernel<<<grid, kThreads, smem, st>>>(a, b, counts, totals, n, tile, shift, dbits);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    int2* c = a;
    a = b;
    b = c;
  }
  if (a != reinterpret_cast<int2*>(pairs)) {   // an odd pass count ends in scratch
    err = cudaMemcpyAsync(pairs, a, (size_t)g * n * sizeof(int2), cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
