// The lattice-hash encoding of the big hash levels: forward (K6), table
// gradient (K7), and the bitonic key/payload sort (K5) that orders their
// walk over the points.
//
// Replaces the TPU kernels:
//   K5  _sort_kernel_v2 (flnerf_tpu/ops/sort_pallas.py:118, via _sort_call_v2
//       at :192) and _sort_kernel (:61, via _sort_call at :215): the same
//       function under two TPU schedules, so one kernel serves both;
//   K6  _fetch_kernel (flnerf_tpu/ops/hash_lattice.py:415, called at :668);
//   K7  _scatter_kernel (hash_lattice.py:502, called at :769 and :796).
// K6/K7 compute WHAT lattice_encode_xla computes (hash_lattice.py:827-875):
// per big level l, the 8 trilinear corners of pos = x01*scale + 0.5; a
// hashed level indexes corner c at (key + offs[l][c]) mod size with the
// linear key x*P1 + y*P2 + z*P3 (uint32 wrap-around; size is a power of two,
// so mod size is a mask); a dense level at x + S*(y + S*z) + offs[l][c] with
// no modulo.  K7 is the gradient of that sum with respect to the table.
// None of the TPU machinery is carried over: the slabs, the one-hot MXU
// matmuls, the bf16 table and the 16/14-bit fixed-point fractions exist
// there because TPU gathers are slow.  Here a gather is a load, so no corner
// is ever dropped (the TPU engine spills corners outside its slab), and the
// table and fractions are f32.  The plain versions are
// flnerf_tpu_torch/ops/hash_lattice.py lattice_encode_plain and
// flnerf_tpu_torch/ops/sort_kernel.py bitonic_sort_plain.
//
// Layout: the big table is [L, T, 2] f32 (T = t_r64 * 64), the natural view
// of the reference's packed [L, t_r64, 128]; entry e of level l is one
// 8-byte float2.  x01 is [N, 3] f32 in [0, 1]; the output and the upstream
// gradient are [N, L*2] f32.  order is [L, ostride] int32: its row l holds,
// in its first N slots, the points sorted by their level-l base key (K5's
// output on the call's keys), or any other permutation of 0..N-1.
//
// K6/K7 design: one thread per (level, slot), slot fastest, so a warp walks
// 32 consecutive points of one level in key order.  Each thread reads its
// point's x01 (12 bytes, a scattered read of a 4.7 MB array that stays in
// L2), computes the cell, the base key, the 8 corner indices and weights
// in registers (__fmul_rn/__fadd_rn, so no FMA contraction moves a point
// into another cell than the plain version's separate multiply and add),
// then
//   K6 gathers the 8 corners as one float2 load each, sums them in corner
//      order, and stores the float2 at [p, l];
//   K7 reads the upstream gradient at [p, l], returns if it is zero (adds
//      exactly nothing), and adds w*g into the zero-filled gradient with one
//      float2 atomicAdd per corner.
// What bounds them on this card: the gathers.  At the 2^19 train step
// (393,216 points x 14 levels x 8 corners = 44 M accesses) the 58.7 MB big
// table no longer fits in the 50 MB L2, so a gather to a hashed level can
// cost a 32-byte sector from device memory for 8 useful bytes.  The sort is
// the answer the design gives: consecutive threads hold nearby base keys,
// so their corners fall in nearby table rows (a hashed level's corner c is
// base + a fixed offset), the sectors they fetch are shared, and equal keys
// meet in one warp for K7's atomics.  The stores at [p, l] are scattered in
// exchange.  Whether the sort pays for itself is measured (chip_smoke.py
// phase 10), not assumed.
//
// K5 design: a bitonic network on int2 (key, payload) pairs, ascending per
// row, ties never swapped (strict compares).  Strides below the tile (4096
// pairs, 32 KB of shared memory) run in shared memory: one kernel sorts
// each tile (stages up to the tile), and for each larger stage one kernel
// finishes the strides below the tile after the global passes.  Strides at
// or above the tile run as global compare-exchange passes, one thread per
// pair.  What bounds it: at [14, 2^19] the 58.7 MB of pairs exceed L2, and
// the network makes 28 global passes and 8 tile passes over them (~4.2 GB
// of traffic) where the byte bound reads and writes them once (117 MB).
// It is expected to lose to a radix sort; not done yet: multi-stride
// passes, a radix sort.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;
constexpr int kSortTile = 4096;      // pairs per shared-memory tile (32 KB)
constexpr int kSortThreads = 1024;

struct Lattice {
  float scale[kMaxLevels];
  uint32_t mult[kMaxLevels][3];    // hashed levels' multipliers
  uint32_t offs[kMaxLevels][8];    // corner offsets from the base key
  uint32_t stride[kMaxLevels];     // resolution + 1 (dense levels)
  uint32_t mask[kMaxLevels];       // size - 1 (hashed levels; size is 2^k)
  int use_hash[kMaxLevels];
  int L;
  uint32_t t;                      // entries per level in the table
};

// The 8 corners of point x at level l: table entry (within the level) and
// trilinear weight.  Corner c's offset along axis d is bit d of c.  A dense
// index past the table is clamped into it: that happens only for x01
// outside [0, 1] (a caller error), and keeps every access inside the table.
__device__ __forceinline__ void lattice_corners(const float x[3], const Lattice& lv,
                                                int l, uint32_t idx[8], float w[8]) {
  const float scale = lv.scale[l];
  float frac[3];
  uint32_t cell[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pos = __fadd_rn(__fmul_rn(x[d], scale), 0.5f);
    const float fl = floorf(pos);
    frac[d] = __fsub_rn(pos, fl);
    cell[d] = (uint32_t)(int)fl;
  }
  const bool hashed = lv.use_hash[l] != 0;
  const uint32_t s = lv.stride[l];
  const uint32_t base = hashed
      ? cell[0] * lv.mult[l][0] + cell[1] * lv.mult[l][1] + cell[2] * lv.mult[l][2]
      : cell[0] + s * (cell[1] + s * cell[2]);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int b0 = c & 1, b1 = (c >> 1) & 1, b2 = (c >> 2) & 1;
    w[c] = __fmul_rn(__fmul_rn(b0 ? frac[0] : __fsub_rn(1.f, frac[0]),
                               b1 ? frac[1] : __fsub_rn(1.f, frac[1])),
                     b2 ? frac[2] : __fsub_rn(1.f, frac[2]));
    const uint32_t a = base + lv.offs[l][c];
    idx[c] = hashed ? (a & lv.mask[l]) : min(a, lv.t - 1u);
  }
}

__global__ void __launch_bounds__(kThreads)
lattice_fwd_kernel(const float* __restrict__ x01, const float2* __restrict__ table,
                   const int* __restrict__ order, int64_t n, int64_t ostride, Lattice lv,
                   float2* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n * lv.L) return;
  const int l = (int)(i / n);
  const int64_t p = order[(int64_t)l * ostride + (i - (int64_t)l * n)];
  if (p < 0 || p >= n) return;
  const float x[3] = {x01[p * 3], x01[p * 3 + 1], x01[p * 3 + 2]};
  uint32_t idx[8];
  float w[8];
  lattice_corners(x, lv, l, idx, w);
  const float2* tab = table + (int64_t)l * lv.t;
  float2 acc = make_float2(0.f, 0.f);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float2 f = __ldg(tab + idx[c]);
    acc.x = __fadd_rn(acc.x, __fmul_rn(w[c], f.x));
    acc.y = __fadd_rn(acc.y, __fmul_rn(w[c], f.y));
  }
  out[p * lv.L + l] = acc;   // [N, L, 2] == [N, L*2]
}

__global__ void __launch_bounds__(kThreads)
lattice_bwd_kernel(const float* __restrict__ x01, const float2* __restrict__ grad_out,
                   const int* __restrict__ order, int64_t n, int64_t ostride, Lattice lv,
                   float2* __restrict__ grad_table) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n * lv.L) return;
  const int l = (int)(i / n);
  const int64_t p = order[(int64_t)l * ostride + (i - (int64_t)l * n)];
  if (p < 0 || p >= n) return;
  const float2 g = grad_out[p * lv.L + l];
  if (g.x == 0.f && g.y == 0.f) return;   // adds exactly nothing
  const float x[3] = {x01[p * 3], x01[p * 3 + 1], x01[p * 3 + 2]};
  uint32_t idx[8];
  float w[8];
  lattice_corners(x, lv, l, idx, w);
  float2* gt = grad_table + (int64_t)l * lv.t;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float2 v = make_float2(__fmul_rn(w[c], g.x), __fmul_rn(w[c], g.y));
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
    atomicAdd(gt + idx[c], v);   // per-component atomic (sm_90, global)
#else
    atomicAdd(&gt[idx[c]].x, v.x);
    atomicAdd(&gt[idx[c]].y, v.y);
#endif
  }
}

// ---- K5: bitonic sort of (key, payload) pairs, ascending per row ----

// One compare-exchange: ascending keeps the smaller key at i; ties stay.
__device__ __forceinline__ void exchange(int2& a, int2& b, bool asc) {
  if (asc ? (a.x > b.x) : (a.x < b.x)) {
    const int2 t = a;
    a = b;
    b = t;
  }
}

// The pair of row-local index i (bit j clear) at stride j: (i, i | j), for
// the q-th pair of a run of pairs.
__device__ __forceinline__ int pair_low(int q, int j) {
  return ((q & ~(j - 1)) << 1) | (q & (j - 1));
}

// One substage (stage k, stride j) over a tile in shared memory whose first
// pair sits at row-local index base.
__device__ __forceinline__ void tile_substage(int2* sh, int t, int base, int k, int j) {
  for (int q = threadIdx.x; q < (t >> 1); q += blockDim.x) {
    const int i = pair_low(q, j);
    int2 a = sh[i], b = sh[i | j];
    exchange(a, b, ((base + i) & k) == 0);
    sh[i] = a;
    sh[i | j] = b;
  }
  __syncthreads();
}

// Every stage up to the tile size t, on each tile of t pairs.
__global__ void bitonic_tile_sort_kernel(int2* data, int n, int t) {
  extern __shared__ int2 sh[];
  int2* src = data + (int64_t)blockIdx.x * t;
  const int base = (int)(((int64_t)blockIdx.x * t) % n);
  for (int e = threadIdx.x; e < t; e += blockDim.x) sh[e] = src[e];
  __syncthreads();
  for (int k = 2; k <= t; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) tile_substage(sh, t, base, k, j);
  for (int e = threadIdx.x; e < t; e += blockDim.x) src[e] = sh[e];
}

// The strides below the tile size t of stage k (> t), on each tile.
__global__ void bitonic_tile_merge_kernel(int2* data, int n, int t, int k) {
  extern __shared__ int2 sh[];
  int2* src = data + (int64_t)blockIdx.x * t;
  const int base = (int)(((int64_t)blockIdx.x * t) % n);
  for (int e = threadIdx.x; e < t; e += blockDim.x) sh[e] = src[e];
  __syncthreads();
  for (int j = t >> 1; j > 0; j >>= 1) tile_substage(sh, t, base, k, j);
  for (int e = threadIdx.x; e < t; e += blockDim.x) src[e] = sh[e];
}

// One substage (stage k, stride j >= the tile size) in device memory, one
// thread per pair.
__global__ void bitonic_global_kernel(int2* data, int n, int k, int j, int64_t pairs) {
  const int64_t q = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (q >= pairs) return;
  const int half = n >> 1;
  const int64_t row = q / half;
  const int i = pair_low((int)(q - row * half), j);
  int2* d = data + row * n;
  int2 a = d[i], b = d[i | j];
  exchange(a, b, (i & k) == 0);
  d[i] = a;
  d[i | j] = b;
}

int make_lattice(int L, long long t, const float* scales, const uint32_t* mult,
                 const uint32_t* offs, const uint32_t* strides, const uint32_t* masks,
                 const int* use_hash, Lattice& lv) {
  if (L < 1 || L > kMaxLevels || t < 1 || t > (1LL << 31)) return (int)cudaErrorInvalidValue;
  lv.L = L;
  lv.t = (uint32_t)t;
  for (int l = 0; l < L; ++l) {
    lv.scale[l] = scales[l];
    for (int d = 0; d < 3; ++d) lv.mult[l][d] = mult[l * 3 + d];
    for (int c = 0; c < 8; ++c) lv.offs[l][c] = offs[l * 8 + c];
    lv.stride[l] = strides[l];
    lv.mask[l] = masks[l];
    lv.use_hash[l] = use_hash[l];
  }
  return 0;
}

}  // namespace

extern "C" {

// K6.  x01 [n, 3], table [L, t, 2], order [L, ostride] (first n slots of
// each row a permutation of 0..n-1) and out [n, L*2] are device memory;
// scales [L], mult [L*3], offs [L*8], strides [L], masks [L] and use_hash
// [L] are host arrays.  Returns the cudaError_t of the launch.
int lattice_encode_forward(const float* x01, const float* table, const int* order, long long n,
                           long long ostride, int L, long long t, const float* scales,
                           const uint32_t* mult, const uint32_t* offs, const uint32_t* strides,
                           const uint32_t* masks, const int* use_hash, float* out,
                           void* stream) {
  Lattice lv;
  const int err = make_lattice(L, t, scales, mult, offs, strides, masks, use_hash, lv);
  if (err != 0) return err;
  const int64_t threads = (int64_t)n * L;
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads));
  lattice_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x01, reinterpret_cast<const float2*>(table), order, (int64_t)n, (int64_t)ostride, lv,
      reinterpret_cast<float2*>(out));
  return (int)cudaGetLastError();
}

// K7.  grad_out [n, L*2] is the upstream gradient; grad_table [L, t, 2]
// must be zero-filled (or hold a gradient to add to) and is accumulated
// atomically.
int lattice_encode_backward(const float* x01, const float* grad_out, const int* order,
                            long long n, long long ostride, int L, long long t,
                            const float* scales, const uint32_t* mult, const uint32_t* offs,
                            const uint32_t* strides, const uint32_t* masks, const int* use_hash,
                            float* grad_table, void* stream) {
  Lattice lv;
  const int err = make_lattice(L, t, scales, mult, offs, strides, masks, use_hash, lv);
  if (err != 0) return err;
  const int64_t threads = (int64_t)n * L;
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads));
  lattice_bwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x01, reinterpret_cast<const float2*>(grad_out), order, (int64_t)n, (int64_t)ostride, lv,
      reinterpret_cast<float2*>(grad_table));
  return (int)cudaGetLastError();
}

// K5.  pairs [g, n, 2] int32 (key, payload), device memory, sorted in place
// by key, ascending along each row; n a power of two >= 2.
int bitonic_sort_pairs(int* pairs, int g, int n, void* stream) {
  if (g < 1 || n < 2 || (n & (n - 1)) != 0) return (int)cudaErrorInvalidValue;
  int2* data = reinterpret_cast<int2*>(pairs);
  cudaStream_t st = (cudaStream_t)stream;
  const int t = n < kSortTile ? n : kSortTile;
  const int threads = (t >> 1) < kSortThreads ? (t >> 1) : kSortThreads;
  const unsigned tiles = (unsigned)((int64_t)g * (n / t));
  const size_t shm = (size_t)t * sizeof(int2);
  const int64_t pairs_n = (int64_t)g * (n >> 1);
  const unsigned pair_blocks = (unsigned)((pairs_n + kThreads - 1) / kThreads);
  bitonic_tile_sort_kernel<<<tiles, threads, shm, st>>>(data, n, t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int k = t << 1; k <= n && k > 0; k <<= 1) {
    for (int j = k >> 1; j >= t; j >>= 1) {
      bitonic_global_kernel<<<pair_blocks, kThreads, 0, st>>>(data, n, k, j, pairs_n);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    bitonic_tile_merge_kernel<<<tiles, threads, shm, st>>>(data, n, t, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
